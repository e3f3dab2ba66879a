"""mean_k.colo: the mean number of finetune units of the window's
rounds."""


def read(rec):
    if not rec.rounds or not rec.units_per_iter:
        return None
    return sum(r.k for r in rec.rounds) / len(rec.rounds)
