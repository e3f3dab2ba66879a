"""ft_tokens_per_s: finetune tokens trained in the window over its
seconds: the units the window ran x tokens per iteration / units per
iteration (every unit of the iteration counts, the ones without tensor
work too, as the scheduler hands them out)."""


def read(rec):
    if not rec.units_per_iter:
        return None
    return rec.units * rec.tokens_per_iter / rec.units_per_iter / \
        rec.window_s
