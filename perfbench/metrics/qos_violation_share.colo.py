"""qos_violation_share.colo: % of the window's rounds whose host time
exceeds the scheduler's target."""


def read(rec):
    if not rec.rounds or rec.qos_s is None:
        return None
    over = sum((r.t1 - r.t0) > rec.qos_s for r in rec.rounds)
    return 100.0 * over / len(rec.rounds)
