"""admit_ms.colo: the median host time of an admission in the window
(eager prefill and slot insert, ms)."""

import statistics


def read(rec):
    if not rec.admissions:
        return None
    return 1e3 * statistics.median(a.t1 - a.t0 for a in rec.admissions)
