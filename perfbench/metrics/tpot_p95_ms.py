"""tpot_p95_ms: the 95th percentile, over every decode token emitted in
the window, of its round's host time (ms)."""

import numpy as np


def read(rec):
    times = [r.t1 - r.t0 for r in rec.rounds for _ in range(r.emitted)]
    if not times:
        return None
    return 1e3 * float(np.percentile(times, 95))
