#!/usr/bin/env python3
"""The knee sweep of a co-located cell: windows at rising arrival rates,
one process, the reference skipped. The knee is the highest rate at which
the requests waiting for a slot stay bounded over the window (few waiting
at its close, the admission lateness of its second half no longer than
its whole's); the cell's rate is set at about half of it.

  python3 perfbench/sweep.py --workload qwen2.5-7b.colo-chat \
      --rates 1,1.5,2,2.5,3 --seconds 20 --seed 11
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import cell  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    for rate in (float(x) for x in args.rates.split(",")):
        out = cell.run(ROOT, args.workload, args.seed, args.seconds, False,
                       time.perf_counter(), rate=rate, judge=False)
        line = {"rate_rps": rate, **out["queue"],
                **{k: v["value"] for k, v in out["metrics"].items()}}
        print("sweep " + json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
