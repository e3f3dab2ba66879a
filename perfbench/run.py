#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the repository's root, on a machine with the card. The cells, their
configurations, traffic mixes and metrics are named in BENCHMARK.json and
found under perfbench/ (see perfbench/harness/spec.py). The last line of
standard output is the run's result, one JSON object; the last lines of
standard error are the numbers compared with the reference, each beside
its limit.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# caches inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from perfbench.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
