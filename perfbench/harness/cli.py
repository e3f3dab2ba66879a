"""The command line of one run (`perfbench/run.py`)."""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control's and the faults' numbers "
                         "(for setting limits; the benchmark's runs leave "
                         "it off)")
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float, root: Path = ROOT,
         device: Optional[str] = None) -> int:
    """Exit code of one run. `device` other than None skips the look for
    a card (the CPU tests)."""
    args = parse(argv)
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                print("no CUDA device: the benchmark runs on the card",
                      file=sys.stderr)
                return 2
            device = "cuda"
        from perfbench.harness import cell
        out = cell.run(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_start, device=device,
                       graphs=None if device == "cuda" else False,
                       control=bool(args.control))
    except Exception:                   # noqa: BLE001 - reported, exit 1
        traceback.print_exc()
        return 1
    print(json.dumps(out), flush=True)
    for k, x in out["checks"].items():
        print(f"check {k} {x['value']!r} limit {x['limit']!r}",
              file=sys.stderr, flush=True)
    return 0
