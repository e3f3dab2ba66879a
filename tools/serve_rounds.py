#!/usr/bin/env python3
"""Graphed solo decode rounds of the port's serving engine, per model.

  python3 tools/serve_rounds.py --src SRC [--rounds N] [--label L]

Imports `repro_torch` from SRC (the `src` directory of a checkout, so that
two checkouts can be timed in turns on one card), and for each model
below serves 8 requests (prompts of 64-512 tokens, seed 11) at full width
with random seeded weights and `use_kernels=True`, then times N decode
rounds replayed from the engine's CUDA graph: the round's wall time as
the engine records it (`metrics.round_s`: host bookkeeping, the replay,
and the copy of the tokens back) and the replay's device time (CUDA
events around it). Prints one JSON line per model and the card's name and
power limit. Runs on one card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (model, whether its KV cache is int8, s_max, encoder frames): the
# configurations and cache sizes of the on-card smoke's serving phases
MODELS = (("llama3-8b", False, 1024, 0),
          ("llama3-8b", True, 1024, 0),
          ("mamba2-780m", False, 1024, 0),
          ("recurrentgemma-2b", False, 3072, 0),
          ("seamless-m4t-large-v2", False, 1024, 256))


class _TimedReplay:
    """The engine's decode graph with CUDA events around each replay."""

    def __init__(self, graph):
        self.graph = graph
        self.events = []

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph(*args)
        end.record()
        self.events.append((start, end))

    def __getattr__(self, name):
        return getattr(self.graph, name)


def rounds_of(arch, int8, s_max, frames, n_rounds, warm=10):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get_config(arch), kv_quant=int8)
    params = MD.init_params(cfg, 0, device="cuda")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=s_max,
                        enc_len=frames, use_kernels=True, device="cuda")
    eng.precompile()
    eng._decode = timed = _TimedReplay(eng._decode)
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, arrival=0.0,
                    prompt_len=int(rng.integers(64, 513)),
                    max_new_tokens=warm + n_rounds + 1) for i in range(8)]
    for r in reqs:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32),
                             eng._stub_extras(r)):
            raise RuntimeError(f"{arch}: a request was not admitted")
    for _ in range(warm + n_rounds):
        eng.decode_round()
    torch.cuda.synchronize()
    wall = eng.metrics.round_s[warm:]
    device = [s.elapsed_time(e) for s, e in timed.events[warm:]]
    del eng, params
    torch.cuda.empty_cache()
    return {"model": arch + (" int8" if int8 else ""), "rounds": len(wall),
            "round_ms_median": 1e3 * statistics.median(wall),
            "round_ms_p10": 1e3 * float(np.percentile(wall, 10)),
            "round_ms_p90": 1e3 * float(np.percentile(wall, 90)),
            "device_ms_median": statistics.median(device)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_rounds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    for arch, int8, s_max, frames in MODELS:
        t0 = time.perf_counter()
        row = rounds_of(arch, int8, s_max, frames, args.rounds)
        row.update(label=args.label, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
