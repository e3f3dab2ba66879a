"""Serving driver: one decode instance on the card (the port's serve path).

Mirrors `repro/launch/serve.py` without `--colocate`, which comes with the
training slice (`core/colocation.py::ColocatedRunner`). Runs on `cuda`
unless `--device cpu` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --requests 12 --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke \
      --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import model as MD
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=160)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = MD.init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, max_slots=args.slots, s_max=args.s_max,
                        use_kernels=args.use_kernels, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.05,
                    prompt_len=int(rng.integers(8, 24)),
                    max_new_tokens=int(rng.integers(4, 12)))
            for i in range(args.requests)]

    t0 = time.time()
    m = eng.run_trace(reqs, max_rounds=3000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    print(f"arch={cfg.name} device={device} rounds={m.decode_rounds} "
          f"tokens={m.tokens_out} prefills={m.prefills} wall={wall:.1f}s")
    return m


if __name__ == "__main__":
    main()
