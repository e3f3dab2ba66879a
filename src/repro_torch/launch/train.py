"""PEFT finetune driver with checkpoint/restart.

Port of `repro/launch/train.py`, with its flags, plus `--device` (the card
unless `cpu` is asked for) and `--use-kernels` (every adapted projection
through the LoRA matmul kernel, forward and backward). Two modes:

* one-shot (default): `make_train_step(remat=True)` on one batch per step,
  a checkpoint of the adapters and the optimizer state every
  `--ckpt-every` steps (asynchronous) and at the end (blocking);
* `--layer-units`: an iteration of layer units (`make_unit_step`, accum
  1) per step, the staged microbatch ring refilled after each. On the card
  the units replay CUDA graphs (`core/colocation.py::GraphedUnits`, as the
  reference jits its unit); on the CPU they run eagerly. As in the
  reference, this mode saves no checkpoint.

Two repairs of the reference, each tested (ROADMAP.md §3):
* `--resume` skips the batches the interrupted run trained on, so step
  `start` trains on batch `start`, and a run interrupted and resumed
  equals one that was not. The reference restarts its seeded corpus on
  every start, so its resumed step `start` trains on batch 0.
* `--layer-units --resume` starts its state from the restored adapters and
  AdamW moments and step count. The reference restores them and then
  builds a fresh state, so they go unused.

`main(argv)` returns the final state: {"adapters", "opt"} in one-shot
mode, the unit engine's state with `--layer-units`.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 6 --ckpt-dir /tmp/ckpt --ckpt-every 3
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 8 --ckpt-dir /tmp/ckpt --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --batch 2 --seq 1024 --steps 6 --use-kernels --layer-units
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \\
      --smoke --device cpu --steps 2 --use-kernels [--layer-units]
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --smoke --device cpu --steps 2 --use-kernels [--layer-units]
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi-3-vision-4.2b \\
      --smoke --device cpu --steps 2 --use-kernels [--layer-units]
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import graphs as G
from repro_torch.core.colocation import GraphedUnits
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.models import model as MD
from repro_torch.training import peft as P
from repro_torch.training.data import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves


def _into(dst, src) -> None:
    """Copy a tree's tensors into another's in place (the unit state's
    tensors keep their addresses, which its CUDA graphs read)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--layer-units", action="store_true",
                    help="run via the layer-unit engine instead of the "
                         "one-shot train step")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = MD.init_params(cfg, 0, device=device)
    adapters = MD.init_adapters(cfg, 1, device=device)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt = adamw_init(adapters)

    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        frontend_tokens=P.front_tokens(cfg),
        enc_frames=args.seq // 2 if cfg.enc_layers else 0,
        d_model=cfg.d_model)
    data = SyntheticCorpus(dcfg).batches()

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"adapters": adapters, "opt": opt})
        adapters, opt = state["adapters"], state["opt"]
        start = ckpt.latest_step()
        print(f"resumed from step {start}")
    for _ in range(start):              # a step takes one batch in both modes
        next(data)

    if args.layer_units:
        pc = P.PeftConfig(micro_batch=args.batch, seq_len=args.seq, accum=1,
                          opt=opt_cfg)
        pf = Prefetcher(data, depth=pc.n_stage)
        state = P.init_ft_state(cfg, pc, params, 1, pf.stacked())
        _into(state["adapters"], adapters)
        _into([state["opt"]["m"], state["opt"]["v"]], [opt["m"], opt["v"]])
        state["opt"]["t"] = opt["t"]
        unit = P.make_unit_step(cfg, pc, params,
                                use_kernels=args.use_kernels)
        upi = P.units_per_iteration(cfg, pc.accum)
        if G.resolve(None, device):
            graphed = GraphedUnits(unit, state)
            run = graphed.run
        else:
            run = functools.partial(P.run_units, unit)
        for step in range(start, args.steps):
            t0 = time.time()
            state = run(state, upi)
            consumed = state["consumed"]
            state["consumed"] = 0
            pf.refill(consumed)
            for k, v in pf.stacked().items():
                state["data"][k].copy_(torch.from_numpy(v))
            print(f"step {step:4d} loss {float(state['last_loss']):.4f} "
                  f"({time.time() - t0:.2f}s, {upi} units)")
        return state

    train_step = P.make_train_step(cfg, opt_cfg, use_kernels=args.use_kernels,
                                   remat=True)
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
        adapters, opt, metrics = train_step(params, adapters, opt, batch)
        print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
              f"ce {float(metrics['ce']):.4f} ({time.time() - t0:.2f}s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"adapters": adapters, "opt": opt},
                      blocking=False)
    if ckpt:
        ckpt.save(args.steps, {"adapters": adapters, "opt": opt})
        ckpt.wait()
        print(f"checkpoints at {sorted(ckpt.steps())}")
    return {"adapters": adapters, "opt": opt}


if __name__ == "__main__":
    main()
