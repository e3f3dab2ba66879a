"""Serving entry point: a decode instance, optionally co-located with PEFT
(Harli).

Port of `repro/launch/serve.py`. With `--colocate`, each decode round runs
up to `--k-max` finetune layer units of `--ft-arch` (default: the served
model, sharing its weights), as many as the QoS scheduler allows under
`--qos-s`. The scheduler's latency predictor is fit, by default
(`--predictor profile`), from rounds measured on the device it runs on
before serving starts (k = 0 rounds for the solo stage, k > 0 rounds for
the co-located stage). `--predictor costmodel` is the reference's route:
`fit_from_costmodel` on the roofline cost model of the full-width `--arch`
(`core/costmodel.py`), here on one H100 (`InstanceSpec()`). Runs on
`cuda` unless `--device cpu` is given. On the card the rounds replay CUDA
graphs, captured before serving (the capture time and the memory it took
are printed); on the CPU they run eagerly.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --requests 12 --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --colocate --predictor costmodel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --smoke --device cpu --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --smoke --device cpu --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --smoke --device cpu --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --smoke --device cpu --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --smoke --device cpu --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b \
      --smoke --device cpu --colocate --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --smoke --device cpu --colocate \
      --use-kernels

An encoder-decoder model (`seamless-m4t-large-v2`) serves requests of 16
stub encoder frames each and finetunes on rows of 16 frames, as the
reference's `launch/serve.py` does.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import graphs as G
from repro_torch.core.colocation import (ColocatedRunner, fit_predictor,
                                         profile_rounds, run_colocated_trace)
from repro_torch.core.costmodel import CostModel, InstanceSpec
from repro_torch.core.predictor import TwoStageLatencyPredictor
from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
from repro_torch.models import model as MD
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from repro_torch.training import peft as P
from repro_torch.training.data import DataConfig, Prefetcher, SyntheticCorpus


def captured(precompile, device) -> None:
    """Run a `precompile` (CUDA graph capture) and print its time and
    memory (`graphs.measured`)."""
    secs, alloc, reserved = G.measured(precompile, device)
    print(f"captured CUDA graphs in {secs:.1f}s: allocated "
          f"+{alloc / 1e6:.1f} MB, reserved +{reserved / 1e6:.1f} MB "
          f"(graph pool)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--ft-arch", default="")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=160)
    ap.add_argument("--colocate", action="store_true")
    ap.add_argument("--k-max", type=int, default=6)
    ap.add_argument("--qos-s", type=float, default=SchedulerConfig.qos_s,
                    help="decode-round latency target of the scheduler")
    ap.add_argument("--predictor", choices=("profile", "costmodel"),
                    default="profile",
                    help="fit the scheduler's predictor from profiled rounds "
                         "or from the cost model")
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = MD.init_params(cfg, 0, device=device)
    eng = ServingEngine(cfg, params, max_slots=args.slots, s_max=args.s_max,
                        enc_len=16 if cfg.enc_layers else 0,
                        use_kernels=args.use_kernels, device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.05,
                    prompt_len=int(rng.integers(8, 24)),
                    max_new_tokens=int(rng.integers(4, 12)))
            for i in range(args.requests)]

    if not args.colocate:
        if eng.graphs:
            captured(eng.precompile, device)
        t0 = time.time()
        m = eng.run_trace(reqs, max_rounds=3000)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"arch={cfg.name} device={device} rounds={m.decode_rounds} "
              f"tokens={m.tokens_out} prefills={m.prefills} "
              f"wall={time.time() - t0:.1f}s")
        return m

    ft_name = args.ft_arch or args.arch
    if ft_name == args.arch:
        cfg_ft, params_ft = cfg, params          # one copy of the weights
    else:
        cfg_ft = smoke_config(ft_name) if args.smoke else get_config(ft_name)
        params_ft = MD.init_params(cfg_ft, 1, device=device)
    pc = P.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    pf = Prefetcher(SyntheticCorpus(DataConfig(
        cfg_ft.vocab_size, pc.seq_len, pc.micro_batch,
        frontend_tokens=P.front_tokens(cfg_ft),
        enc_frames=16 if cfg_ft.enc_layers else 0, d_model=cfg_ft.d_model)
    ).batches(), pc.n_stage)
    ft_state = P.init_ft_state(cfg_ft, pc, params_ft, 2, pf.stacked())
    runner = ColocatedRunner(cfg, params, cfg_ft, params_ft, pc,
                             k_max=args.k_max, use_kernels=args.use_kernels)
    if runner.graphs:
        captured(lambda: runner.precompile(eng.cache, ft_state), device)
    t0 = time.time()
    if args.predictor == "costmodel":
        pred = TwoStageLatencyPredictor(k_max=args.k_max)
        pred.fit_from_costmodel(CostModel(get_config(args.arch),
                                          InstanceSpec()))
        print(f"fit from the cost model of {args.arch} on "
              f"{InstanceSpec().chip.name} in {time.time() - t0:.2f}s: "
              f"solo mean err {pred.report.solo_mean_err:.3f}, colo mean "
              f"err {pred.report.colo_mean_err:.3f}")
    else:
        solo, colo, ft_state = profile_rounds(
            runner, eng.cache, ft_state,
            batch_sizes=sorted({1, max(args.slots // 2, 1), args.slots}),
            contexts=sorted({args.s_max // 8, args.s_max // 4,
                             args.s_max // 2}),
            ks=sorted({1, max(args.k_max // 2, 1), args.k_max}), repeats=2)
        pred = fit_predictor(args.k_max, solo, colo)
        print(f"profiled {len(solo[1.0])} solo and {len(colo)} co-located "
              f"points in {time.time() - t0:.1f}s: solo mean err "
              f"{pred.report.solo_mean_err:.3f}, colo mean err "
              f"{pred.report.colo_mean_err:.3f}")
    sched = QoSScheduler(pred, SchedulerConfig(qos_s=args.qos_s,
                                               k_max=args.k_max))
    t0 = time.time()
    m, ft_state = run_colocated_trace(eng, runner, sched, ft_state, reqs,
                                      max_rounds=3000)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    reasons = collections.Counter(d.reason for d in sched.decisions)
    print(f"arch={cfg.name} ft_arch={cfg_ft.name} device={device} "
          f"rounds={m.decode_rounds} tokens={m.tokens_out} "
          f"prefills={m.prefills} wall={time.time() - t0:.1f}s")
    print(f"colocated finetune units executed: {m.ft_units} "
          f"(iterations {ft_state['iter']}, last loss "
          f"{float(ft_state['last_loss']):.4f}, qos_s {args.qos_s}, "
          f"reasons {dict(reasons)})")
    return m


if __name__ == "__main__":
    main()
