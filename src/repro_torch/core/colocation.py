"""Co-located rounds: one decode step plus k finetune layer units.

Port of `repro/core/colocation.py`. On the TPU one jitted program per
quantum level k fuses the decode step with k units, and XLA interleaves
them. Here a round runs `decode_step` and then k units eagerly, in order,
on the current stream; the round ends when its last unit ends, which is
the latency the predictor models. The scheduler still chooses k every
round, and k = 0 is still "inference preempts all". CUDA graphs per k and
overlapping the units with decode (streams or SM partitioning, the paper's
GreenContext) are later work (ROADMAP.md §4).

Correctness invariant (tested): a round equals `decode_step` followed by
k separate `unit_step` calls, bit for bit.

Also here: `profile_rounds`, the paper's offline profiling (§8.8) run
against the real engine on the device it serves on, and
`run_colocated_trace`, the serve loop with the scheduler in it.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.predictor import TwoStageLatencyPredictor
from repro_torch.core.scheduler import QoSScheduler
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.training import peft as P


class ColocatedRunner:
    """One (decode, finetune) pair on one instance."""

    def __init__(self, cfg_inf: ModelConfig, params_inf,
                 cfg_ft: ModelConfig, params_ft, pc: P.PeftConfig,
                 k_max: int = 10, use_kernels: bool = False):
        self.cfg_inf = cfg_inf
        self.cfg_ft = cfg_ft
        self.k_max = k_max
        self.unit_step = P.make_unit_step(cfg_ft, pc, params_ft,
                                          use_kernels=use_kernels)
        self._params_inf = params_inf
        self._use_kernels = use_kernels

    def _round(self, k: int, tokens, positions, cache, ft_state):
        logits, cache = MD.decode_step(self._params_inf, self.cfg_inf, tokens,
                                       positions, cache,
                                       use_kernels=self._use_kernels)
        ft_state = P.run_units(self.unit_step, ft_state, k)
        return logits, cache, ft_state

    def variant(self, k: int) -> Callable:
        """The round with k units (clamped to [0, k_max])."""
        return functools.partial(self._round, max(0, min(k, self.k_max)))

    def run_round(self, k: int, tokens, positions, cache, ft_state):
        return self.variant(k)(tokens, positions, cache, ft_state)

    def precompile(self, *args, ks=None) -> None:
        """Kept for the reference's interface: eager rounds compile nothing
        (the kernels are built at their first launch)."""


def make_ft_only_step(cfg_ft: ModelConfig, params_ft, pc: P.PeftConfig,
                      units: int):
    """Free-running finetune burst (bs = 0 rounds / a separate instance)."""
    unit_step = P.make_unit_step(cfg_ft, pc, params_ft)

    def burst(ft_state):
        return P.run_units(unit_step, ft_state, units)

    return burst


def _timed_round(runner: ColocatedRunner, k: int, tokens, positions, cache,
                 ft_state) -> Tuple[float, dict]:
    """Host-clock seconds of one round, ended by the device-to-host copy of
    its greedy tokens (which waits for the units queued after decode)."""
    t0 = time.perf_counter()
    logits, _, ft_state = runner.run_round(k, tokens, positions, cache,
                                           ft_state)
    logits.argmax(dim=-1).cpu()
    return time.perf_counter() - t0, ft_state


def profile_rounds(runner: ColocatedRunner, cache, ft_state, *,
                   batch_sizes: Sequence[int], contexts: Sequence[int],
                   ks: Sequence[int], repeats: int = 3):
    """Measure rounds on the cache's device and fit-ready samples from them.

    For each (bs, ctx) point, bs slots decode at position ctx (the others at
    0) with k = 0 (solo) and each k in `ks` (co-located); each sample is the
    median of `repeats` rounds after one warm-up round. The cache is used
    as scratch: profile before serving. Returns (solo, colo, ft_state):
    solo = {1.0: [(bs, ctx, s)]} for `fit_solo`, colo = [(q_inf, q_ft, bs,
    ctx, s)] for `fit_colo`. The units run for real, so the finetune state
    advances."""
    slots = cache["scan"]["kv_pos"].shape[1]
    dev = cache["scan"]["kv_pos"].device
    tokens = torch.zeros((slots,), dtype=torch.int32, device=dev)
    solo: Dict[float, List[Tuple[int, int, float]]] = {1.0: []}
    colo: List[Tuple[float, float, int, int, float]] = []
    for bs in batch_sizes:
        for ctx in contexts:
            pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
            pos[:bs] = ctx
            for k in (0, *ks):
                times = []
                for rep in range(repeats + 1):
                    s, ft_state = _timed_round(runner, k, tokens, pos, cache,
                                               ft_state)
                    if rep:
                        times.append(s)
                lat = statistics.median(times)
                if k == 0:
                    solo[1.0].append((bs, ctx, lat))
                else:
                    q_ft = k / runner.k_max
                    colo.append((1.0 - q_ft, q_ft, bs, ctx, lat))
    return solo, colo, ft_state


def fit_predictor(k_max: int, solo, colo) -> TwoStageLatencyPredictor:
    pred = TwoStageLatencyPredictor(k_max=k_max)
    pred.fit_solo(solo)
    pred.fit_colo(colo)
    return pred


def run_colocated_trace(eng, runner: ColocatedRunner, sched: QoSScheduler,
                        ft_state, reqs, *, max_rounds: int = 10_000):
    """Serve `reqs` on `eng`, each round co-located with the k units that
    `sched` picks for its batch and mean context, and fed back the round's
    time. Returns (engine metrics, ft_state); the metrics count the units
    run (`ft_units`), the decisions are in `sched.decisions`."""
    box = {"ft": ft_state}

    def round_fn():
        active = eng.active_requests()
        if not active:
            eng.decode_round()
            return
        bs = len(active)
        ctx = sum(r.context_len for r in active) / bs
        k = sched.pick(bs, ctx, ft_ready=True,
                       ft_units_available=runner.k_max).k

        def step(tokens, positions, cache):
            logits, cache, box["ft"] = runner.run_round(
                k, tokens, positions, cache, box["ft"])
            return logits, cache

        eng.decode_round(step=step)
        sched.observe(eng.metrics.round_s[-1])
        eng.metrics.ft_units += k

    m = eng.run_trace(reqs, max_rounds=max_rounds, round_fn=round_fn)
    return m, box["ft"]
