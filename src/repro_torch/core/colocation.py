"""Co-located rounds: one decode step plus k finetune layer units.

Port of `repro/core/colocation.py`. The reference jits one program per
quantum level k, the decode step fused with k units (a `lax.scan` of
length k whose body picks its unit with `lax.switch` on `unit_idx`), and
`precompile` compiles them all at startup. On the card the port captures
CUDA graphs in their place: `precompile` captures the decode step at the
cache's batch (`serving/engine.py::DecodeGraph`) and one graph per unit
index of an iteration (`GraphedUnits`), and a round with k units replays
the decode graph and then the next k unit graphs, which the host's
`unit_idx` picks. Every k replays the same graphs, so there is one set of
graphs however many quantum levels there are. The units run after decode,
in order, on the current stream (overlapping them with decode, the paper's
GreenContext split, is later work: ROADMAP.md §1 item 2); the round ends
when its last unit ends, which is the latency the predictor models. The
scheduler still chooses k every round, and k = 0 is still "inference
preempts all". On the CPU, or with `graphs=False`, the same round runs
eagerly: `decode_step` and then k `unit_step` calls.

Correctness invariant (tested): a round equals `decode_step` followed by
k separate `unit_step` calls, bit for bit, graphed or eager.

Also here: `profile_rounds`, the paper's offline profiling (§8.8) run
against the real engine on the device it serves on (graphed rounds on the
card, so the predictor is fit on the rounds it schedules), and
`run_colocated_trace`, the serve loop with the scheduler in it.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import graphs as G
from repro_torch.core.predictor import TwoStageLatencyPredictor
from repro_torch.core.scheduler import QoSScheduler
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import DecodeGraph
from repro_torch.training import peft as P
from repro_torch.tree import tree_leaves


class GraphedUnits:
    """One CUDA graph per unit of `unit_step`'s iteration, captured on one
    finetune state; `run(state, k)` runs the next k units by replaying
    them. Units of one key (`UnitEngine.key`) share a graph, and a unit
    with no tensor work (EMBED_BWD without "pre" layers, which only moves
    host counters) has none. Capture first runs a whole
    iteration for real (the warm-up), then puts the state back: tensors,
    host counters and all. `pool`: the memory pool to capture into (a new
    one by default)."""

    def __init__(self, unit_step: P.UnitEngine, ft_state, pool=None):
        self.unit_step = unit_step
        self._addresses = G.addresses(ft_state)
        pool = pool or torch.cuda.graph_pool_handle()
        host = {k: ft_state[k] for k in ("unit_idx", "data_idx", "iter",
                                         "consumed")}
        t = ft_state["opt"]["t"]
        saved = G.snapshot(ft_state)
        total = unit_step.total_units
        G.on_side_stream(lambda: P.run_units(unit_step, ft_state, total))
        self.graphs: Dict[object, G.Graph] = {}
        for j in range(total):
            idx = (host["unit_idx"] + j) % total
            key = unit_step.key(idx)
            if key in self.graphs or not unit_step.has_work(idx):
                continue
            self.graphs[key] = G.capture(
                functools.partial(unit_step.run, ft_state, idx), pool)
        G.restore(saved)
        ft_state.update(host)
        ft_state["opt"]["t"] = t

    def step(self, state) -> None:
        """One unit: its host part eagerly, its tensor work by replay."""
        u = self.unit_step
        u.prepare(state)
        graph = self.graphs.get(u.key(state["unit_idx"]))
        if graph is not None:
            graph.replay()
        u.advance(state)

    def check(self, state) -> None:
        if G.addresses(state) != self._addresses:
            raise ValueError("the unit graphs were captured on another "
                             "finetune state")

    def run(self, state, k: int):
        """The next k units of `state` (the one captured on: `check`)."""
        for _ in range(max(k, 0)):
            self.step(state)
        return state


class ColocatedRunner:
    """One (decode, finetune) pair on one instance. `graphs` (default: on
    for a CUDA device) replays CUDA graphs; False runs eager rounds, and
    True off the card raises."""

    def __init__(self, cfg_inf: ModelConfig, params_inf,
                 cfg_ft: ModelConfig, params_ft, pc: P.PeftConfig,
                 k_max: int = 10, use_kernels: bool = False,
                 graphs: Optional[bool] = None):
        self.cfg_inf = cfg_inf
        self.cfg_ft = cfg_ft
        self.k_max = k_max
        self.unit_step = P.make_unit_step(cfg_ft, pc, params_ft,
                                          use_kernels=use_kernels)
        self._params_inf = params_inf
        self._use_kernels = use_kernels
        self.graphs = G.resolve(graphs, params_inf["embed"].device)
        self._decode: Optional[DecodeGraph] = None
        self._units: Optional[GraphedUnits] = None

    def _round(self, k: int, tokens, positions, cache, ft_state):
        if not self.graphs:
            logits, cache = MD.decode_step(self._params_inf, self.cfg_inf,
                                           tokens, positions, cache,
                                           use_kernels=self._use_kernels)
            ft_state = P.run_units(self.unit_step, ft_state, k)
            return logits, cache, ft_state
        if self._decode is None:
            self.precompile(cache, ft_state)
        self._units.check(ft_state)
        logits = self._decode(tokens, positions, cache)
        self._units.run(ft_state, k)
        return logits, cache, ft_state

    def variant(self, k: int) -> Callable:
        """The round with k units (clamped to [0, k_max])."""
        return functools.partial(self._round, max(0, min(k, self.k_max)))

    def run_round(self, k: int, tokens, positions, cache, ft_state):
        """(logits, cache, ft_state). Graphed, the logits are the decode
        graph's static output, which the next round overwrites."""
        return self.variant(k)(tokens, positions, cache, ft_state)

    def precompile(self, cache=None, ft_state=None) -> None:
        """The reference's AOT compile of every variant: capture the decode
        graph and the unit graphs on this cache and finetune state, and
        leave both bit-equal to what they were. Eager rounds compile
        nothing (the kernels are built at their first launch); graphed
        rounds capture at the first round if this was not called."""
        if not self.graphs:
            return
        if cache is None or ft_state is None:
            raise ValueError("capturing the rounds needs the cache and the "
                             "finetune state they will run on")
        pool = torch.cuda.graph_pool_handle()       # shared by all of them
        self._decode = DecodeGraph(self._params_inf, self.cfg_inf, cache,
                                   use_kernels=self._use_kernels, pool=pool)
        self._units = GraphedUnits(self.unit_step, ft_state, pool)


def make_ft_only_step(cfg_ft: ModelConfig, params_ft, pc: P.PeftConfig,
                      units: int, graphs: Optional[bool] = None):
    """Free-running finetune burst (bs = 0 rounds / a separate instance).
    Graphed (the default on the card), its first call captures the unit
    graphs on the state it is given, as the reference jits at first call."""
    unit_step = P.make_unit_step(cfg_ft, pc, params_ft)
    graphed = G.resolve(graphs, params_ft["embed"].device)
    box: Dict[str, GraphedUnits] = {}

    def burst(ft_state):
        if not graphed:
            return P.run_units(unit_step, ft_state, units)
        if "units" not in box:
            box["units"] = GraphedUnits(unit_step, ft_state)
        box["units"].check(ft_state)
        return box["units"].run(ft_state, units)

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
    some = tree_leaves(cache["scan"])[0]        # (layers, slots, ...)
    slots, dev = some.shape[1], some.device
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
        ctx = sum(eng.context(r.slot) for r in active) / bs
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
