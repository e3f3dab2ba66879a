"""Discrete-event co-location simulator (paper-scale experiments, Figs 11-14).

Replays a request trace against the roofline cost model on a modeled
deployment: one prefill instance + N decode instances (TP groups), each
optionally co-locating a PEFT finetune job through the unified allocator,
two-stage predictor and QoS scheduler — the same classes the real engine
uses; only step execution is virtual (costmodel latencies instead of the
device's).

Modes (paper §8.1):
  separate — decode on instance 0, finetune solo on instance 1
  static   — both instances co-located at a fixed 60/40 split
  harli    — both instances co-located, dynamic quantum + window

The port's own copy of `repro/core/simulator.py` (plain Python and numpy;
keep the two in step), with the reference's arithmetic, `SimConfig` fields
and defaults, heap tie-breaks and RNG draws. One seam is added: the
reference builds `InstanceSpec(tp=sim.tp)`, a TPU v5e group with its
constants; here `simulate`, `fit_predictor` and `DecodeInstanceSim` take the
instance's `InstanceSpec` (its chip and cost constants; by default the
port's H100 with the constants fitted on the card, `H100_CONSTANTS`) and
set its `tp` from `sim.tp`. On the reference's v5e spec every field of
`SimResult` equals the reference's (`tests/test_torch_simulator.py`).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.adapters import AdapterPool, InstanceAdapterConfig
from repro_torch.core.allocator import AllocatorConfig, UnifiedAllocator
from repro_torch.core.costmodel import CostModel, InstanceSpec
from repro_torch.core.predictor import TwoStageLatencyPredictor
from repro_torch.core.prefix_cache import PrefixCache, PrefixCacheConfig
from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
from repro_torch.distributed.fault_tolerance import (CheckpointManager,
                                               StragglerConfig,
                                               StragglerMitigator)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.request import Request


@dataclasses.dataclass
class SimConfig:
    mode: str = "harli"                 # harli | static | separate
    qos_s: float = 0.040
    k_max: int = 10
    micro_batch: int = 2
    ft_seq: int = 1024
    accum: int = 8
    max_slots: int = 64
    n_decode_instances: int = 2
    tp: int = 2            # 2 x 16GB chips: tight like the paper's Ada6000
    static_quantum: float = 0.4         # StaticMode: 40% to finetune
    static_mem_frac: float = 0.4        # StaticMode: 40% memory to finetune
    share_base_weights: bool = False    # beyond-paper same-model sharing
    snapshot_every: int = 20            # allocator timeline granularity
    straggler_prob: float = 0.0         # per-round chance of a 3-8x overrun
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    mode: str
    ft_units_done: int = 0
    ft_iterations: float = 0.0
    ft_throughput: float = 0.0          # iterations/s x minibatch (paper §8.2)
    ft_stall_rounds: int = 0
    tpot: List[float] = dataclasses.field(default_factory=list)
    qos_violation_frac: float = 0.0
    completed: int = 0
    duration: float = 0.0
    decode_rounds: int = 0
    mean_batch: float = 0.0
    batch_timeline: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    quantum_timeline: List[Tuple[float, int, float, int]] = \
        dataclasses.field(default_factory=list)   # (t, k, round_latency, bs)
    memory_timeline: List[Dict] = dataclasses.field(default_factory=list)
    predictor_report: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class ChunkedPrefillConfig:
    """prefill_mode="chunked" (core/cluster.py): prefill chunks are mixed
    into decode rounds on the serving instance itself, under a per-round
    token budget — no separate prefill tier. The budget is the control
    knob the autoscaler's mode-aware prefill loop tunes against TTFT
    headroom (``Autoscaler.evaluate_chunked``)."""
    budget_tokens: int = 256         # per-round chunk budget at t=0
    min_budget: int = 64             # autoscaler tuning range
    max_budget: int = 1024
    chunk_wait_window_s: float = 15.0   # recency horizon, TTFT signal
    # fraction of the TPOT target a chunk-carrying round may fill: the
    # remainder absorbs predictor fit error and measurement noise, so
    # admitting chunks at the priced limit doesn't push per-request TPOT
    # p99 over the SLO (which carries only tpot_slack=5% of slack)
    qos_margin: float = 0.85
    # fuse a REDUCED finetune quantum into chunk-carrying rounds when the
    # predictor says quantum + chunk together still fit the round budget
    # (``predict_mixed(k/k_max, ...) <= qos_margin * TPOT-SLO``), instead
    # of forcing quantum 0 on every chunk round. Default off: the original
    # inference-preempts-finetune behaviour (§2.3) is the pinned baseline
    fuse_quantum: bool = False


# ---------------------------------------------------------------- finetune
class FinetuneSim:
    """Layer-unit progress + window streaming state machine."""

    def __init__(self, cfg_ft: ModelConfig, cm: CostModel, sim: SimConfig,
                 allocator: UnifiedAllocator, weights_resident: bool,
                 fixed_window_chunks: Optional[int] = None):
        self.cfg = cfg_ft
        self.cm = cm
        self.sim = sim
        self.alloc = allocator
        self.weights_resident = weights_resident
        self.fixed_window_chunks = fixed_window_chunks
        L = cfg_ft.num_layers
        # unit -> layer id (-1 = no weights needed: embed/head/opt units)
        per_mb = [-1] + list(range(L)) + [-1] + list(range(L - 1, -1, -1)) \
            + [-1]
        self.unit_layers = per_mb * sim.accum + [-1]
        self.units_per_iter = len(self.unit_layers)
        self.layer_bytes = cfg_ft.active_param_count() / max(L, 1) * 2.0
        self.swap_s = self.layer_bytes / cm.inst.host_dma_bw
        self.layers_per_chunk = max(
            int(allocator.chunk_bytes // self.layer_bytes), 1) \
            if self.layer_bytes > allocator.chunk_bytes else None
        self.chunks_per_layer = max(
            math.ceil(self.layer_bytes / allocator.chunk_bytes), 1)
        # window state
        self.resident: List[int] = []
        self.dma_busy_until = 0.0
        self.dma_loading: Optional[int] = None
        self._need_known_t = 0.0
        self.cursor = 0                  # next unit index (mod units_per_iter)
        self.units_done = 0
        self.stall_rounds = 0

    # -- window geometry ---------------------------------------------------
    def window_layers_cap(self) -> int:
        if self.weights_resident:
            return self.cfg.num_layers
        chunks = self.alloc.window_capacity_chunks()
        if self.fixed_window_chunks is not None:      # StaticMode
            chunks = min(chunks, self.fixed_window_chunks)
        return min(max(chunks // self.chunks_per_layer, 0),
                   self.cfg.num_layers)

    def _need_order(self, start_unit: int, horizon: int = 64) -> List[int]:
        """Upcoming distinct layers in unit order."""
        out, seen = [], set()
        for d in range(horizon):
            lay = self.unit_layers[(start_unit + d) % self.units_per_iter]
            if lay >= 0 and lay not in seen:
                seen.add(lay)
                out.append(lay)
        return out

    def pump_dma(self, t: float) -> None:
        """Advance the streaming channel's timeline up to time t. Loads
        chain back-to-back on the channel; a load started at s lands at
        s + swap_s. Needs become known at advance() time (= pump calls)."""
        if self.weights_resident:
            return
        cap = self.window_layers_cap()
        # inference memory pressure: evict furthest-from-need beyond cap
        while len(self.resident) > cap:
            order = self._need_order(self.cursor)
            furthest = max(self.resident,
                           key=lambda l: order.index(l) if l in order
                           else len(order) + l)
            self.resident.remove(furthest)
        self.alloc.resize_window(
            len(self.resident) * self.chunks_per_layer)
        while True:
            if self.dma_loading is not None:
                if self.dma_busy_until > t:
                    return                       # still streaming
                if len(self.resident) < cap:
                    self.resident.append(self.dma_loading)
                    self.alloc.resize_window(
                        len(self.resident) * self.chunks_per_layer)
                self.dma_loading = None
            order = self._need_order(self.cursor,
                                     horizon=2 * self.units_per_iter
                                     if self.units_per_iter < 2048 else 256)
            nxt = next((l for l in order if l not in self.resident), None)
            if nxt is None or cap == 0:
                return
            if len(self.resident) >= cap:
                # paper §4.3: evict the completed layer to prefetch the next
                # (Belady: furthest-from-next-use victim)
                def dist(l):
                    return order.index(l) if l in order else 10 ** 9
                victim = max(self.resident, key=dist)
                if dist(victim) <= order.index(nxt):
                    return               # every resident layer needed sooner
                self.resident.remove(victim)
            # chain from the previous completion; a fresh need starts now
            start = max(self.dma_busy_until, self._need_known_t)
            self.dma_loading = nxt
            self.dma_busy_until = start + self.swap_s

    def units_available(self, t: float, k_max: int) -> int:
        """How many consecutive upcoming units can run right now."""
        self.pump_dma(t)
        n = 0
        for d in range(k_max):
            lay = self.unit_layers[(self.cursor + d) % self.units_per_iter]
            if lay >= 0 and not self.weights_resident and \
                    lay not in self.resident:
                break
            n += 1
        return n

    def advance(self, k: int, t_end: float) -> None:
        self.cursor = (self.cursor + k) % self.units_per_iter
        self.units_done += k
        self._need_known_t = t_end
        self.pump_dma(t_end)

    @property
    def iterations(self) -> float:
        return self.units_done / self.units_per_iter

    def avg_unit_time_solo(self) -> float:
        f = self.cm.unit_solo(self.sim.micro_batch, self.sim.ft_seq,
                              backward=False, noisy=False)
        b = self.cm.unit_solo(self.sim.micro_batch, self.sim.ft_seq,
                              backward=True, noisy=False)
        return (f + b) / 2


class FinetuneCheckpointer:
    """Periodic durable commit of a finetune job's progress through the
    fault-tolerance ``CheckpointManager`` (distributed/fault_tolerance.py).

    The cluster failure layer attaches one per finetune-carrying instance
    when failure injection is on: every ``interval_s`` of sim time the
    job's progress commits as a real on-disk checkpoint (restore after a
    kill reads it back — the module's atomic-manifest path is exercised,
    not mocked), and the commit's device->host stream cost
    (``CostModel.checkpoint_time``) is charged to the finetune quantum
    budget — rounds inside the commit window run quantum 0."""

    def __init__(self, directory, interval_s: float, commit_time_s: float,
                 t0: float = 0.0, keep: int = 2):
        self.mgr = CheckpointManager(directory, keep=keep)
        self.interval_s = interval_s
        self.commit_time_s = commit_time_s
        self.last_commit_t = t0
        self.busy_until = -1.0
        self.commits = 0

    def busy(self, t: float) -> bool:
        """True while a commit's device->host stream is still running —
        the finetune job yields its quantum for these rounds."""
        return t < self.busy_until

    def maybe_commit(self, t: float, units_done: int) -> bool:
        """Commit when the cadence is due. Returns True iff a commit was
        started at ``t`` (the caller charges the round's quantum to it)."""
        if t - self.last_commit_t < self.interval_s:
            return False
        self.commit(t, units_done)
        return True

    def commit(self, t: float, units_done: int) -> None:
        self.commits += 1
        self.mgr.save(self.commits, {"units_done": np.asarray(units_done)})
        self.last_commit_t = t
        self.busy_until = t + self.commit_time_s

    def restore_units(self) -> int:
        """Progress at the last durable commit (0 before the first one)."""
        if self.mgr.latest_step() is None:
            return 0
        return int(self.mgr.restore({"units_done": None})["units_done"])


# ----------------------------------------------------------- decode + colo
# Instance roles (autoscaler-controlled; see core/autoscaler.py):
#   decode    — inference only, finetune quantum forced to 0
#   colocated — inference + co-scheduled finetune (harli/static behaviour)
#   finetune  — dedicated finetune instance; free-runs whenever idle
ROLES = ("decode", "colocated", "finetune")


class DecodeInstanceSim:
    """One decode instance, drivable by an external event loop.

    Two usage modes:
      * single-instance experiments call ``run(reqs, ready_times, duration)``
        (the original monolithic loop, now a thin wrapper);
      * the cluster layer (core/cluster.py) calls ``enqueue`` as the router
        dispatches requests and ``step(until)`` to advance one event at a
        time, interleaving instances on a shared clock.
    """

    def __init__(self, inst_id: int, cfg_inf: ModelConfig,
                 cfg_ft: Optional[ModelConfig], sim: SimConfig,
                 predictor: Optional[TwoStageLatencyPredictor], seed: int,
                 serves_inference: bool = True, t0: float = 0.0,
                 role: Optional[str] = None, *,
                 chunked: Optional[ChunkedPrefillConfig] = None,
                 prefix_cache: Optional[PrefixCacheConfig] = None,
                 ckpt: Optional[FinetuneCheckpointer] = None,
                 adapters: Optional[InstanceAdapterConfig] = None,
                 spec: InstanceSpec = InstanceSpec()):
        self.inst_id = inst_id
        self.sim = sim
        self.cfg_inf = cfg_inf
        self.serves_inference = serves_inference
        self.predictor = predictor
        spec = dataclasses.replace(spec, tp=sim.tp)
        self.cm_inf = CostModel(cfg_inf, spec, seed=seed)
        self.colocate = cfg_ft is not None

        weights = cfg_inf.param_count() * 2.0 if serves_inference else 0.0
        pool = int(spec.hbm_bytes - weights)
        assert pool > 0, "inference weights exceed instance HBM"
        swap_guess = 0.002
        self.alloc = UnifiedAllocator(AllocatorConfig(
            total_bytes=pool, n_layers=cfg_inf.num_layers,
            kv_bytes_per_token=cfg_inf.cache_bytes_per_token()
            + (cfg_inf.state_bytes() // max(sim.max_slots, 1) if
               cfg_inf.state_bytes() else 0),
            max_bs=sim.max_slots, qos_s=sim.qos_s, swap_time_s=swap_guess))
        fixed_window = None
        if sim.mode == "static" and self.colocate:
            # static 60/40 split: finetune owns a fixed fraction of the pool
            fixed_window = int(self.alloc.total_chunks * sim.static_mem_frac)
        self.ft: Optional[FinetuneSim] = None
        if self.colocate:
            cm_ft = CostModel(cfg_ft, spec, seed=seed + 1)
            resident = sim.share_base_weights and cfg_ft.name == cfg_inf.name
            self.ft = FinetuneSim(cfg_ft, cm_ft, sim, self.alloc, resident,
                                  fixed_window_chunks=fixed_window)
            self.alloc.cfg.swap_time_s = self.ft.swap_s
        self.sched = None
        if predictor is not None and sim.mode == "harli" and self.colocate:
            self.sched = QoSScheduler(predictor, SchedulerConfig(
                qos_s=sim.qos_s, k_max=sim.k_max))
        # decode-round deadline monitor: overruns (preempted host, slow
        # chip) shed finetune work first — never inference
        self.straggler = StragglerMitigator(StragglerConfig())
        self._rng = np.random.default_rng(seed + 101)
        # inference admission budget (chunks): StaticMode caps inference at
        # its static share; otherwise everything minus the reserve is usable
        if sim.mode == "static" and self.colocate:
            self.kv_budget_chunks = int(
                self.alloc.total_chunks * (1 - sim.static_mem_frac))
        else:
            self.kv_budget_chunks = (self.alloc.total_chunks
                                     - self.alloc.reserved_chunks)
        self.result_tpot: List[float] = []
        self.batch_timeline: List[Tuple[float, int]] = []
        self.quantum_timeline: List[Tuple[float, int, float, int]] = []
        self.rounds = 0
        self.bs_accum = 0
        # ---- external-event-loop state ---------------------------------
        if role is None:
            role = "colocated" if self.colocate else "decode"
            if not serves_inference:
                role = "finetune"
        assert role in ROLES, role
        self.role = role
        self.t = t0                      # instance-local clock
        self.draining = False            # router stops dispatching here
        # ---- failure layer (core/cluster.py, ClusterConfig.failures) ----
        self.ckpt = ckpt if self.colocate else None
        self.preempt_deadline = -1.0     # >= 0: spot-style notice received
        # degradation-ladder stage 1 (core/cluster.py DegradationConfig):
        # fleet-wide finetune circuit breaker — colocated quantum forced
        # to 0 until the violation fraction recovers
        self.ft_breaker = False
        self.killed_at = -1.0            # >= 0: hard-killed at this time
        self.active: List[Request] = []
        self._pending: List[Tuple[float, int, Request]] = []   # ready heap
        self.all_reqs: List[Request] = []
        self.dropped = 0                 # requests that could never fit
        self._snap_ctr = 0
        # ---- chunked prefill (prefill_mode="chunked") -------------------
        self.chunked = chunked
        self.chunk_budget = chunked.budget_tokens if chunked else 0
        # FIFO over arrival: chunked prefill keeps arrival order (the EDF
        # reordering lives in the pooled tier; here fairness is per-round)
        self._chunk_pending: List[Tuple[float, int, Request]] = []
        self.chunk_timeline: List[Tuple[float, int, int]] = []  # (t,tok,bud)
        self.chunk_waits: Deque[Tuple[float, float]] = deque()  # (done,wait)
        # ---- session prefix cache ---------------------------------------
        # reserved AFTER kv_budget_chunks: the cache's chunks come out of
        # the KV admission budget, so cached prefixes are paid-for memory
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache is not None and serves_inference:
            self.prefix_cache = PrefixCache(prefix_cache, self.alloc)
            self.kv_budget_chunks = max(
                self.kv_budget_chunks - self.prefix_cache.granted_chunks, 1)
        # ---- multi-LoRA adapter serving (core/adapters.py) --------------
        # resident adapter chunks are charged dynamically: _can_admit and
        # kv_headroom_chunks subtract alloc.adapter_chunks, so hot-loads
        # genuinely compete with KV admission instead of pre-carving a
        # static budget slice
        self.adapters: Optional[AdapterPool] = None
        if adapters is not None and serves_inference:
            self.adapters = AdapterPool(self.alloc, adapters)

    # -- external event-loop API ------------------------------------------
    def set_role(self, role: str) -> None:
        assert role in ROLES, role
        if role == "colocated":
            assert self.colocate, "instance has no finetune job to resume"
        self.role = role

    def enqueue(self, req: Request, ready_time: float) -> None:
        """Hand a request to this instance; it becomes admissible once its
        prefill completes at ``ready_time``."""
        heapq.heappush(self._pending, (ready_time, req.rid, req))
        self.all_reqs.append(req)
        if self.adapters is not None:
            self.adapters.require(req.adapter_id, req.adapter_version)

    def enqueue_chunked(self, req: Request, now: float) -> None:
        """Hand a request whose prefill this instance will run in chunks
        mixed into its own decode rounds (prefill_mode="chunked"). The
        request joins the decode queue once its last chunk completes."""
        assert self.chunked is not None, "instance not in chunked mode"
        heapq.heappush(self._chunk_pending,
                       (max(req.arrival, now), req.rid, req))
        self.all_reqs.append(req)
        if self.adapters is not None:
            self.adapters.require(req.adapter_id, req.adapter_version)

    def recall(self, rid: int) -> Optional[Request]:
        """Pull a not-yet-admitted request back out of the ready queue (its
        pooled prefill worker died, so the KV it was waiting on is gone).
        Only pending requests can be recalled — an admitted one holds real
        KV on *this* instance and is unaffected by a worker's death."""
        for i, (_, r_rid, req) in enumerate(self._pending):
            if r_rid == rid:
                self._pending.pop(i)
                heapq.heapify(self._pending)
                self.all_reqs = [r for r in self.all_reqs if r.rid != rid]
                return req
        return None

    def migratable(self) -> List[Tuple[Request, str, float]]:
        """In-flight requests a live KV migration could move off this
        instance, as ``(request, kind, ready_time)`` — kind tells the
        router which queue the request re-enters on the destination:
        ``active`` (decoding, full context resident), ``pending`` (prefill
        done, KV waiting for admission) or ``chunked`` (mid chunked
        prefill). Deterministic order: active by rid, then the queues in
        heap-key order."""
        out: List[Tuple[Request, str, float]] = []
        for r in sorted(self.active, key=lambda r: r.rid):
            out.append((r, "active", self.t))
        for ready, _, req in sorted(self._pending):
            out.append((req, "pending", ready))
        for arr, _, req in sorted(self._chunk_pending):
            out.append((req, "chunked", arr))
        return out

    def kv_headroom_chunks(self) -> int:
        """Free KV admission budget under the conservative reservation
        ``_can_admit`` uses (prompt + max output for every in-flight
        request) — the signal the default migration destination policy
        ranks candidates by."""
        tok = sum(r.prompt_len + r.max_new_tokens for r in self.active)
        tok += sum(req.prompt_len + req.max_new_tokens
                   for _, _, req in self._pending)
        tok += sum(req.prompt_len + req.max_new_tokens
                   for _, _, req in self._chunk_pending)
        return self.kv_budget_chunks - self.alloc.adapter_chunks \
            - math.ceil(tok / self.alloc.tokens_per_chunk)

    def begin_preempt(self, deadline: float) -> None:
        """Spot-style preemption notice: drain gracefully until
        ``deadline``. No new dispatches land here (draining), the finetune
        job commits a final checkpoint and stops — whatever decode work
        remains at the deadline dies with the host."""
        self.draining = True
        self.preempt_deadline = deadline
        if self.ckpt is not None and self.ft is not None:
            self.ckpt.commit(self.t, self.ft.units_done)

    def kill(self, t: float) -> Tuple[List[Request], float]:
        """Hard instance failure at ``t``: every in-flight request loses
        its KV cache (the caller requeues them through the router), the
        prefix cache is invalidated, and the finetune job rolls back to
        its last durable checkpoint. Returns ``(lost_requests,
        ft_iterations_lost)``; completed requests stay in ``all_reqs`` —
        they happened."""
        lost = list(self.active)
        lost += [item[2] for item in self._pending]
        lost += [item[2] for item in self._chunk_pending]
        self.active = []
        self._pending = []
        self._chunk_pending = []
        lost_rids = {r.rid for r in lost}
        self.all_reqs = [r for r in self.all_reqs
                         if r.rid not in lost_rids]
        self.draining = True
        self.killed_at = t
        ft_lost_iters = 0.0
        if self.ft is not None:
            restored = 0
            if self.ckpt is not None:
                restored = min(self.ckpt.restore_units(),
                               self.ft.units_done)
            ft_lost_iters = (self.ft.units_done - restored) \
                / self.ft.units_per_iter
            self.ft.units_done = restored
            self.ft.cursor = restored % self.ft.units_per_iter
        if self.prefix_cache is not None:
            self.prefix_cache.invalidate_all()
        if self.adapters is not None:
            self.adapters.evict_all()
        return lost, ft_lost_iters

    @property
    def queue_depth(self) -> int:
        return len(self._pending) + len(self._chunk_pending) \
            + len(self.active)

    @property
    def drained(self) -> bool:
        """True once a draining instance has emptied and may be retired."""
        return self.draining and not self.active and not self._pending \
            and not self._chunk_pending

    def load(self) -> float:
        """Occupancy signal for the router/autoscaler: active + queued
        requests relative to the slot budget (may exceed 1.0)."""
        return self.queue_depth / max(self.sim.max_slots, 1)

    def _can_admit(self, active: List[Request], cand: Request) -> bool:
        """vLLM-style conservative admission: reserve prompt + max output
        for every active request so decode never runs out of KV memory."""
        tok = cand.prompt_len + cand.max_new_tokens
        tok += sum(r.prompt_len + r.max_new_tokens for r in active)
        need = math.ceil(tok / self.alloc.tokens_per_chunk)
        # resident LoRA adapters occupy real chunks: admission competes
        # with them (adapter_chunks is 0 when adapter serving is off)
        return need <= self.kv_budget_chunks - self.alloc.adapter_chunks

    def _pick_k(self, t, bs, ctx) -> int:
        if not self.colocate or self.role == "decode":
            return 0
        if self.preempt_deadline >= 0:
            # preemption notice: the job committed its final checkpoint in
            # begin_preempt and stops — remaining rounds drain decode only
            return 0
        if self.ft_breaker and self.role == "colocated":
            # fleet past QoS headroom: every colocated quantum yields to
            # inference until the breaker resets. Dedicated finetune
            # instances are exempt — pausing them frees no decode capacity
            if bs > 0:
                self.ft.stall_rounds += 1
            return 0
        if self.ckpt is not None:
            if self.ckpt.busy(t):
                # the commit's device->host stream occupies the finetune
                # side of the round: quantum 0, charged as a stall
                if bs > 0:
                    self.ft.stall_rounds += 1
                return 0
            if self.ckpt.maybe_commit(t, self.ft.units_done):
                if bs > 0:
                    self.ft.stall_rounds += 1
                return 0
        if self.straggler.suppress_quantum and bs > 0:
            self.ft.stall_rounds += 1
            return 0
        avail = self.ft.units_available(t, self.sim.k_max)
        if avail == 0:
            if bs > 0:
                self.ft.stall_rounds += 1
            return 0
        if self.role == "finetune" or \
                (self.sched is None and self.sim.mode != "static"):
            # dedicated ft instance (or no QoS scheduler fitted, e.g. the
            # separate-mode ft instance): free-run only while idle
            return self.sim.k_max if bs == 0 else 0
        if self.sim.mode == "static":
            return min(int(round(self.sim.static_quantum * self.sim.k_max)),
                       avail)
        d = self.sched.pick(bs, ctx, ft_ready=avail > 0,
                            ft_units_available=avail)
        return d.k

    # -- chunked prefill --------------------------------------------------
    def _fused_chunk_k(self, bs: int, ctx: float, chunk_tokens: int,
                       takes: List[Tuple[Request, int]]) -> int:
        """Finetune quantum to fuse into a chunk-carrying round. 0 unless
        ``ChunkedPrefillConfig.fuse_quantum`` is on AND the predictor's
        fused mixed stage (fit over q_ft>0 rounds, ``fit_mixed_fused``)
        prices a reduced quantum + the chunk as jointly fitting
        ``qos_margin * TPOT-SLO`` — then the largest such quantum runs
        alongside the chunk instead of being preempted outright."""
        if not self.chunked.fuse_quantum or not self.colocate \
                or self.role != "colocated" or self.sched is None \
                or self.predictor is None \
                or self.predictor.mixed_fused_coef is None \
                or self.straggler.suppress_quantum:
            return 0
        # TTFT guard: fuse only when this round's chunk drains the whole
        # arrived prefill queue. Under backlog every extra round-ms delays
        # queued first tokens (inference > finetune, §2.3) — the fused
        # quantum harvests rounds whose chunk work is the queue's tail
        covered = {r.rid: tok for r, tok in takes}
        for arr, _, r in self._chunk_pending:
            if arr > self.t:
                continue
            if r.effective_prompt_len - r.prefilled_tokens \
                    - covered.get(r.rid, 0) > 0:
                return 0
        avail = self.ft.units_available(self.t, self.sim.k_max)
        limit = self.sim.qos_s * self.chunked.qos_margin
        for k in range(min(avail, self.sim.k_max), 0, -1):
            if self.predictor.predict_mixed_fused(
                    k / self.sim.k_max, bs, ctx, chunk_tokens) <= limit:
                return k
        return 0

    def _chunk_qos_cap(self, bs: int, ctx: float, chunk_ctx: float) -> int:
        """Largest chunk this round may carry without the predicted round
        latency breaking the TPOT target — the prediction-driven admission
        price (paper §5 applied to chunks). Chunk rounds run at q_ft=0
        (inference work preempts finetune, §2.3). Falls back to a
        deterministic cost-model halving search when no predictor is
        fitted (e.g. separate mode)."""
        budget = self.chunk_budget
        if bs == 0:
            return budget            # no decode tokens to protect
        limit = self.sim.qos_s * self.chunked.qos_margin
        if self.predictor is not None and \
                self.predictor.mixed_coef is not None:
            return min(budget,
                       max(self.predictor.max_chunk_tokens(
                           0.0, bs, ctx, limit, budget), 0))
        tok = budget
        while tok > 0 and self.cm_inf.mixed_round_latency(
                bs, ctx, tok, chunk_ctx, noisy=False) > limit:
            tok //= 2
        return tok

    def _select_chunk(self, bs: int, ctx: float
                      ) -> Tuple[int, float, List[Tuple[Request, int]]]:
        """Plan this round's prefill chunk: FIFO over arrived pending
        requests, capped by the per-round budget and (when decode tokens
        share the round) the QoS price. Returns (tokens, mean chunk
        context, [(request, tokens taken)]); nothing is committed until
        ``_apply_chunk`` runs with the round's end time."""
        takes: List[Tuple[Request, int]] = []
        if not self.chunked or not self._chunk_pending \
                or self._chunk_pending[0][0] > self.t:
            return 0, 0.0, takes
        head = self._chunk_pending[0][2]
        left = self._chunk_qos_cap(
            bs, ctx, head.cache_hit_tokens + head.prefilled_tokens)
        total, ctx_accum = 0, 0.0
        # walk the heap in FIFO (arrival, rid) order by popping, then push
        # every popped item back — the plan usually consumes 1-2 heads, so
        # this stays O(k log n) instead of sorting the whole queue per round
        popped: List[Tuple[float, int, Request]] = []
        while self._chunk_pending and left > 0:
            item = heapq.heappop(self._chunk_pending)
            popped.append(item)
            if item[0] > self.t:
                break
            r = item[2]
            rem = r.effective_prompt_len - r.prefilled_tokens
            tok = min(rem, left)
            takes.append((r, tok))
            ctx_accum += (r.cache_hit_tokens + r.prefilled_tokens
                          + tok / 2) * tok
            total += tok
            left -= tok
        for item in popped:
            heapq.heappush(self._chunk_pending, item)
        mean_ctx = ctx_accum / total if total else 0.0
        return total, mean_ctx, takes

    def _apply_chunk(self, takes: List[Tuple[Request, int]],
                     start: float, end: float) -> None:
        """Commit a planned chunk after its round ran: advance per-request
        progress, and move fully-prefilled requests to the decode queue."""
        finished_rids = set()
        for r, tok in takes:
            if r.prefill_start < 0:
                r.prefill_start = start
            r.prefilled_tokens += tok
            if r.prefilled_tokens >= r.effective_prompt_len:
                r.prefill_done = end
                finished_rids.add(r.rid)
                self.chunk_waits.append((end, end - r.arrival))
                heapq.heappush(self._pending, (end, r.rid, r))
        if finished_rids:
            self._chunk_pending = [
                item for item in self._chunk_pending
                if item[1] not in finished_rids]
            heapq.heapify(self._chunk_pending)

    def recent_chunk_waits(self, now: float) -> List[float]:
        """Arrival -> prefill-done waits of chunked requests completed
        within the recency window (old samples are pruned). The router
        pools these fleet-wide into the TTFT-headroom p99 the autoscaler's
        chunk-budget loop reads (mirrors PrefillPool.wait_p99)."""
        if not self.chunked:
            return []
        lo = now - self.chunked.chunk_wait_window_s
        while self.chunk_waits and self.chunk_waits[0][0] < lo:
            self.chunk_waits.popleft()
        return [w for t, w in self.chunk_waits if t >= lo]

    # -- one simulation event ---------------------------------------------
    def _admit(self) -> None:
        while self._pending and self._pending[0][0] <= self.t \
                and len(self.active) < self.sim.max_slots:
            r = self._pending[0][2]
            if not self._can_admit(self.active, r):
                if not self.active and not self._can_admit([], r):
                    # can never fit even on an empty instance: drop it
                    # (finish stays -1 — routed but not completed) rather
                    # than wedge the queue head and stall the event loop
                    heapq.heappop(self._pending)
                    self.dropped += 1
                    continue
                break
            self.alloc.pressure_shrink()
            # context_len == prompt_len on first admission; a restarted
            # request (instance failure) re-allocates its full context —
            # the re-prefill regenerated prompt AND already-emitted tokens
            if not self.alloc.kv_alloc_tokens(r.context_len):
                break
            heapq.heappop(self._pending)
            if r.generated == 0:
                r.token_times.append(self.t)    # first token from prefill
                r.generated = 1
            # else: re-admitted after a failure — decode resumes at the old
            # cursor, and the kill -> re-admit gap lands between consecutive
            # token_times as the churn TPOT penalty
            self.active.append(r)
            if self.prefix_cache is not None and r.session_id >= 0:
                # the prompt KV is resident from here on: later requests
                # sharing any leading segment (same session, or a shared
                # system prompt) routed here skip prefill for the prefix
                self.prefix_cache.insert(r.session_id, r.prompt_len,
                                         segments=r.prefix_segments)

    def step(self, until: float) -> float:
        """Advance the instance clock by ONE event (an idle fast-forward, a
        finetune free-run burst, or a decode round), never starting an event
        at or beyond ``until``. Returns the new clock. A decode round that
        begins before ``until`` may finish past it (rounds are atomic)."""
        if self.t >= until:
            return self.t
        sim = self.sim
        self._admit()
        bs = len(self.active)
        ctx = (sum(r.context_len for r in self.active) / bs) if bs else 0.0
        chunk_ready = bool(self._chunk_pending) \
            and self._chunk_pending[0][0] <= self.t
        # ---- prefill-only round (chunked mode, no active decode) --------
        if bs == 0 and chunk_ready:
            tokens, chunk_ctx, takes = self._select_chunk(0, 0.0)
            if tokens > 0:
                start = self.t
                lat = self.cm_inf.mixed_round_latency(0, 0.0, tokens,
                                                      chunk_ctx)
                lat += self._adapter_load_s()
                self.t += lat
                self._apply_chunk(takes, start, self.t)
                self.chunk_timeline.append((start, tokens,
                                            self.chunk_budget))
                # a prefill round is inference work: finetune yields, but
                # its streaming channel keeps moving
                self.quantum_timeline.append((self.t, 0, lat, 0))
                if self.colocate:
                    self.ft.pump_dma(self.t)
                return self.t
        # ---- idle fast-forward ------------------------------------------
        if bs == 0:
            nxt = until
            if self._pending:
                nxt = min(self._pending[0][0], nxt)
            if self._chunk_pending:
                nxt = min(self._chunk_pending[0][0], nxt)
            if nxt <= self.t:
                # head-of-line ready but blocked (transient alloc failure):
                # with no active work nothing can unblock it before `until`,
                # so jump there instead of spinning in place
                nxt = until
            if self.colocate and self.role != "decode":
                k = self._pick_k(self.t, 0, 0.0)
                if k > 0:
                    # free-run, but stop at the next arrival (+1 unit)
                    unit = self.ft.avg_unit_time_solo()
                    if self.t + k * unit > nxt:
                        k = max(1, min(k, int((nxt - self.t) / unit) + 1))
                    lat = k * unit
                    self.ft.advance(k, self.t + lat)
                    self.quantum_timeline.append((self.t, k, lat, 0))
                    self.t += lat
                    return self.t
                # stalled on DMA: jump to DMA completion or next arrival
                self.t = min(max(self.ft.dma_busy_until, self.t + 1e-4), nxt)\
                    if self.ft.dma_busy_until > self.t else nxt
                return self.t
            self.t = nxt
            return self.t
        # ---- co-scheduled decode round ----------------------------------
        cm = self.cm_inf
        chunk_tokens, chunk_ctx, takes = (
            self._select_chunk(bs, ctx) if chunk_ready else (0, 0.0, []))
        if chunk_tokens > 0:
            # the round carries a prefill chunk: inference work preempts
            # finetune (§2.3), so the quantum is 0 — unless fuse_quantum
            # is on and the predictor prices a reduced quantum + the
            # chunk as jointly fitting the round budget. The chunk's own
            # TPOT impact was priced by _chunk_qos_cap before admission.
            k = self._fused_chunk_k(bs, ctx, chunk_tokens, takes)
            lat = cm.mixed_round_latency(
                bs, ctx, chunk_tokens, chunk_ctx, k_units=k,
                micro_batch=sim.micro_batch, seq_len=sim.ft_seq)
            expected = cm.mixed_round_latency(
                bs, ctx, chunk_tokens, chunk_ctx, k_units=k,
                micro_batch=sim.micro_batch, seq_len=sim.ft_seq,
                noisy=False)
        else:
            k = self._pick_k(self.t, bs, ctx)
            if k > 0:
                lat = cm.colocated_round(bs, ctx, k, sim.micro_batch,
                                         sim.ft_seq)
                expected = cm.colocated_round(bs, ctx, k, sim.micro_batch,
                                              sim.ft_seq, noisy=False)
            else:
                lat = cm.decode_solo(bs, ctx)
                expected = cm.decode_solo(bs, ctx, noisy=False)
        if sim.straggler_prob and self._rng.random() < sim.straggler_prob:
            lat *= float(self._rng.uniform(3.0, 8.0))   # injected fault
        # pending adapter hot-loads land in this round: the DMA time is
        # part of both actual and expected latency (a swap is planned
        # work, not a straggler signal)
        load_s = self._adapter_load_s()
        if load_s > 0.0:
            lat += load_s
            expected += load_s
        round_start = self.t
        self.t += lat
        self.rounds += 1
        self.bs_accum += bs
        self.straggler.observe(lat, expected_s=expected)
        if self.sched is not None:
            self.sched.observe(lat)
        if self.colocate and k > 0:
            self.ft.advance(k, self.t)
        elif self.colocate:
            self.ft.pump_dma(self.t)
        if chunk_tokens > 0:
            self._apply_chunk(takes, round_start, self.t)
            self.chunk_timeline.append((round_start, chunk_tokens,
                                        self.chunk_budget))
        self.quantum_timeline.append((self.t, k, lat, bs))
        self.batch_timeline.append((self.t, bs))
        # ---- token bookkeeping ------------------------------------------
        self.alloc.pressure_shrink()
        self.alloc.kv_alloc_tokens(bs)
        done = []
        for r in self.active:
            r.token_times.append(self.t)
            r.generated += 1
            if r.generated >= r.max_new_tokens:
                r.finish = self.t
                done.append(r)
        for r in done:
            self.active.remove(r)
            self.alloc.kv_free_tokens(r.context_len)
        self._snap_ctr += 1
        if self._snap_ctr % sim.snapshot_every == 0:
            self.alloc.snapshot(self.t)
        return self.t

    def _adapter_load_s(self) -> float:
        """Perform queued adapter hot-loads now; seconds to charge to the
        current round (0.0 when adapter serving is off or nothing queued)."""
        if self.adapters is None:
            return 0.0
        return self.adapters.take_load_time(self._adapters_in_use())

    def _adapters_in_use(self) -> Set[int]:
        """Adapter ids pinned by in-flight requests — never evicted."""
        ids = {r.adapter_id for r in self.active if r.adapter_id >= 0}
        ids |= {req.adapter_id for _, _, req in self._pending
                if req.adapter_id >= 0}
        ids |= {req.adapter_id for _, _, req in self._chunk_pending
                if req.adapter_id >= 0}
        return ids

    def collect_tpot(self) -> None:
        """Fold per-token latencies of every routed request into the result
        buffer (call once, after the event loop ends)."""
        for r in self.all_reqs:
            self.result_tpot.extend(r.tpot_samples())

    def run(self, reqs: List[Request], ready_times: Dict[int, float],
            duration: float) -> None:
        """Original monolithic loop, as a wrapper over enqueue/step."""
        for r in reqs:
            self.enqueue(r, ready_times[r.rid])
        while self.t < duration:
            self.step(duration)
        self.collect_tpot()


# ------------------------------------------------------------- experiment
def fit_predictor(cfg_inf: ModelConfig, sim: SimConfig,
                  spec: InstanceSpec = InstanceSpec()):
    """Fit the harli two-stage predictor on cost-model samples of `spec`
    (at `sim.tp`), with the seed layout every experiment shares. Returns
    (predictor, fit_report); (None, None) for modes that don't schedule
    with it."""
    if sim.mode != "harli":
        return None, None
    predictor = TwoStageLatencyPredictor(k_max=sim.k_max)
    cm_fit = CostModel(cfg_inf, dataclasses.replace(spec, tp=sim.tp),
                       seed=sim.seed + 13)
    report = predictor.fit_from_costmodel(
        cm_fit, micro_batch=sim.micro_batch, ft_seq=sim.ft_seq)
    return predictor, report


def simulate(cfg_inf: ModelConfig, cfg_ft: ModelConfig,
             reqs: List[Request], sim: SimConfig,
             duration: Optional[float] = None,
             spec: InstanceSpec = InstanceSpec()) -> SimResult:
    """Replay `reqs` on instances of `spec` (chip and cost constants; its
    `tp` set from `sim.tp`) under `sim.mode`."""
    spec = dataclasses.replace(spec, tp=sim.tp)
    predictor, pred_report = fit_predictor(cfg_inf, sim, spec)

    if sim.mode == "separate":
        instances = [
            DecodeInstanceSim(0, cfg_inf, None, sim, None, sim.seed,
                              spec=spec),
            DecodeInstanceSim(1, cfg_ft, cfg_ft, sim, None, sim.seed + 1,
                              serves_inference=False, spec=spec),
        ]
        shares = [reqs, []]
    else:
        instances = [DecodeInstanceSim(i, cfg_inf, cfg_ft, sim, predictor,
                                       sim.seed + i, spec=spec)
                     for i in range(sim.n_decode_instances)]
        shares = [[] for _ in range(sim.n_decode_instances)]
        for idx, r in enumerate(sorted(reqs, key=lambda r: r.arrival)):
            shares[idx % sim.n_decode_instances].append(r)

    # one prefill instance per decode-serving instance (disaggregated pool
    # scales with decode capacity — paper §8.1 deploys PD-disaggregated)
    cm_prefill = CostModel(cfg_inf, spec, seed=sim.seed + 7)
    ready: Dict[int, float] = {}
    for share in shares:
        t_pref = 0.0
        for r in sorted(share, key=lambda r: r.arrival):
            t_pref = max(t_pref, r.arrival) + cm_prefill.prefill_latency(
                r.prompt_len)
            ready[r.rid] = t_pref
            r.prefill_done = t_pref
    duration = duration or (max(ready.values()) + 30.0 if ready else 30.0)

    for inst, share in zip(instances, shares):
        inst.run(share, ready, duration)

    res = SimResult(mode=sim.mode, duration=duration,
                    predictor_report=pred_report)
    minibatch = sim.micro_batch * sim.accum
    for inst in instances:
        if inst.ft is not None:
            res.ft_units_done += inst.ft.units_done
            res.ft_iterations += inst.ft.iterations
            res.ft_stall_rounds += inst.ft.stall_rounds
        res.tpot.extend(inst.result_tpot)
        res.decode_rounds += inst.rounds
        res.batch_timeline.extend(inst.batch_timeline)
        res.quantum_timeline = inst.quantum_timeline \
            if inst.colocate else res.quantum_timeline
        res.memory_timeline = inst.alloc.timeline \
            if inst.colocate else res.memory_timeline
    res.ft_throughput = res.ft_iterations / duration * minibatch
    res.completed = sum(1 for r in reqs if r.finish > 0)
    if res.tpot:
        viol = sum(1 for x in res.tpot if x > sim.qos_s * 1.05)
        res.qos_violation_frac = viol / len(res.tpot)
    if res.decode_rounds:
        res.mean_batch = sum(b for _, b in res.batch_timeline) \
            / max(len(res.batch_timeline), 1)
    return res
