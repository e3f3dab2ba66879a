"""Cluster simulation: two-tier routing plane + autoscaler over stepped
decode instances.

Composes the pieces into one discrete-event experiment:

  * a trace of requests arrives at the cluster front door;
  * ClusterRouter (core/router.py) admits each request (or rejects it
    under saturation) into the configured prefill placement;
  * completed prefills are handed to one decode instance chosen by the
    registered routing policy (core/policies/routing.py + plugins);
  * every DecodeInstanceSim advances on a shared clock via its step() API;
  * the Autoscaler (core/autoscaler.py) runs two coordinated control loops
    every interval: the decode loop grows/shrinks the fleet or flips roles
    between decode-only, co-located and finetune-dedicated; the prefill
    loop is owned by the placement (pool sizing in pooled mode, chunk-
    budget tuning in chunked mode, idle in chained mode).

This module is **mechanism**: the shared clock, arrival dispatch, epoch
stepping, drain/retire lifecycle, decision application and result
accounting. Everything mode-specific lives in the ``PrefillPlacement``
policy object (core/policies/placement.py) resolved by name from
``ClusterConfig.prefill_mode`` — ``chained`` is the per-instance
serialized prefill chain (the measurable baseline, also selected by
``prefill=None``); ``pooled`` is the disaggregated pool; ``chunked``
mixes prefill chunks into the decode instances' own rounds (docs/
cluster.md). ``ClusterConfig.prefix_cache`` additionally gives every
serving instance a session prefix cache (core/prefix_cache.py) so
cache-aware routing shortens effective prefill on hits.

``ClusterConfig.instance_overrides`` is the heterogeneous-fleet hook:
entry *i* overrides ``SimConfig`` fields (tp, max_slots, qos_s, ...) for
the *i*-th spawned instance, so a fleet can mix hardware shapes in one
experiment (``ExperimentSpec`` validates the keys).

Modes mirror the single-instance experiment (paper §8.1) at fleet scale:
  harli    — every serving instance co-locates a finetune job, dynamic
             quantum, roles under autoscaler control
  separate — serving instances are decode-only; one dedicated finetune
             instance free-runs (same total fleet size as harli, except
             n_initial=1 where separate floors at 1 decode + 1 finetune
             instance — MORE hardware than harli's single instance, so
             the comparison is conservative against harli there)

The port's own copy of `repro/core/cluster.py` (plain Python and numpy;
keep the two in step), with the reference's arithmetic, salts
(`ROUTER_SEED_SALT`, `SHED_SEED_SALT`), heap tie-breaks and RNG draws. One
seam is added, as in `core/simulator.py`: the reference prices every
instance with `InstanceSpec(tp=sim.tp)`, a TPU v5e group with its
constants; here `ClusterSim` and `simulate_cluster` take the instances'
`InstanceSpec` (by default one H100 with the constants fitted on the card,
`H100_CONSTANTS`), and every pricing (the predictor's fit, the router's and
the prefill pool's cost models, adapter loads, checkpoint commits, each
spawned instance) takes it with `tp` from the `SimConfig` it prices: an
instance's own, after `instance_overrides`. So a spec's `tp` counts the
chips of `spec.chip` an instance spans. On the reference's v5e spec every
field of `ClusterResult` equals the reference's
(`tests/test_torch_cluster.py`).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import api
from repro_torch.core.adapters import (AdapterRegistry,
                                       AdapterServingConfig,
                                       InstanceAdapterConfig, adapter_bytes)
from repro_torch.core.allocator import BLOCK_BYTES
from repro_torch.core.autoscaler import (Autoscaler, AutoscalerConfig,
                                         InstanceSnapshot, ScaleDecision)
from repro_torch.core.costmodel import CostModel, InstanceSpec
from repro_torch.core.gossip import GossipConfig, GossipPlane
from repro_torch.core.prefill_pool import PrefillPoolConfig
from repro_torch.core.prefix_cache import PrefixCacheConfig
from repro_torch.core.router import (ClusterRouter, ClusterStats,
                                     RouterConfig)
from repro_torch.core.simulator import (ChunkedPrefillConfig,
                                        DecodeInstanceSim,
                                        FinetuneCheckpointer, SimConfig,
                                        fit_predictor)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.request import Request
from repro_torch.serving.trace import FailureConfig, FailureSchedule

ROUTER_SEED_SALT = 17        # RouterConfig.seed derives from SimConfig.seed
SHED_SEED_SALT = 53987       # backoff-jitter stream (DegradationConfig.seed)


@dataclasses.dataclass(frozen=True)
class KVMigrationConfig:
    """Live KV migration on a preemption warning (survivability layer).

    When an instance receives a spot-style notice (``FailureConfig.
    warning_s > 0``), the cluster streams each victim request's KV to a
    peer over the interconnect, racing the deadline kill: transfers that
    finish in time land the request on the destination with its context
    intact; losers fall back to the re-prefill path — partially,
    when some prefix tokens made it across before the kill."""

    # victim egress interconnect bandwidth (the serialized link every
    # transfer shares). Typical datacenter ICI/NVLink-over-fabric ballpark
    bw_gbps: float = 8.0
    setup_s: float = 0.005           # per-request transfer handshake
    # registered migration destination policy (core/policies/migration.py)
    policy: str = "kv_headroom"

    @property
    def bw_bytes(self) -> float:
        return self.bw_gbps * 1e9


@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Overload degradation ladder, escalated one deterministic step per
    epoch off the fleet's recent request-level SLO-violation fraction
    (``ClusterRouter.recent_slo_violation_frac``):

      level 1 — fleet-wide finetune circuit breaker: every colocated
                quantum yields to inference (``DecodeInstanceSim.
                ft_breaker``) until the violation fraction recovers;
      level 2 — admission-control load shedding: arrivals re-enter after
                a seeded jittered exponential backoff (priced into TTFT
                via ``Request.retries``), hard-rejected past the cap.

    De-escalation steps down one level per epoch once the violation
    fraction drops under ``resume_viol_frac``. Thresholds are calibrated
    against the request-level signal: a healthy loaded fleet sits well
    above zero (churn requeues and TTFT tails count), so the breaker
    arms at a clear excursion and shedding only at near-collapse."""

    breaker_viol_frac: float = 0.35  # escalate 0 -> 1 at this violation frac
    shed_viol_frac: float = 0.70     # escalate 1 -> 2
    resume_viol_frac: float = 0.15   # de-escalate one level below this
    shed: bool = True                # enable level 2 at all
    backoff_base_s: float = 1.0      # first retry delay
    backoff_mult: float = 2.0        # exponential growth per retry
    backoff_jitter: float = 0.25     # uniform +/- fraction, own RNG stream
    max_retries: int = 3             # then hard rejection (shed_rejected)
    # None = derive from the experiment seed (SimConfig.seed + SHED_SEED_
    # SALT); any int — including 0 — is explicit and honored as-is
    seed: Optional[int] = None


@dataclasses.dataclass
class ClusterConfig:
    n_initial: int = 2               # serving fleet size at t=0
    tick_s: float = 1.0              # event-loop / dispatch epoch
    autoscale: bool = True
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    autoscaler: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig)
    # deployment mode: any registered prefill placement ("chained" |
    # "pooled" | "chunked" built in). None (default) derives it from
    # `prefill` for backward compatibility: a pool config means "pooled",
    # prefill=None means the per-instance chain ("chained")
    prefill_mode: Optional[str] = None
    # prefill tier: None = legacy per-instance prefill chain
    prefill: Optional[PrefillPoolConfig] = dataclasses.field(
        default_factory=PrefillPoolConfig)
    # chunked-mode knobs (per-round token budget + autoscaler range)
    chunked: ChunkedPrefillConfig = dataclasses.field(
        default_factory=ChunkedPrefillConfig)
    # per-instance session prefix cache; None = cache-less
    prefix_cache: Optional[PrefixCacheConfig] = None
    # asynchronous cache-summary gossip plane (core/gossip.py): each
    # instance's prefix tree publishes staleness-bounded digests the
    # cache_aware_gossip policy routes on. None (default) = no plane,
    # bit-identical to the gossip-less behaviour
    gossip: Optional[GossipConfig] = None
    # heterogeneous-fleet hook: entry i replaces SimConfig fields for the
    # i-th spawned instance (by spawn order; autoscaler spawns past the
    # list use the base SimConfig). Keys are validated by ExperimentSpec.
    instance_overrides: Tuple[Dict, ...] = ()
    # failure/preemption injection (serving/trace.py): seeded Poisson
    # instance kills, optional spot-style warnings, finetune checkpoint
    # cadence. None (default) = stable fleet, bit-identical to the
    # pre-failure-layer behaviour
    failures: Optional[FailureConfig] = None
    # live KV migration on preemption warnings; None (default) = warned
    # instances drain in place and their remnants re-prefill
    migration: Optional[KVMigrationConfig] = None
    # overload degradation ladder (finetune breaker -> load shedding ->
    # hard rejection); None (default) = no ladder
    degradation: Optional[DegradationConfig] = None
    # multi-LoRA adapter serving (core/adapters.py): colocated finetune
    # jobs publish versioned adapters the fleet hot-loads on demand.
    # None (default) = off, bit-identical to the adapter-less sim
    adapters: Optional[AdapterServingConfig] = None

    def resolved_mode(self) -> str:
        mode = self.prefill_mode
        if mode is None:
            mode = "pooled" if self.prefill is not None else "chained"
        api.resolve_policy("prefill", mode)    # raises on unknown names
        return mode


@dataclasses.dataclass
class ClusterResult:
    mode: str
    stats: ClusterStats
    ft_iterations: float = 0.0
    ft_throughput: float = 0.0       # iterations/s x minibatch (paper §8.2)
    ft_stall_rounds: int = 0
    qos_violation_frac: float = 0.0  # across all decode TPOT samples
    tpot: List[float] = dataclasses.field(default_factory=list)
    fleet_timeline: List[Tuple[float, int, int]] = dataclasses.field(
        default_factory=list)        # (t, serving, colocated)
    prefill_timeline: List[Tuple[float, int, int]] = dataclasses.field(
        default_factory=list)        # (t, active workers, queue depth)
    decisions: List[ScaleDecision] = dataclasses.field(default_factory=list)
    # hardware counts: ALL live instances, including separate mode's
    # dedicated finetune one — comparable across modes
    final_fleet: int = 0
    peak_fleet: int = 0
    final_prefill: int = 0
    peak_prefill: int = 0
    # chunked mode: the per-round budget's control trajectory
    chunk_budget_timeline: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)
    final_chunk_budget: int = 0
    # session prefix cache, aggregated over the fleet
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_hit_tokens: int = 0
    # cross-session sharing + gossip plane (ClusterConfig.gossip)
    prefix_shared_hit_tokens: int = 0  # hit tokens from cross-session reuse
    dispatch_peeks: int = 0          # synchronous cache probes at dispatch
    gossip_published: int = 0        # digests published fleet-wide
    gossip_bytes: int = 0            # total digest wire bytes
    gossip_stale_discards: int = 0   # reads refused past the staleness bound
    gossip_max_used_age: float = 0.0  # oldest digest age actually acted on
    # failure layer (ClusterConfig.failures)
    failures: int = 0                # hard kills applied (instances+workers)
    preemptions: int = 0             # graceful-drain warnings issued
    requeued_requests: int = 0       # in-flight requests re-routed off kills
    requeue_rejected: int = 0        # lost requests no survivor could absorb
    ft_lost_iterations: float = 0.0  # finetune progress rolled back by kills
    checkpoint_commits: int = 0
    # survivability layer (ClusterConfig.migration / .degradation)
    migrated_requests: int = 0       # KV transfers that beat the deadline
    migration_reprefills: int = 0    # warned-instance remnants requeued
    migrated_kv_tokens: int = 0      # KV tokens shipped (full + partial)
    shed_requests: int = 0           # ladder level-2 backoff events
    shed_rejected: int = 0           # shed past max_retries (hard rejects)
    breaker_epochs: int = 0          # epochs at ladder level >= 1
    shed_epochs: int = 0             # epochs at ladder level >= 2
    ladder_peak: int = 0             # highest ladder level reached
    # multi-LoRA adapter serving (ClusterConfig.adapters)
    adapter_loads: int = 0           # hot-loads performed fleet-wide
    adapter_evictions: int = 0       # residency evictions/swaps
    adapter_load_failures: int = 0   # loads that fell back to base model
    adapter_load_time_s: float = 0.0  # total DMA seconds charged to rounds
    adapter_versions_published: int = 0  # registry publish events
    adapter_versions_served: int = 0  # distinct (tenant, version) completed


class ClusterSim:
    """Owns the fleet, the shared clock and the prefill placement; applies
    both autoscaler control loops' decisions."""

    def __init__(self, cfg_inf: ModelConfig, cfg_ft: ModelConfig,
                 sim: SimConfig, cluster: ClusterConfig,
                 spec: InstanceSpec = InstanceSpec()):
        self.cfg_inf = cfg_inf
        self.cfg_ft = cfg_ft
        self.sim = sim
        self.cluster = cluster
        # the instances' chip and cost constants; each pricing sets its tp
        self.spec = spec
        spec = dataclasses.replace(spec, tp=sim.tp)
        self.predictor, _ = fit_predictor(cfg_inf, sim, spec)
        # thread the experiment seed into the router (like the CostModel
        # seed): an explicit RouterConfig.seed — including 0 — wins, the
        # None default derives
        rcfg = cluster.router
        if rcfg.seed is None:
            rcfg = dataclasses.replace(
                rcfg, seed=sim.seed + ROUTER_SEED_SALT)
        self.router_cfg = rcfg
        self.mode = cluster.resolved_mode()
        placement_cls = api.resolve_policy("prefill", self.mode)
        self.placement: api.PrefillPlacement = placement_cls.build(self)
        # ---- multi-LoRA adapter serving (ClusterConfig.adapters) --------
        acfg = cluster.adapters
        self.adapter_registry: Optional[AdapterRegistry] = None
        self._adapter_inst_cfg: Optional[InstanceAdapterConfig] = None
        self._adapter_ids: List[int] = []
        adapter_policy = None
        if acfg is not None:
            self.adapter_registry = AdapterRegistry()
            a_bytes = adapter_bytes(cfg_ft, acfg.rank)
            # chunk geometry matches every serving instance's allocator
            # (same cfg_inf): ceil the adapter into whole chunks so its
            # charge competes honestly with KV admission
            chunk_bytes = cfg_inf.num_layers * 2 * BLOCK_BYTES
            self._adapter_inst_cfg = InstanceAdapterConfig(
                chunks=max(math.ceil(a_bytes / chunk_bytes), 1),
                load_time_s=CostModel(cfg_inf, spec).adapter_load_time(
                    a_bytes),
                max_loaded=acfg.max_loaded)
            adapter_policy = api.resolve_policy(
                "adapter_placement", acfg.policy)(rcfg)
        self.router = ClusterRouter(
            rcfg, CostModel(cfg_inf, spec, seed=sim.seed + 7),
            predictor=self.predictor, placement=self.placement,
            adapter_policy=adapter_policy,
            adapter_registry=self.adapter_registry)
        # ---- cache-summary gossip plane (ClusterConfig.gossip) ----------
        self.gossip_plane: Optional[GossipPlane] = None
        self._next_gossip_pub: Dict[int, float] = {}
        if cluster.gossip is not None:
            self.gossip_plane = GossipPlane(cluster.gossip)
            self.router.gossip = self.gossip_plane
        self.autoscaler = Autoscaler(cluster.autoscaler)
        self.autoscaler.prefill_ttft_slo_s = rcfg.ttft_slo_s
        self._next_id = 0
        self._fleet_timeline: List[Tuple[float, int, int]] = []
        self._peak_total = 0
        # ---- failure layer (ClusterConfig.failures) ---------------------
        f = cluster.failures
        self._ckpt_interval = f.checkpoint_interval_s if f is not None \
            else 0.0
        self._ckpt_dir: Optional[Path] = None
        self._ckpt_time_s = 0.0
        if self._ckpt_interval > 0:
            if f.checkpoint_dir is not None:
                self._ckpt_dir = Path(f.checkpoint_dir)
            else:
                self._ckpt_tmp = tempfile.TemporaryDirectory(
                    prefix="repro_ckpt_")
                self._ckpt_dir = Path(self._ckpt_tmp.name)
            self._ckpt_time_s = CostModel(cfg_ft, spec).checkpoint_time()
        self._pending_kills: List[Tuple[float, int]] = []  # (deadline, iid)
        self._failures = 0
        self._preemptions = 0
        self._requeued = 0
        self._requeue_rejected = 0
        self._ft_lost_iterations = 0.0
        # ---- survivability layer (migration + degradation ladder) -------
        mig = cluster.migration
        self._migration_on = mig is not None and mig.bw_gbps > 0
        self._mig_policy: Optional[api.MigrationPolicy] = None
        if self._migration_on:
            self._mig_policy = api.resolve_policy(
                "migration", mig.policy)()
        # rid -> (dest inst id, tokens shipped, transfer-complete?); filled
        # at the preemption warning, consumed at the deadline kill. Stale
        # entries for requests that finish during the drain window are
        # harmless — rids are never reused
        self._mig_plan: Dict[int, Tuple[int, int, bool]] = {}
        self._migrated = 0
        self._migration_reprefills = 0
        self._migrated_tokens = 0
        deg = cluster.degradation
        self._ladder_level = 0
        self._ladder_peak = 0
        self._breaker_epochs = 0
        self._shed_epochs = 0
        self._shed = 0
        self._retry_heap: List[Tuple[float, int, Request]] = []
        self._shed_rng = None
        if deg is not None:
            # own jitter stream: creating it only when the ladder exists
            # keeps the deg=None path bit-identical to the ladder-less one
            self._shed_rng = np.random.default_rng(
                deg.seed if deg.seed is not None
                else sim.seed + SHED_SEED_SALT)
        if sim.mode == "separate":
            for _ in range(max(cluster.n_initial - 1, 1)):
                self._spawn(0.0, role="decode", colocate=False)
            self._spawn(0.0, role="finetune", serves_inference=False)
        else:
            for _ in range(cluster.n_initial):
                self._spawn(0.0, role="colocated")

    # ------------------------------------------------------------ fleet --
    def _spawn(self, t: float, role: str, colocate: bool = True,
               serves_inference: bool = True) -> DecodeInstanceSim:
        sim = self.sim
        overrides = self.cluster.instance_overrides
        if self._next_id < len(overrides) and overrides[self._next_id]:
            sim = dataclasses.replace(sim, **overrides[self._next_id])
        ckpt = None
        if colocate and self._ckpt_interval > 0:
            # failure injection is on: the finetune job commits progress
            # periodically so a kill rolls back to the last commit
            ckpt = FinetuneCheckpointer(
                self._ckpt_dir / f"inst_{self._next_id}",
                interval_s=self._ckpt_interval,
                commit_time_s=self._ckpt_time_s, t0=t)
        inst = DecodeInstanceSim(
            self._next_id, self.cfg_inf if serves_inference else self.cfg_ft,
            self.cfg_ft if colocate else None, sim,
            self.predictor, self.sim.seed + self._next_id,
            serves_inference=serves_inference, t0=t, role=role,
            prefix_cache=self.cluster.prefix_cache, ckpt=ckpt,
            adapters=self._adapter_inst_cfg, spec=self.spec,
            **self.placement.spawn_kwargs(self, serves_inference))
        # a joiner during an active breaker epoch inherits the pause
        inst.ft_breaker = self._ladder_level >= 1
        self._next_id += 1
        self.router.add_instance(inst, now=t)
        return inst

    def _serving(self) -> List[DecodeInstanceSim]:
        return self.router.serving_instances()

    def _snapshots(self) -> List[InstanceSnapshot]:
        return [InstanceSnapshot(
            inst_id=i.inst_id, role=i.role, load=i.load(),
            active=len(i.active), colocatable=i.colocate,
            can_serve=i.serves_inference, draining=i.draining)
            for i in self.router.instances.values()]

    def _ft_backlog(self, t: float) -> float:
        """Finetune demand minus progress, in iterations. With no explicit
        target, a dedicated/colocated job is treated as always-hungry."""
        target = self.cluster.autoscaler.ft_target_iters_per_s
        done = sum(i.ft.iterations for i in self.router.all_instances()
                   if i.ft is not None)
        if target <= 0:
            return 1.0               # best-effort: backlog never empties
        return max(target * t - done, 0.0)

    def apply_decision(self, d: ScaleDecision, t: float) -> None:
        """Apply one decode-loop decision (also called by placements that
        escalate to fleet growth, e.g. chunked-budget maxed)."""
        insts = self.router.instances
        if d.action == "add_instance":
            role = "colocated" if self.sim.mode == "harli" else "decode"
            self._spawn(t, role=role, colocate=self.sim.mode == "harli")
            self.placement.on_scale_up(self, t)
        elif d.action == "remove_instance":
            inst = insts.get(d.target)
            # guard at application time too: never drain below the floor
            n_serving = len(self._serving())
            if inst is not None and not inst.draining \
                    and n_serving > self.cluster.autoscaler.min_decode:
                inst.draining = True
        elif d.action == "to_decode":
            inst = insts.get(d.target)
            if inst is not None and inst.role == "colocated":
                inst.set_role("decode")
        elif d.action == "to_colocated":
            inst = insts.get(d.target)
            if inst is not None and inst.colocate and inst.serves_inference:
                inst.set_role("colocated")
        elif d.action == "to_finetune":
            inst = insts.get(d.target)
            if inst is not None and inst.colocate \
                    and len(self._serving()) > \
                    self.cluster.autoscaler.min_decode:
                inst.set_role("finetune")

    # ------------------------------------------------------------- loop --
    def run(self, reqs: List[Request],
            duration: Optional[float] = None) -> ClusterResult:
        cl = self.cluster
        pending = sorted(reqs, key=lambda r: (r.arrival, r.rid))
        if duration is None:
            last = max((r.arrival for r in reqs), default=0.0)
            duration = last + 30.0
        t, qi = 0.0, 0
        next_control = cl.autoscaler.interval_s
        failsched = FailureSchedule(cl.failures, duration) \
            if cl.failures is not None else None
        if self.adapter_registry is not None:
            # every tenant ships a v1 adapter at t=0 (both the continuous
            # and the static arm serve adapters from the start; only the
            # finetune->publish stream below differs)
            self._adapter_ids = sorted({r.adapter_id for r in reqs
                                        if r.adapter_id >= 0})
            for aid in self._adapter_ids:
                self.adapter_registry.publish(aid, 1, 0.0)
        while t < duration:
            epoch_end = min(t + cl.tick_s, duration)
            qi = self._dispatch_arrivals(pending, qi, epoch_end)
            # prefill stage first: completions in this epoch reach their
            # decode instance before it steps through the epoch
            self.router.pump_prefill(epoch_end)
            for inst in list(self.router.instances.values()):
                while inst.t < epoch_end:
                    inst.step(epoch_end)
                if inst.drained:
                    self.router.retire(inst.inst_id)
            self.placement.retire(self, epoch_end)
            if self.gossip_plane is not None:
                self._gossip_tick(epoch_end)
            if self.adapter_registry is not None \
                    and cl.adapters.continuous:
                self._publish_tick(epoch_end)
            if failsched is not None:
                # kills land after the epoch's stepping and BEFORE the
                # control slot: the autoscaler's decode loop sees the
                # shrunken snapshot the same epoch and replaces capacity
                self._apply_failures(failsched, epoch_end)
            if cl.degradation is not None:
                # ladder after failures, before the control slot: the
                # autoscaler and the breaker react to the same signal in
                # the same epoch (the ladder is faster — no cooldown)
                self._ladder_tick(epoch_end)
            if cl.autoscale and epoch_end + 1e-9 >= next_control:
                viol = self.router.recent_violation_frac()
                d = self.autoscaler.evaluate(
                    epoch_end, self._snapshots(), viol,
                    self._ft_backlog(epoch_end))
                self.apply_decision(d, epoch_end)
                # the placement's own control slot (pool sizing / chunk-
                # budget tuning / idle in chained mode)
                self.placement.control(self, epoch_end, viol)
                # re-sync the deadline past this epoch instead of a single
                # increment: with interval_s < tick_s the old += fell
                # unboundedly behind the clock (one evaluation per epoch
                # either way, so decision logs stay bit-identical)
                if cl.autoscaler.interval_s > 0:
                    while next_control <= epoch_end + 1e-9:
                        next_control += cl.autoscaler.interval_s
            t = epoch_end
            self._fleet_point(t, self._serving())
        # requests still backing off at trace end never dispatched: record
        # them as hard-rejected so offered-request accounting stays honest
        for _, _, req in sorted(self._retry_heap):
            self.router.reject_shed(req)
        self._retry_heap = []
        self.router.check_conservation()
        return self._result(duration)

    def _gossip_tick(self, t: float) -> None:
        """Gossip pump: each serving instance with a prefix cache
        publishes a fresh digest when its per-instance period elapses
        (first publish on the first epoch after spawn). Iteration is in
        instance-id order, so the plane's state — and every routing
        decision read from it — is deterministic per seed."""
        plane = self.gossip_plane
        period = plane.cfg.period_s
        for iid in sorted(self.router.instances):
            inst = self.router.instances[iid]
            if inst.prefix_cache is None or not inst.serves_inference \
                    or inst.role == "finetune":
                continue
            due = self._next_gossip_pub.get(iid, 0.0)
            if t + 1e-9 >= due:
                plane.publish(iid, t, inst.prefix_cache.tree)
                self._next_gossip_pub[iid] = t + period

    def _publish_tick(self, t: float) -> None:
        """Continuous deployment: the fleet's finetune iterations train
        the tenants' adapters round-robin; every ``publish_every_iters``
        per-tenant iterations a new version lands in the registry (and is
        served by every dispatch from the next epoch on). Idempotent —
        ``publish`` ignores non-increasing versions."""
        if not self._adapter_ids:
            return
        total = sum(i.ft.iterations for i in self.router.all_instances()
                    if i.ft is not None)
        per_tenant = total / len(self._adapter_ids)
        ver = 1 + int(per_tenant
                      / self.cluster.adapters.publish_every_iters)
        for aid in self._adapter_ids:
            self.adapter_registry.publish(aid, ver, t)

    def _dispatch_arrivals(self, pending: List[Request], qi: int,
                           epoch_end: float) -> int:
        """Offer this epoch's traffic to the router in time order: fresh
        arrivals merged with shed requests whose backoff elapsed (arrival
        wins ties). At ladder level 2 the shed gate replaces dispatch.
        With no degradation ladder this reduces exactly to the plain
        arrival scan (the retry heap stays empty)."""
        deg = self.cluster.degradation
        while True:
            t_arr = pending[qi].arrival if qi < len(pending) else None
            t_re = self._retry_heap[0][0] if self._retry_heap else None
            if t_arr is not None and (t_re is None or t_arr <= t_re):
                if t_arr > epoch_end:
                    break
                req, now = pending[qi], t_arr
                qi += 1
            elif t_re is not None:
                if t_re > epoch_end:
                    break
                now, _, req = heapq.heappop(self._retry_heap)
            else:
                break
            if deg is not None and deg.shed and self._ladder_level >= 2:
                self._shed_request(req, now, deg)
            else:
                self.router.dispatch(req, now)
        return qi

    def _shed_request(self, req: Request, now: float,
                      deg: DegradationConfig) -> None:
        """Ladder level 2: push the request back with seeded jittered
        exponential backoff; past the retry cap it is hard-rejected. The
        backoff lands in TTFT — the request's arrival stays its original
        arrival, so the wait is priced, not hidden."""
        req.retries += 1
        if req.retries > deg.max_retries:
            self.router.reject_shed(req)
            return
        backoff = deg.backoff_base_s \
            * deg.backoff_mult ** (req.retries - 1)
        if deg.backoff_jitter > 0:
            backoff *= 1.0 + deg.backoff_jitter \
                * float(self._shed_rng.uniform(-1.0, 1.0))
        heapq.heappush(self._retry_heap, (now + backoff, req.rid, req))
        self._shed += 1

    def _ladder_tick(self, now: float) -> None:
        """One deterministic ladder step per epoch off the fleet's recent
        request-level SLO-violation fraction: escalate 0 -> 1 (finetune
        breaker) -> 2 (load shedding), de-escalate one level once the
        signal recovers. Request-level, not round-level: the QoS decode
        scheduler keeps rounds under the TPOT budget by construction, so
        overload shows up as TTFT misses on completed requests."""
        deg = self.cluster.degradation
        viol = self.router.recent_slo_violation_frac()
        lvl = self._ladder_level
        if lvl > 0 and viol <= deg.resume_viol_frac:
            lvl -= 1
        elif lvl == 0 and viol >= deg.breaker_viol_frac:
            lvl = 1
        elif lvl == 1 and deg.shed and viol >= deg.shed_viol_frac:
            lvl = 2
        if lvl != self._ladder_level:
            self._ladder_level = lvl
            for inst in self.router.instances.values():
                inst.ft_breaker = lvl >= 1
        self._ladder_peak = max(self._ladder_peak, lvl)
        if lvl >= 1:
            self._breaker_epochs += 1
        if lvl >= 2:
            self._shed_epochs += 1

    # -------------------------------------------------------- failures --
    def _victim_candidates(self) -> List[Tuple[str, int]]:
        """Eligible kill victims, deterministically ordered: live instances
        (not already under a preemption notice) and, in pooled mode, active
        prefill workers. The last inference-capable instance is protected —
        a fleet with zero decode capacity has no defined hand-off target
        (real clusters would stall, not crash; the simulator skips the
        event instead)."""
        insts = [i for i in self.router.instances.values()
                 if i.preempt_deadline < 0]
        serving = {i.inst_id for i in insts
                   if i.serves_inference and i.role != "finetune"
                   and not i.draining}
        capable = {i.inst_id for i in insts
                   if i.serves_inference and i.role != "finetune"}
        protected = set()
        if len(serving) <= 1:
            protected |= serving
        if len(capable) <= 1:
            protected |= capable
        out: List[Tuple[str, int]] = [
            ("inst", i.inst_id) for i in insts
            if i.inst_id not in protected]
        pool = self.router.pool
        if pool is not None:
            out += [("worker", w.wid) for w in pool.active_workers()]
        out.sort()
        return out

    def _apply_failures(self, sched: FailureSchedule, now: float) -> None:
        """Consume the schedule's events due this epoch: hard kills, or
        preemption notices (warning_s > 0) whose deadline kill fires in a
        later epoch unless the victim drained first."""
        cfg = self.cluster.failures
        due = [pk for pk in self._pending_kills if pk[0] <= now + 1e-9]
        self._pending_kills = [pk for pk in self._pending_kills
                               if pk[0] > now + 1e-9]
        for deadline, iid in sorted(due):
            inst = self.router.instances.get(iid)
            if inst is None:
                continue             # drained and retired before deadline
            capable = [i for i in self.router.instances.values()
                       if i.serves_inference and i.role != "finetune"]
            if inst.serves_inference and inst.role != "finetune" \
                    and len(capable) <= 1:
                # the notice elapsed but no replacement capacity exists
                # yet: the stay-of-execution defers the kill one epoch —
                # the fleet never loses its last inference-capable host
                self._pending_kills.append(
                    (now + self.cluster.tick_s, iid))
                continue
            self._kill_instance(iid, now)
        for tk in sched.pop_due(now):
            cand = self._victim_candidates()
            if not cand:
                continue
            kind, vid = sched.pick(cand)
            if kind == "worker":
                self._kill_pool_worker(vid, now)
            elif cfg.warning_s > 0:
                inst = self.router.instances[vid]
                deadline = tk + cfg.warning_s
                inst.begin_preempt(deadline)
                self._pending_kills.append((deadline, vid))
                self._preemptions += 1
                if self._migration_on:
                    self._migrate_victim(inst, now, deadline)
            else:
                self._kill_instance(vid, now)
        # separate mode: a killed dedicated finetune instance is replaced
        # by the training job's own scheduler (the autoscaler's decode
        # loop only replaces serving capacity); the job restarts from its
        # last checkpoint on the fresh host
        if self.sim.mode == "separate" and not any(
                i.ft is not None
                for i in self.router.instances.values()):
            self._spawn(now, role="finetune", serves_inference=False)

    def _migrate_victim(self, victim: DecodeInstanceSim, now: float,
                        deadline: float) -> None:
        """Plan the live (pre-copy) KV migration off a warned instance.
        The victim keeps serving until the deadline while its in-flight
        KV streams to the peers the migration policy picks, serialized on
        the victim's egress link smallest-context-first (maximizing how
        many transfers win the race). Nothing moves yet — a request that
        finishes during the drain window never needed to move, and KV
        grown during the window rides the pre-copy delta stream. At the
        deadline ``_kill_instance`` executes the plan: requests whose
        transfer completed resume on their destination without
        re-prefill; the first transfer that cannot finish consumes the
        link to the deadline and ships what fits as a partial tail (the
        destination re-prefills only the unsent remainder); everything
        behind it falls back to the re-prefill path."""
        mig = self.cluster.migration
        cand = [i for i in self.router.serving_instances()
                if i.inst_id != victim.inst_id]
        if not cand:
            return                   # no peer: drain in place
        cm = self.router.prefill_cm
        bpt = self.cfg_inf.cache_bytes_per_token()

        def kv_tokens(req: Request, kind: str) -> int:
            # resident KV on the victim: full context for decoding /
            # prefill-complete requests, chunk progress (+ cached prefix)
            # for mid-chunked-prefill ones
            if kind == "chunked":
                return req.cache_hit_tokens + req.prefilled_tokens
            return req.context_len

        items = victim.migratable()
        items.sort(key=lambda it: (kv_tokens(it[0], it[1]), it[0].rid))
        t_link = now
        for req, kind, ready in items:
            toks = kv_tokens(req, kind)
            # a pending request's KV only exists once its prefill lands
            start = max(t_link, ready) if kind == "pending" else t_link
            xfer = cm.kv_migration_time(toks, mig.bw_bytes, mig.setup_s)
            # destination picked at plan time; in-flight transfers are
            # not yet resident, so planning does not feed back into the
            # policy's headroom signal
            dest = self._mig_policy.pick_dest(req, cand, self.router)
            if start + xfer <= deadline:
                t_link = start + xfer
                self._mig_plan[req.rid] = (dest.inst_id, toks, True)
                continue
            # loser: ship what the link can push before the kill as a
            # partial tail; the request drains in place and is requeued
            # (tail-credited) at the deadline
            window = deadline - start - mig.setup_s
            sent = min(int(window * mig.bw_bytes / bpt), toks) \
                if window > 0 else 0
            if sent > 0:
                self._mig_plan[req.rid] = (dest.inst_id, sent, False)
            break                    # the link is consumed to the deadline

    def _kill_instance(self, iid: int, now: float) -> None:
        """Hard-kill one instance: strip its in-flight work, remove it
        from the fleet, and execute the migration plan over whatever is
        still in flight — a completed transfer resumes on its destination
        in the stage it left (no re-prefill, the kill -> re-admit gap is
        priced into its token timeline); a partial transfer re-prefills
        only its unsent tail on the destination; everything else
        re-enters through the router at full length."""
        inst = self.router.instances[iid]
        warned = inst.preempt_deadline >= 0
        # stage snapshot before the kill strips the queues: the plan's
        # kind may be stale (a chunked prefill can finish into pending/
        # active during the drain window)
        kinds = {req.rid: kind for req, kind, _ in inst.migratable()} \
            if warned and self._migration_on else {}
        lost, ft_lost = inst.kill(now)
        self._ft_lost_iterations += ft_lost
        self.router.kill_instance(iid)
        if self.gossip_plane is not None:
            # the dead cache's advertisement must not keep attracting
            # traffic until the staleness bound expires
            self.gossip_plane.drop(iid)
            self._next_gossip_pub.pop(iid, None)
        self._failures += 1
        if not lost:
            return
        remnants: List[Request] = []
        tails: Dict[int, Tuple[int, int]] = {}
        for r in sorted(lost, key=lambda q: q.rid):
            plan = self._mig_plan.pop(r.rid, None)
            if plan is not None and plan[2]:
                dest = self.router.instances.get(plan[0])
                if dest is not None and dest.serves_inference \
                        and dest.role != "finetune" and not dest.draining:
                    self.router.migrate(r, dest, now,
                                        kinds.get(r.rid, "active"))
                    self._migrated += 1
                    self._migrated_tokens += plan[1]
                    continue
                plan = None   # the copy's host died too: full re-prefill
            if plan is not None and plan[1] > 0:
                tails[r.rid] = (plan[0], plan[1])
                self._migrated_tokens += plan[1]
            remnants.append(r)
        if remnants:
            if self._migration_on and warned:
                self._migration_reprefills += len(remnants)
            n = self.router.requeue_failed(remnants, now, tails=tails)
            self._requeued += n
            self._requeue_rejected += len(remnants) - n

    def _kill_pool_worker(self, wid: int, now: float) -> None:
        """Kill one pooled prefill worker: the batch it was running dies
        with it, so those requests are recalled from the decode instances
        awaiting them and resubmitted to the (cluster-wide) queue."""
        pool = self.router.pool
        batch_rids = pool.kill_worker(wid, now)
        self._failures += 1
        reqs = []
        for rid in batch_rids:
            req = self.router.recall_pending(rid)
            if req is not None:
                reqs.append(req)
        if reqs:
            n = self.router.requeue_failed(reqs, now)
            self._requeued += n
            self._requeue_rejected += len(reqs) - n

    def _fleet_point(self, t: float, serving) -> None:
        self._fleet_timeline.append(
            (t, len(serving),
             sum(1 for i in serving if i.role == "colocated")))
        self._peak_total = max(self._peak_total,
                               len(self.router.instances))
        self.placement.record_timeline(self, t)

    def _result(self, duration: float) -> ClusterResult:
        for inst in self.router.all_instances():
            inst.collect_tpot()
        res = ClusterResult(mode=self.sim.mode,
                            stats=self.router.stats(duration))
        minibatch = self.sim.micro_batch * self.sim.accum
        for inst in self.router.all_instances():
            if inst.ft is not None:
                res.ft_iterations += inst.ft.iterations
                res.ft_stall_rounds += inst.ft.stall_rounds
            res.tpot.extend(inst.result_tpot)
        res.ft_throughput = res.ft_iterations / duration * minibatch
        if res.tpot:
            # same limit the router's per-request TPOT attainment uses
            rcfg = self.router.cfg
            lim = rcfg.tpot_slo_s * rcfg.tpot_slack
            res.qos_violation_frac = \
                sum(1 for x in res.tpot if x > lim) / len(res.tpot)
        res.fleet_timeline = self._fleet_timeline
        res.decisions = self.autoscaler.decisions
        res.failures = self._failures
        res.preemptions = self._preemptions
        res.requeued_requests = self._requeued
        res.requeue_rejected = self._requeue_rejected
        res.ft_lost_iterations = self._ft_lost_iterations
        res.migrated_requests = self._migrated
        res.migration_reprefills = self._migration_reprefills
        res.migrated_kv_tokens = self._migrated_tokens
        res.shed_requests = self._shed
        res.shed_rejected = res.stats.shed_rejected
        res.breaker_epochs = self._breaker_epochs
        res.shed_epochs = self._shed_epochs
        res.ladder_peak = self._ladder_peak
        res.checkpoint_commits = sum(
            i.ckpt.commits for i in self.router.all_instances()
            if i.ckpt is not None)
        res.final_fleet = len(self.router.instances)
        res.peak_fleet = max(self._peak_total, res.final_fleet)
        self.placement.finalize(self, res)
        for inst in self.router.all_instances():
            if inst.prefix_cache is not None:
                res.prefix_hits += inst.prefix_cache.stats.hits
                res.prefix_misses += inst.prefix_cache.stats.misses
                res.prefix_hit_tokens += inst.prefix_cache.stats.hit_tokens
                res.prefix_shared_hit_tokens += \
                    inst.prefix_cache.stats.shared_hit_tokens
            if inst.adapters is not None:
                res.adapter_loads += inst.adapters.loads
                res.adapter_evictions += inst.adapters.evictions
                res.adapter_load_failures += inst.adapters.load_failures
                res.adapter_load_time_s += inst.adapters.load_time_total_s
        res.dispatch_peeks = self.router.dispatch_peeks
        if self.gossip_plane is not None:
            res.gossip_published = self.gossip_plane.published
            res.gossip_bytes = self.gossip_plane.bytes_published
            res.gossip_stale_discards = self.gossip_plane.stale_discards
            res.gossip_max_used_age = self.gossip_plane.max_used_age
        if self.adapter_registry is not None:
            res.adapter_versions_published = \
                self.adapter_registry.versions_published
            res.adapter_versions_served = sum(
                tn.versions_served for tn in res.stats.tenants.values())
        return res


def simulate_cluster(cfg_inf: ModelConfig, cfg_ft: ModelConfig,
                     reqs: List[Request], sim: SimConfig,
                     cluster: Optional[ClusterConfig] = None,
                     duration: Optional[float] = None,
                     spec: InstanceSpec = InstanceSpec()) -> ClusterResult:
    """One seeded cluster experiment (deterministic for a fixed seed) on
    instances of `spec` (chip and cost constants; each instance's `tp`
    from its `SimConfig`)."""
    cs = ClusterSim(cfg_inf, cfg_ft, sim, cluster or ClusterConfig(), spec)
    return cs.run(reqs, duration)
