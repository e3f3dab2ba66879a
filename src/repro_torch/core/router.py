"""Cluster-level routing plane: admission -> prefill stage -> decode stage.

Sits above the per-instance QoS machinery (scheduler/allocator/predictor)
and below the cluster event loop. The plane has two tiers, mirroring the
PD-disaggregated deployment the paper assumes (§8.1) and DistServe's
observation that prefill and decode must be scheduled independently:

  1. **Admission** — a request is accepted or rejected against global
     decode saturation (an instance past ``reject_load`` is skipped as long
     as any other can absorb; rejection fires only when none can), plus any
     extra backpressure the prefill placement adds (e.g. the pooled tier's
     queue bound).
  2. **Prefill stage** — owned by the ``PrefillPlacement`` policy object
     (core/api.py): ``chained`` serializes prefill per instance, ``pooled``
     runs the shared ``PrefillPool`` (core/prefill_pool.py), ``chunked``
     has no prefill tier at all (chunks ride decode rounds).
  3. **Decode stage** — the ``RoutingPolicy`` object picks one decode
     instance; the instance admits the request into decode rounds once its
     ``ready_time`` passes.

This module is **pure mechanism**: exactly-once dispatch accounting, the
hand-off path, conservation audit and goodput metrics. Every *decision* —
which instance, where prefill runs, when to scale — lives in a policy
class registered by name through ``repro_torch.core.api`` (built-ins in
``core/policies/``; ``RouterConfig.policy`` and the deployment mode are
registry lookups, so a new policy is a plugin, not a branch here). The
built-in routing policies and their semantics:

  * ``least_loaded``       — join-shortest-queue on the occupancy signal
  * ``round_robin`` / ``random``
  * ``predicted_latency``  — pick the instance with the lowest *predicted
    TPOT* from the fitted TwoStageLatencyPredictor, evaluated at the
    instance's current batch and finetune quantum (falls back to
    least_loaded when no predictor is fitted, e.g. separate mode)
  * ``session_affinity``   — ``Request.session_id`` maps to a sticky
    instance for prefix-cache reuse, overflowing (and remapping) to the
    least-loaded instance when the sticky one is past
    ``affinity_overflow_load``
  * ``cache_aware``        — route to whichever instance's ``PrefixCache``
    holds the longest matching prefix for the session, not just the sticky
    one (core/policies/cache_aware.py — the registry's worked example).
    Pays one synchronous cache peek per candidate per dispatch.
  * ``cache_aware_gossip`` — the fleet-scale variant: scores candidates
    from gossiped, staleness-bounded cache digests (core/gossip.py) with
    zero synchronous peeks on the dispatch path

Session prefix cache (core/prefix_cache.py): when the chosen instance holds
the request's session prefix, ``credit_prefix`` shortens the effective
prefill before any latency is charged. In pooled mode only *pinning*
policies benefit — the decode instance must be known *before* prefill
runs, so such a policy binds the instance at admission
(``RoutingPolicy.pin_for_prefill``) and the pin is honored at hand-off;
other policies choose at hand-off, after prefill already ran at full
length.

Conservation invariant (tested): every request handed to ``dispatch`` is
rejected, still in the prefill stage, or enqueued on exactly one decode
instance — never dropped, never duplicated.

The port's own copy of `repro/core/router.py` (plain Python and numpy; keep
the two in step), with its names, seeds and arithmetic. It prices prefills
with the cost model it is given (`ClusterSim` builds it on the instances'
`InstanceSpec`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import api
from repro_torch.core.adapters import AdapterRegistry
from repro_torch.core.api import PENDING, REJECTED  # noqa: F401  (legacy home)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.predictor import TwoStageLatencyPredictor
from repro_torch.core.prefill_pool import PrefillPool
from repro_torch.core.simulator import DecodeInstanceSim
from repro_torch.serving.request import Request


@dataclasses.dataclass
class RouterConfig:
    policy: str = "least_loaded"     # any registered routing policy name
    ttft_slo_s: float = 4.0          # prefill SLO (queue + prefill compute)
    tpot_slo_s: float = 0.040        # decode SLO, same target the QoS
    tpot_slack: float = 1.05         # scheduler enforces per round
    tpot_quantile: float = 0.99      # per-request attainment percentile
    reject_load: float = 4.0         # reject when every target's queue
    # exceeds reject_load x max_slots.
    # None = derive from the experiment seed (SimConfig.seed +
    # ROUTER_SEED_SALT in core/cluster.py); any int — including 0 — is an
    # explicit seed and is honored as-is
    seed: Optional[int] = None
    # session_affinity: the sticky instance absorbs its sessions until
    # its load passes this threshold, then the session remaps to the
    # least loaded instance (cache_aware does not use this knob — it
    # trades cache benefit against queue depth continuously)
    affinity_overflow_load: float = 1.0


@dataclasses.dataclass
class RoutedRequest:
    rid: int
    instance: int                    # -1 rejected, -2 in prefill stage
    arrival: float
    adapter_id: int = -1             # tenant adapter (-1 = base model)


@dataclasses.dataclass
class TenantStats:
    """Per-tenant slice of the goodput accounting (multi-LoRA serving):
    DistServe-style attainment evaluated against the tenant's own SLOs
    (Request.ttft_slo_s/tpot_slo_s overrides, else the router-wide
    targets). Keyed by adapter_id in ClusterStats.tenants."""
    offered: int = 0
    completed: int = 0
    attained: int = 0
    ttft_attainment: float = 0.0
    tpot_attainment: float = 0.0
    goodput: float = 0.0
    ttft_p99: float = 0.0
    tpot_p99: float = 0.0
    versions_served: int = 0         # distinct adapter versions completed


@dataclasses.dataclass
class ClusterStats:
    duration: float = 0.0
    offered: int = 0                 # requests presented to the router
    routed: int = 0
    rejected: int = 0
    dropped: int = 0                 # routed but could never fit (oversized)
    completed: int = 0
    attained: int = 0                # completed AND met both SLOs
    throughput: float = 0.0          # completed / duration
    goodput: float = 0.0             # attained / duration  (DistServe)
    slo_attainment: float = 0.0      # attained / offered
    ttft_attainment: float = 0.0
    tpot_attainment: float = 0.0
    ttft_p99: float = 0.0
    tpot_p99: float = 0.0
    # TTFT stage accounting (pool mode): queue wait, prefill compute and
    # decode-admission wait are separately visible, so an SLO miss can be
    # attributed to the tier that caused it
    ttft_queue_p99: float = 0.0      # arrival -> prefill start
    ttft_prefill_p99: float = 0.0    # prefill start -> prefill done
    ttft_decode_wait_p99: float = 0.0  # prefill done -> first decode token
    # degradation-ladder stage 3 (core/cluster.py DegradationConfig):
    # requests hard-rejected after exhausting their shed-backoff retries.
    # Counted inside ``rejected`` too — this field attributes the share
    shed_rejected: int = 0
    # per-tenant attainment (multi-LoRA serving, core/adapters.py);
    # empty unless the trace carries adapter ids
    tenants: Dict[int, TenantStats] = dataclasses.field(default_factory=dict)


def request_slo(r: Request, cfg: RouterConfig):
    """Per-request SLO verdict: (ttft_ok, tpot_ok, ttft, tpot_percentile).
    THE attainment definition — ClusterRouter.stats and every figure that
    plots goodput over time must agree on it, so it lives in one place.
    Only meaningful for completed requests (finish >= 0, tokens emitted).
    Per-tenant SLO overrides on the request take precedence over the
    router-wide targets (the slack multiplier applies either way)."""
    ttft = r.token_times[0] - r.arrival
    samples = r.tpot_samples()
    tpot_p = float(np.percentile(samples, cfg.tpot_quantile * 100)) \
        if samples else 0.0
    ttft_slo = cfg.ttft_slo_s if r.ttft_slo_s is None else r.ttft_slo_s
    tpot_slo = cfg.tpot_slo_s if r.tpot_slo_s is None else r.tpot_slo_s
    ttft_ok = ttft <= ttft_slo
    tpot_ok = tpot_p <= tpot_slo * cfg.tpot_slack
    return ttft_ok, tpot_ok, ttft, tpot_p


class ClusterRouter:
    """Two-stage dispatcher over a mutable fleet of DecodeInstanceSim.

    The fleet is shared with the cluster event loop and the autoscaler:
    instances may be added, put into draining, or have their role flipped
    between control periods; the router re-reads eligibility on every
    dispatch. The routing policy and the prefill placement are policy
    objects resolved through the registry; ``placement=None`` defaults to
    the ``chained`` placement (serialized per-instance prefill).
    """

    def __init__(self, cfg: RouterConfig, prefill_cm: CostModel,
                 predictor: Optional[TwoStageLatencyPredictor] = None,
                 placement: Optional[api.PrefillPlacement] = None,
                 adapter_policy: Optional[api.AdapterPlacement] = None,
                 adapter_registry: Optional[AdapterRegistry] = None):
        self.cfg = cfg
        self.prefill_cm = prefill_cm
        self.predictor = predictor
        self.policy: api.RoutingPolicy = \
            api.resolve_policy("routing", cfg.policy)(cfg)
        if placement is None:
            placement = api.resolve_policy("prefill", "chained")()
        self.placement = placement
        self.mode = placement.name
        # multi-LoRA serving (core/adapters.py): when set, adapter-carrying
        # requests are placed by the adapter_placement policy and stamped
        # with the registry's newest published version at dispatch
        self.adapter_policy = adapter_policy
        self.adapter_registry = adapter_registry
        # fleet-scale cache routing (core/gossip.py): the cluster layer
        # attaches the gossip plane when ``cluster.gossip`` is configured;
        # ``clock`` mirrors the simulation time of the last dispatch so
        # policies can age digests without a ``now`` parameter, and
        # ``dispatch_peeks`` counts synchronous cache probes made on the
        # dispatch path (cache_aware pays O(fleet) of them per request;
        # cache_aware_gossip must stay at zero — tested)
        self.gossip = None
        self.clock = 0.0
        self.dispatch_peeks = 0
        self.instances: Dict[int, DecodeInstanceSim] = {}
        self.retired: Dict[int, DecodeInstanceSim] = {}
        self.routed: List[RoutedRequest] = []
        self._routed_ix: Dict[int, RoutedRequest] = {}
        self._assigned: Dict[int, int] = {}         # rid -> instance id
        # survivability layer (core/cluster.py): rid -> forced decode
        # destination for partially-migrated requests (the KV tail already
        # lives there), and the ladder's hard-rejection counter
        self._forced: Dict[int, int] = {}
        self._shed_rejected = 0

    @property
    def pool(self) -> Optional[PrefillPool]:
        """The pooled placement's PrefillPool (None in other modes) —
        legacy accessor, kept for callers and the conservation audit."""
        return getattr(self.placement, "pool", None)

    # ------------------------------------------------------------ fleet --
    def add_instance(self, inst: DecodeInstanceSim, now: float = 0.0) -> None:
        assert inst.inst_id not in self.instances
        self.instances[inst.inst_id] = inst
        self.placement.on_add_instance(inst, now, self)

    def retire(self, inst_id: int) -> None:
        """Decommission a drained instance: it leaves the active fleet (no
        stepping, no finetune free-running) but stays visible to the final
        accounting — its served requests and finetune progress happened."""
        inst = self.instances.pop(inst_id)
        assert inst.drained, "retiring an instance that still holds work"
        self.placement.on_retire_instance(inst_id, self)
        self.retired[inst_id] = inst

    def kill_instance(self, inst_id: int) -> None:
        """Remove a failed instance from the fleet (cluster failure layer).
        Unlike ``retire`` there is no drained precondition — the caller
        already stripped its in-flight work via ``DecodeInstanceSim.kill``
        and is responsible for requeueing it. The carcass moves to
        ``retired`` so completed-request accounting, broken-pin prefix
        revocation and finetune progress bookkeeping keep working."""
        inst = self.instances.pop(inst_id)
        self.placement.on_retire_instance(inst_id, self)
        self.retired[inst_id] = inst

    def requeue_failed(self, reqs: List[Request], now: float,
                       tails: Optional[Dict[int, tuple]] = None) -> int:
        """Re-admit requests that lost their KV to an instance failure.
        Each request re-enters the normal placement path (re-prefill at
        full length — the cached context is gone) or is rejected when no
        surviving capacity can absorb it. Returns how many re-entered.

        ``tails`` maps rid -> (dest instance id, migrated tokens) for
        requests whose live KV migration lost the deadline race after a
        partial transfer: the request re-prefills only the unsent tail,
        forced onto the destination that already holds the sent prefix.

        The caller must already have detached the requests from the dead
        instance (``DecodeInstanceSim.kill``/``recall``), so deleting the
        stale assignment here keeps exactly-once accounting intact."""
        self.clock = max(self.clock, now)
        n = 0
        for req in sorted(reqs, key=lambda r: (r.arrival, r.rid)):
            rr = self._routed_ix[req.rid]
            del self._assigned[req.rid]
            req.reset_for_retry()
            tail = (tails or {}).get(req.rid)
            if tail is not None:
                dest = self.instances.get(tail[0])
                if dest is not None and dest.serves_inference \
                        and dest.role != "finetune" and not dest.draining:
                    # the partial KV survives on the destination: credit
                    # it and force decode placement there
                    req.migrated_tokens = tail[1]
                    self._forced[req.rid] = tail[0]
            cand = [i for i in self.serving_instances()
                    if i.load() <= self.cfg.reject_load]
            if not cand or self.placement.saturated(cand, self):
                self._forced.pop(req.rid, None)
                req.migrated_tokens = 0
                self._assigned[req.rid] = REJECTED
                rr.instance = REJECTED
                continue
            if self.pool is not None \
                    and self.pool.has_prefill_record(req.rid):
                # erase the lost prefill record so the pool accepts the
                # request again (the produced KV died with the host)
                self.pool.forget(req.rid)
            target = self.placement.place(req, now, cand, self)
            self._assigned[req.rid] = target
            rr.instance = target
            n += 1
        return n

    def migrate(self, req: Request, dest: DecodeInstanceSim, ready: float,
                kind: str) -> None:
        """Land a fully-migrated request on its destination: the KV
        transfer beat the preemption deadline, so at the kill the request
        re-enters the same stage it left — decoding/prefilled requests
        join the ready queue (admissible from ``ready``), mid-chunked-
        prefill ones keep their chunk progress and continue in the
        destination's rounds. The caller already stripped the request
        from the dead victim, so reassignment stays exactly-once."""
        if kind == "chunked":
            dest.enqueue_chunked(req, ready)
        else:
            dest.enqueue(req, ready)
        self._assigned[req.rid] = dest.inst_id
        self._routed_ix[req.rid].instance = dest.inst_id

    def reject_shed(self, req: Request) -> int:
        """Hard-reject a request the degradation ladder shed past its
        retry budget (or that was still backing off at trace end). The
        request was never dispatched — this is its one terminal record."""
        assert req.rid not in self._assigned, "request routed twice"
        self._assigned[req.rid] = REJECTED
        self._record(req, REJECTED)
        self._shed_rejected += 1
        return REJECTED

    def claim_forced(self, req: Request) -> Optional[DecodeInstanceSim]:
        """Pop and return the forced migration destination for ``req``
        (None if unforced). When the destination can no longer take
        traffic the partial-KV credit dies with it — the request falls
        back to full re-prefill wherever the policy sends it."""
        iid = self._forced.pop(req.rid, None)
        if iid is None:
            return None
        dest = self.instances.get(iid)
        if dest is not None and dest.serves_inference \
                and dest.role != "finetune" and not dest.draining:
            return dest
        req.migrated_tokens = 0
        return None

    def has_forced(self, rid: int) -> bool:
        """True while ``rid`` holds an unclaimed forced destination."""
        return rid in self._forced

    def recall_pending(self, rid: int) -> Optional[Request]:
        """Pull a not-yet-admitted request back from its decode instance
        (its pooled prefill worker died before the hand-off's ready time).
        Returns None when the request can't be recalled — e.g. its own
        instance was killed earlier this epoch and it is already back in
        the queue."""
        iid = self._assigned.get(rid, REJECTED)
        inst = self.instances.get(iid) or self.retired.get(iid)
        if inst is None:
            return None
        return inst.recall(rid)

    def all_instances(self) -> List[DecodeInstanceSim]:
        """Active + retired, for end-of-run accounting."""
        return list(self.instances.values()) + list(self.retired.values())

    def serving_instances(self) -> List[DecodeInstanceSim]:
        """Instances eligible for new inference traffic."""
        return [i for i in self.instances.values()
                if i.serves_inference and i.role != "finetune"
                and not i.draining]

    # --------------------------------------------------------- dispatch --
    def credit_prefix(self, inst: DecodeInstanceSim, req: Request) -> None:
        """Consult the chosen instance's prefix cache and shorten the
        request's effective prefill by the cached prefix. Must run before
        any prefill latency is charged. The lookup is bounded by the
        tokens still needing prefill (prompt minus migrated KV) so a
        cache hit is never double-credited on top of a migration credit
        — ``effective_prompt_len`` stays >= 1 by construction."""
        if inst.prefix_cache is not None and req.session_id >= 0:
            avail = req.prompt_len - req.migrated_tokens
            req.cache_hit_tokens = inst.prefix_cache.lookup(
                req.session_id, avail, segments=req.prefix_segments)

    def dispatch(self, req: Request, now: float) -> int:
        """Admit one request and hand it to the prefill placement.
        Returns the decode instance id, PENDING (-2) when the request
        entered a prefill stage, or REJECTED (-1) under global
        saturation. Exactly-once by construction."""
        assert req.rid not in self._assigned, "request routed twice"
        self.clock = max(self.clock, now)
        if self.adapter_registry is not None and req.adapter_id >= 0:
            # continuous deployment: serve whatever version the finetune
            # side has published by now (static baselines only ever see
            # the version published at t=0)
            req.adapter_version = self.adapter_registry.latest(
                req.adapter_id)
        # admission rejects only under GLOBAL saturation: an instance past
        # reject_load is skipped as long as any other can still absorb;
        # the placement may add its own tier's backpressure on top
        cand = [i for i in self.serving_instances()
                if i.load() <= self.cfg.reject_load]
        if not cand or self.placement.saturated(cand, self):
            self._assigned[req.rid] = REJECTED
            self._record(req, REJECTED)
            return REJECTED
        target = self.placement.place(req, now, cand, self)
        self._assigned[req.rid] = target
        self._record(req, target)
        return target

    def _record(self, req: Request, instance: int) -> None:
        rr = RoutedRequest(req.rid, instance, req.arrival, req.adapter_id)
        self.routed.append(rr)
        self._routed_ix[req.rid] = rr

    def pick_decode(self, cand: List[DecodeInstanceSim],
                    req: Request) -> DecodeInstanceSim:
        """Decode-instance choice: the adapter placement policy for
        adapter-carrying requests when multi-LoRA serving is on, else the
        routing policy. Placements call this instead of ``policy.pick``
        so adapter awareness needs no per-mode branches."""
        if self.adapter_policy is not None and req is not None \
                and req.adapter_id >= 0:
            return self.adapter_policy.pick(cand, req, self)
        return self.policy.pick(cand, req, self)

    def pump_prefill(self, until: float) -> int:
        """Advance the prefill stage to ``until`` and hand every completed
        prefill to a decode instance chosen by the routing policy (at
        hand-off time, so the decision sees current fleet state). Returns
        the number of requests handed to the decode stage."""
        self.clock = max(self.clock, until)
        return self.placement.pump(until, self)

    def dispatch_decode(self, req: Request, ready: float) -> int:
        """Decode-stage placement of a prefilled request. Placement always
        succeeds (the request already paid its prefill): saturated
        candidates are preferred in policy order, then any serving
        instance, then any inference-capable one (draining included)."""
        cand = [i for i in self.serving_instances()
                if i.load() <= self.cfg.reject_load]
        if not cand:
            cand = self.serving_instances()
        if not cand:
            cand = [i for i in self.instances.values()
                    if i.serves_inference and i.role != "finetune"]
        assert cand, "no inference-capable instance left in the fleet"
        inst = self.claim_forced(req)
        pin = self.policy.claim_pin(req)
        if inst is not None:
            # partial-migration tail: the sent KV prefix lives on the
            # forced destination, which outranks any admission-time pin
            pin = None
        if pin is not None:
            # instance pinned at admission (its prefix-cache credit already
            # shortened the prefill): honor the pin while the instance can
            # still take traffic; fall back to the policy if it left
            pinned = self.instances.get(pin)
            if pinned is not None and pinned.serves_inference \
                    and pinned.role != "finetune" and not pinned.draining:
                inst = pinned
            elif req.cache_hit_tokens > 0:
                # pin broken mid-prefill (retired / flipped / draining):
                # the shortened prefill already ran and can't be re-costed,
                # but the hit must not count as a cache win — un-credit it
                # on the cache that granted it
                granter = self.instances.get(pin) or self.retired.get(pin)
                if granter is not None and granter.prefix_cache is not None:
                    granter.prefix_cache.revoke(req.cache_hit_tokens)
                req.cache_hit_tokens = 0
        if inst is None:
            inst = self.pick_decode(cand, req)
        inst.enqueue(req, ready)
        self._assigned[req.rid] = inst.inst_id
        self._routed_ix[req.rid].instance = inst.inst_id
        return inst.inst_id

    # ---------------------------------------------------------- metrics --
    def recent_chunk_wait_p99(self, now: float) -> float:
        """Fleet-wide p99 of recent chunked-prefill waits (arrival ->
        prefill-done) — the TTFT-headroom signal the autoscaler's
        chunk-budget loop reads in chunked mode. Per-instance windows are
        merged by pooling the recent samples."""
        samples: List[float] = []
        for inst in self.instances.values():
            samples.extend(inst.recent_chunk_waits(now))
        if not samples:
            return 0.0
        return float(np.percentile(samples, 99))

    def recent_violation_frac(self, window: int = 200) -> float:
        """Fraction of the fleet's last `window` decode-round TPOT samples
        over the SLO — the autoscaler's QoS-headroom signal. Samples are
        merged fleet-wide by time and capped at `window` total (a
        per-instance slice would over-sample big fleets)."""
        samples: List[tuple] = []
        for inst in self.instances.values():
            # per-instance tail is a superset of its share of the fleet tail
            for t, _, lat, bs in inst.quantum_timeline[-window:]:
                if bs > 0:
                    samples.append((t, lat))
        if not samples:
            return 0.0
        samples.sort()
        recent = samples[-window:]
        lim = self.cfg.tpot_slo_s * self.cfg.tpot_slack
        return sum(1 for _, lat in recent if lat > lim) / len(recent)

    def recent_slo_violation_frac(self, window: int = 50) -> float:
        """Fraction of the last `window` COMPLETED requests that missed
        their SLO (TTFT or TPOT, per request_slo) — the degradation
        ladder's overload signal (core/cluster.py). Request-level on
        purpose: the QoS scheduler keeps decode ROUNDS under the TPOT
        budget by construction, so under overload and churn it is TTFT
        queueing that degrades first, and only completed requests carry
        that verdict."""
        done: List[tuple] = []
        for inst in self.all_instances():
            for r in inst.all_reqs:
                if r.finish >= 0 and r.token_times:
                    done.append((r.finish, r.rid, r))
        if not done:
            return 0.0
        done.sort()
        recent = done[-window:]
        bad = 0
        for _, _, r in recent:
            ttft_ok, tpot_ok, _, _ = request_slo(r, self.cfg)
            if not (ttft_ok and tpot_ok):
                bad += 1
        return bad / len(recent)

    def stats(self, duration: float) -> ClusterStats:
        """Cluster goodput accounting over every request the router saw."""
        cfg = self.cfg
        st = ClusterStats(duration=duration, offered=len(self.routed),
                          dropped=sum(i.dropped
                                      for i in self.all_instances()),
                          shed_rejected=self._shed_rejected)
        ttfts: List[float] = []
        tpots: List[float] = []
        stage_q: List[float] = []
        stage_p: List[float] = []
        stage_d: List[float] = []
        reqs: Dict[int, Request] = {}
        for inst in self.all_instances():
            for r in inst.all_reqs:
                reqs[r.rid] = r
        # per-tenant accumulators (adapter-carrying traffic only)
        tn_ttfts: Dict[int, List[float]] = {}
        tn_tpots: Dict[int, List[float]] = {}
        tn_vers: Dict[int, Set[int]] = {}
        for rr in self.routed:
            tn = None
            if rr.adapter_id >= 0:
                tn = st.tenants.setdefault(rr.adapter_id, TenantStats())
                tn.offered += 1
            if rr.instance == REJECTED:
                st.rejected += 1
                continue
            st.routed += 1
            r = reqs.get(rr.rid)
            if r is None or r.finish < 0 or not r.token_times:
                continue
            st.completed += 1
            ttft_ok, tpot_ok, ttft, tpot_p = request_slo(r, cfg)
            ttfts.append(ttft)
            tpots.append(tpot_p)
            if tn is not None:
                tn.completed += 1
                tn.ttft_attainment += ttft_ok
                tn.tpot_attainment += tpot_ok
                tn.attained += ttft_ok and tpot_ok
                tn_ttfts.setdefault(rr.adapter_id, []).append(ttft)
                tn_tpots.setdefault(rr.adapter_id, []).append(tpot_p)
                tn_vers.setdefault(rr.adapter_id, set()).add(
                    r.adapter_version)
            if r.prefill_start >= 0 and r.restarts == 0:
                # went through the pool; restarted requests are excluded —
                # their re-prefill timestamps postdate the first token, so
                # the stage split is meaningless for them
                stage_q.append(r.prefill_start - r.arrival)
                stage_p.append(r.prefill_done - r.prefill_start)
                stage_d.append(r.token_times[0] - r.prefill_done)
            st.ttft_attainment += ttft_ok
            st.tpot_attainment += tpot_ok
            if ttft_ok and tpot_ok:
                st.attained += 1
        if duration > 0:
            st.throughput = st.completed / duration
            st.goodput = st.attained / duration
        if st.offered:
            st.slo_attainment = st.attained / st.offered
        if st.completed:
            st.ttft_attainment /= st.completed
            st.tpot_attainment /= st.completed
        if ttfts:
            st.ttft_p99 = float(np.percentile(ttfts, 99))
        if tpots:
            st.tpot_p99 = float(np.percentile(tpots, 99))
        if stage_q:
            st.ttft_queue_p99 = float(np.percentile(stage_q, 99))
            st.ttft_prefill_p99 = float(np.percentile(stage_p, 99))
            st.ttft_decode_wait_p99 = float(np.percentile(stage_d, 99))
        for aid, tn in st.tenants.items():
            if tn.completed:
                tn.ttft_attainment /= tn.completed
                tn.tpot_attainment /= tn.completed
            if duration > 0:
                tn.goodput = tn.attained / duration
            if tn_ttfts.get(aid):
                tn.ttft_p99 = float(np.percentile(tn_ttfts[aid], 99))
                tn.tpot_p99 = float(np.percentile(tn_tpots[aid], 99))
            tn.versions_served = len(tn_vers.get(aid, ()))
        return st

    def check_conservation(self) -> None:
        """Every offered request rejected, still in the prefill stage, or
        enqueued on exactly one decode instance; every enqueued request
        traces back to exactly one dispatch."""
        seen = [rr.rid for rr in self.routed]
        assert len(seen) == len(set(seen)), "request dispatched twice"
        enq: Dict[int, int] = {}
        for inst in self.all_instances():
            for r in inst.all_reqs:
                assert r.rid not in enq, "request on two instances"
                enq[r.rid] = inst.inst_id
        pending = 0
        for rr in self.routed:
            if rr.instance == REJECTED:
                assert rr.rid not in enq, "rejected request was enqueued"
            elif rr.instance == PENDING:
                assert rr.rid not in enq, "pending request was enqueued"
                pending += 1
            else:
                assert enq.get(rr.rid) == rr.instance, "assignment mismatch"
        assert len(enq) == sum(1 for rr in self.routed if rr.instance >= 0)
        if self.pool is not None:
            assert pending == self.pool.queue_depth, \
                "prefill-stage count disagrees with the pool queue"
            self.pool.check_conservation()
        else:
            assert pending == 0
