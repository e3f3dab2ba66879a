"""Built-in prefill placements — the three deployment modes
(docs/cluster.md "Three deployment modes") as self-contained policy
objects.

Each placement owns everything mode-specific that used to be spread over
``router.py`` and ``cluster.py`` branches: the per-instance chain clocks
(``chained``), the shared ``PrefillPool`` + its peak/timeline accounting
(``pooled``), and the fleet-wide chunk budget + its control trajectory
(``chunked``). ``ClusterRouter`` and ``ClusterSim`` call the placement
through the ``PrefillPlacement`` interface (core/api.py) and never
branch on the mode string again.

The port's own copy of `repro/core/policies/placement.py` (plain Python and
numpy; keep the two in step), with its names, seeds and arithmetic. The
pooled tier's cost model is built on the cluster's `InstanceSpec`
(`cs.spec`) at the `SimConfig`'s tp.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.api import PENDING, PrefillPlacement, register_policy
from repro_torch.core.costmodel import CostModel
from repro_torch.core.prefill_pool import PrefillPool, PrefillPoolConfig
from repro_torch.core.simulator import ChunkedPrefillConfig


@register_policy("chained")
class ChainedPlacement(PrefillPlacement):
    """The measurable baseline: prefill serialized on a per-instance
    partner chain; the chosen decode instance's chain runs the prefill,
    then decode admission takes over."""

    def __init__(self):
        self._free: Dict[int, float] = {}           # inst id -> chain clock

    def on_add_instance(self, inst, now, router) -> None:
        self._free[inst.inst_id] = now

    def on_retire_instance(self, inst_id, router) -> None:
        self._free.pop(inst_id, None)

    def place(self, req, now, cand, router) -> int:
        # a partially-migrated request must land where its KV tail lives;
        # the shortened effective_prompt_len prices the tail re-prefill
        inst = router.claim_forced(req)
        if inst is None:
            inst = router.pick_decode(cand, req)
            router.credit_prefix(inst, req)
        t_start = max(self._free.get(inst.inst_id, now), req.arrival, now)
        ready = t_start + router.prefill_cm.prefill_latency(
            req.effective_prompt_len)
        self._free[inst.inst_id] = ready
        req.prefill_done = ready
        inst.enqueue(req, ready)
        return inst.inst_id


@register_policy("pooled")
class PooledPlacement(PrefillPlacement):
    """Disaggregated prefill tier (core/prefill_pool.py): admission
    submits into the shared EDF queue, ``pump`` hands completed prefills
    to the decode stage, and the cluster-side hooks size the pool with
    the ``pooled_prefill`` scaling policy, keep its floor coordinated
    with decode scale-ups, and account its timeline/peaks."""

    def __init__(self, pool: PrefillPool):
        self.pool = pool
        self._peak = len(pool.workers)
        self._timeline: List[Tuple[float, int, int]] = []

    @classmethod
    def build(cls, cs) -> "PooledPlacement":
        pool = PrefillPool(
            cs.cluster.prefill or PrefillPoolConfig(),
            CostModel(cs.cfg_inf, dataclasses.replace(cs.spec, tp=cs.sim.tp),
                      seed=cs.sim.seed + 7),
            ttft_slo_s=cs.router_cfg.ttft_slo_s)
        return cls(pool)

    # ---- router side ----
    def saturated(self, cand, router) -> bool:
        # prefill-tier backpressure: in pool mode decode load() only rises
        # after prefill, so saturation must also be read off the pool
        # queue — the same per-instance bound reject_load puts on a decode
        # queue, summed fleet-wide (summing keeps the limit correct when
        # instance_overrides make slot budgets heterogeneous; identical to
        # max_slots * n_serving on a uniform fleet)
        limit = router.cfg.reject_load \
            * sum(i.sim.max_slots for i in router.serving_instances())
        return self.pool.queue_depth >= limit

    def place(self, req, now, cand, router) -> int:
        # the cache can only shorten prefill if the decode target is known
        # BEFORE the pool runs it: a pinning policy (session_affinity,
        # cache_aware) binds the instance now and the pin is honored at
        # hand-off; non-pinning policies choose at hand-off time
        # a partially-migrated request is already bound to the instance
        # holding its KV tail (router._forced, honored at hand-off) — an
        # admission pin would fight the forced destination
        if not router.has_forced(req.rid):
            pin = router.policy.pin_for_prefill(cand, req, router)
            if pin is not None:
                router.credit_prefix(pin, req)
        self.pool.submit(req, now)
        return PENDING

    def pump(self, until, router) -> int:
        handed = 0
        for req, ready in self.pool.pump(until):
            router.dispatch_decode(req, ready)
            handed += 1
        return handed

    # ---- cluster side ----
    def on_scale_up(self, cs, t) -> None:
        # coordinated scaling: a decode scale-up pulls the prefill pool
        # to its floor immediately (the legacy chain got this for free —
        # every instance carried a chain), instead of waiting a tick
        from repro_torch.core.autoscaler import ScaleDecision
        floor = cs.autoscaler.prefill_floor(
            len(cs.router.serving_instances()))
        while len(self.pool.active_workers()) < floor:
            self.pool.add_worker(t)
            cs.autoscaler.decisions.append(ScaleDecision(
                t, "add_prefill", reason="coordinated scale-up"))
        self._peak = max(self._peak, len(self.pool.active_workers()))

    def control(self, cs, t, viol_frac) -> None:
        d = cs.autoscaler.evaluate_prefill(
            t, self.pool.snapshot(t),
            n_serving=len(cs.router.serving_instances()))
        if d.action == "add_prefill":
            self.pool.add_worker(t)
            self._peak = max(self._peak, len(self.pool.active_workers()))
        elif d.action == "remove_prefill":
            # guard at application time: never drain below the hard floor
            self.pool.drain_worker(
                min_workers=max(cs.cluster.autoscaler.min_prefill, 1))

    def retire(self, cs, t) -> None:
        self.pool.retire_drained(t)

    def record_timeline(self, cs, t) -> None:
        n_active = len(self.pool.active_workers())
        self._timeline.append((t, n_active, self.pool.queue_depth))
        self._peak = max(self._peak, n_active)

    def finalize(self, cs, res) -> None:
        res.prefill_timeline = self._timeline
        res.final_prefill = len(self.pool.active_workers())
        res.peak_prefill = max(self._peak, res.final_prefill)


@register_policy("chunked")
class ChunkedPlacement(PrefillPlacement):
    """No prefill tier at all: the request is placed on a decode instance
    at admission and that instance runs its prefill in chunks mixed into
    decode rounds (``DecodeInstanceSim.enqueue_chunked``) under a
    QoS-priced per-round token budget. The placement owns the fleet-wide
    budget: the ``chunked_budget`` scaling policy tunes it, spawns
    inherit the current value, and its trajectory lands in
    ``ClusterResult.chunk_budget_timeline``."""

    def __init__(self, cfg: ChunkedPrefillConfig = None):
        self.cfg = cfg or ChunkedPrefillConfig()
        # the initial budget must already sit inside the control loop's
        # operating range, or the AIMD tuner starts out of bounds
        self.budget = int(min(max(self.cfg.budget_tokens,
                                  self.cfg.min_budget), self.cfg.max_budget))
        self._timeline: List[Tuple[float, int]] = []

    @classmethod
    def build(cls, cs) -> "ChunkedPlacement":
        return cls(cs.cluster.chunked)

    # ---- router side ----
    def place(self, req, now, cand, router) -> int:
        # the instance itself chunks the prefill into its decode rounds;
        # load()/queue_depth include the chunk queue so admission
        # backpressure keeps working
        inst = router.claim_forced(req)
        if inst is None:
            inst = router.pick_decode(cand, req)
            router.credit_prefix(inst, req)
        inst.enqueue_chunked(req, now)
        return inst.inst_id

    # ---- cluster side ----
    def spawn_kwargs(self, cs, serves_inference) -> Dict:
        if not serves_inference:
            return {}
        # a late joiner starts at the fleet's CURRENT budget, not t=0's
        return {"chunked": dataclasses.replace(
            self.cfg, budget_tokens=self.budget)}

    def control(self, cs, t, viol_frac) -> None:
        # mode-aware prefill loop: no pool to size — tune the per-round
        # chunk budget against TTFT headroom, and escalate to fleet
        # growth once the budget is maxed
        d = cs.autoscaler.evaluate_chunked(
            t, cs.router.recent_chunk_wait_p99(t), viol_frac,
            self.budget, self.cfg.min_budget, self.cfg.max_budget,
            n_serving=len(cs.router.serving_instances()))
        if d.action == "add_instance":
            cs.apply_decision(d, t)
        elif d.action in ("grow_chunk_budget", "shrink_chunk_budget"):
            # fleet-wide budget change (the decision's target carries the
            # new budget); future spawns inherit it via spawn_kwargs
            self.budget = int(min(max(d.target, self.cfg.min_budget),
                                  self.cfg.max_budget))
            for inst in cs.router.instances.values():
                if inst.chunked is not None:
                    inst.chunk_budget = self.budget

    def record_timeline(self, cs, t) -> None:
        self._timeline.append((t, self.budget))

    def finalize(self, cs, res) -> None:
        res.chunk_budget_timeline = self._timeline
        res.final_chunk_budget = self.budget
