"""Built-in decode-routing policies (see core/router.py module docs for
the semantics each one guarantees).

Every policy owns its decision state — the RNG (``random``), the cursor
(``round_robin``), the sticky-session map and pooled-mode admission pins
(``session_affinity``) — so ``ClusterRouter`` holds none of it and a new
policy is a registered class, not a branch in the dispatch path.

The port's own copy of `repro/core/policies/routing.py` (plain Python and
numpy; keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.api import RoutingPolicy, register_policy


def least_loaded(cand: List):
    """Join-shortest-queue on the occupancy signal; ties broken by
    instance id for determinism. Shared fallback for every policy."""
    return min(cand, key=lambda i: (i.load(), i.inst_id))


@register_policy("least_loaded")
class LeastLoadedRouting(RoutingPolicy):
    def pick(self, cand, req, router):
        return least_loaded(cand)


@register_policy("round_robin")
class RoundRobinRouting(RoutingPolicy):
    def __init__(self, cfg):
        super().__init__(cfg)
        self._cursor = 0

    def pick(self, cand, req, router):
        pick = cand[self._cursor % len(cand)]
        self._cursor += 1
        return pick


@register_policy("random")
class RandomRouting(RoutingPolicy):
    def __init__(self, cfg):
        super().__init__(cfg)
        # cfg.seed None means "unseeded config" (the cluster layer derives
        # one before building the router); a bare ClusterRouter must still
        # be deterministic, so fall back to 0 rather than OS entropy
        self._rng = np.random.default_rng(
            0 if cfg.seed is None else cfg.seed)

    def pick(self, cand, req, router):
        return cand[int(self._rng.integers(len(cand)))]


@register_policy("predicted_latency")
class PredictedLatencyRouting(RoutingPolicy):
    """Lowest *predicted TPOT* from the fitted TwoStageLatencyPredictor
    at the instance's current batch and finetune quantum, plus a
    slot-overflow wait term; least_loaded fallback when no predictor is
    fitted (e.g. separate mode)."""

    def pick(self, cand, req, router):
        if router.predictor is None or req is None:
            return least_loaded(cand)
        return min(cand, key=lambda i: (self._delay(i, req, router),
                                        i.inst_id))

    @staticmethod
    def _tpot(inst, req, router) -> float:
        """Predicted decode-round latency (== TPOT) on `inst` with `req`
        added, at the instance's current batch and finetune quantum."""
        bs = min(inst.queue_depth + 1, inst.sim.max_slots)
        if inst.active:
            ctx = sum(r.context_len for r in inst.active) / len(inst.active)
        else:
            ctx = float(req.prompt_len)
        q_ft = 0.0
        if inst.role == "colocated" and inst.quantum_timeline:
            q_ft = inst.quantum_timeline[-1][1] / max(inst.sim.k_max, 1)
        return router.predictor.predict_colo(q_ft, bs, ctx)

    def _delay(self, inst, req, router) -> float:
        """Routing score: predicted TPOT, plus the admission wait the
        request would pay when the instance's queue spills past its slot
        budget. Decode is memory-bound, so TPOT alone is nearly flat in
        batch size — without the wait term a saturated instance looks as
        cheap as an idle one and the policy piles onto it."""
        tpot = self._tpot(inst, req, router)
        slots = max(inst.sim.max_slots, 1)
        excess = inst.queue_depth + 1 - slots
        if excess <= 0:
            return tpot
        # each slot-budget overflow "wave" waits a full request residency
        # (remaining tokens at this round's predicted TPOT)
        rem = [r.max_new_tokens - r.generated for r in inst.active]
        mean_rem = (sum(rem) / len(rem)) if rem else req.max_new_tokens
        waves = math.ceil(excess / slots)
        return tpot * (1.0 + waves * max(mean_rem, 1.0))


@register_policy("session_affinity")
class SessionAffinityRouting(RoutingPolicy):
    """``Request.session_id`` maps to a sticky instance for prefix-cache
    reuse, overflowing (and remapping) to the least-loaded instance when
    the sticky one is past ``affinity_overflow_load``. In pooled mode
    the sticky instance is pinned at admission so its cache credit can
    shorten the prefill, and the pin is honored at hand-off."""

    needs_sessions = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self._session_map: Dict[int, int] = {}      # session -> sticky inst
        self._pinned: Dict[int, int] = {}           # rid -> pre-bound inst

    def pick(self, cand, req, router):
        if req is not None and req.session_id >= 0:
            sticky = self._session_map.get(req.session_id)
            if sticky is not None:
                inst = router.instances.get(sticky)
                if inst is not None and inst in cand and \
                        inst.load() <= self.cfg.affinity_overflow_load:
                    return inst
            # first touch, sticky gone, or overflow: remap the session to
            # the least-loaded instance (the prefix cache moves with it)
            pick = least_loaded(cand)
            self._session_map[req.session_id] = pick.inst_id
            return pick
        return least_loaded(cand)

    def pin_for_prefill(self, cand, req, router):
        if req.session_id < 0:
            return None
        inst = self.pick(cand, req, router)
        self._pinned[req.rid] = inst.inst_id
        return inst

    def claim_pin(self, req) -> Optional[int]:
        return self._pinned.pop(req.rid, None)
