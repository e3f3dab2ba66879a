"""``cache_aware`` routing: cross-instance prefix-cache-aware placement.

The ROADMAP open item this closes: ``session_affinity`` is *sticky* — it
remembers where a session was sent, not where its KV actually lives, and
its only load control is a hard overflow cliff (past
``affinity_overflow_load`` the session remaps to the least-loaded
instance and the warm cache is abandoned for good). The two notions
diverge exactly when placement matters most: after an overflow remap,
after a drain/retire or role flip invalidates the sticky entry, and
whenever several instances hold partial prefixes of different lengths.

This policy consults the caches themselves: for each candidate it peeks
the instance's ``PrefixCache`` (core/prefix_cache.py, non-mutating
``peek``) and scores the placement by *estimated time-to-first-token
work* —

    score(inst) = prefill_cost(prompt - cached_prefix)
                + WAIT_WEIGHT * queue_depth * prefill_cost(prompt)

the first term is the prefill this instance still has to run (a longer
matching prefix makes it cheaper), the second a wait proxy charging each
queued request ahead a small fraction of one prompt's prefill (decode
rounds batch and prefill tiers pipeline, so a queued request delays a
newcomer far less than a serialized prefill would — WAIT_WEIGHT=0.05
calibrated on the session_heavy scenario across all three modes).
Minimizing the sum trades cache benefit against load continuously
instead of cliff-switching, so a warm instance with a small queue beats
a cold idle one only while the saved prefill outweighs the wait — and a
session that detoured during a burst *returns* to its warm cache when
the queue drains, which the sticky map cannot do.

This module is also the worked proof that the control-plane API
(core/api.py) is real: it is registered purely through the public
``@register_policy`` decorator — ``ClusterRouter``'s dispatch path has no
``cache_aware`` branch anywhere — and every entry point
(``ExperimentSpec``, ``examples/cluster_sim.py --policy cache_aware``,
the ``cluster_cache_aware`` benchmark) picks it up by name. docs/api.md
walks through it line by line as the "write your own policy" example.

The port's own copy of `repro/core/policies/cache_aware.py` (plain Python
and numpy; keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.api import RoutingPolicy, register_policy
from repro_torch.core.policies.routing import least_loaded

# wait-proxy weight: fraction of one full-prompt prefill charged per
# queued request ahead (see module docstring)
WAIT_WEIGHT = 0.05


@register_policy("cache_aware")
class CacheAwareRouting(RoutingPolicy):
    """Route to the cheapest (cache-credited prefill + queue wait)
    instance, reading every candidate's ``PrefixCache`` instead of a
    sticky map. Sessionless requests fall back to least_loaded. Pooled-
    mode pinning mirrors ``session_affinity``: the chosen instance is
    bound at admission (before prefill runs) so the cache credit can
    shorten the prefill, and honored at hand-off."""

    needs_sessions = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self._pinned: Dict[int, int] = {}           # rid -> pre-bound inst

    def pick(self, cand, req, router):
        if req is None or req.session_id < 0:
            return least_loaded(cand)
        cm = router.prefill_cm
        # effective_prompt_len semantics: migrated KV needs no prefill
        # anywhere and the cache lookup at dispatch is bounded the same
        # way (router.credit_prefix), so a cross-session tree hit is
        # never double-credited on top of a migration credit
        eff = max(req.prompt_len - req.migrated_tokens, 1)
        per_queued = WAIT_WEIGHT * cm.prefill_latency(eff)

        def score(inst):
            hit = 0
            if inst.prefix_cache is not None:
                router.dispatch_peeks += 1
                hit = inst.prefix_cache.peek(req.session_id, eff,
                                             segments=req.prefix_segments)
            remaining = cm.prefill_latency(max(eff - hit, 1))
            # ties (e.g. nothing cached anywhere) break like least_loaded
            return (remaining + inst.queue_depth * per_queued,
                    inst.load(), inst.inst_id)

        return min(cand, key=score)

    def pin_for_prefill(self, cand, req, router):
        if req.session_id < 0:
            return None
        inst = self.pick(cand, req, router)
        self._pinned[req.rid] = inst.inst_id
        return inst

    def claim_pin(self, req) -> Optional[int]:
        return self._pinned.pop(req.rid, None)
