"""``cache_aware_gossip`` routing: digest-scored cache-aware placement.

``cache_aware`` pays one synchronous ``PrefixCache.peek`` per candidate
per dispatch — O(fleet) cache probes per request, a control-plane cost
that does not survive fleets well beyond 16 instances. This policy makes
the same placement decision from the asynchronous gossip plane
(core/gossip.py) instead: each instance's cache publishes a compact
digest (top-k prefix fingerprints + cached token counts) on a period,
and the dispatch path reads only those digests — **zero synchronous
cache peeks** (``router.dispatch_peeks`` stays 0, tested).

The estimated hit for a candidate is the deepest digest entry whose
fingerprint matches a prefix of the request's segment path, capped by
the request's own depth there, floored by the cache's min-hit threshold
and then discounted by digest age: a digest near the staleness bound may
advertise KV that has since been evicted, so its promise is worth
proportionally less (``GossipPlane.discount``, linear to 0 at the
bound). A missing or over-age digest scores as a cold cache — the policy
never falls back to a synchronous peek.

Score shape and tie-breaking are identical to ``cache_aware``; with a
fresh, complete digest the two policies make the same choice (the
decision table is in docs/cluster.md).

The port's own copy of `repro/core/policies/cache_aware_gossip.py` (plain
Python and numpy; keep the two in step), with its names, seeds and
arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.api import RoutingPolicy, register_policy
from repro_torch.core.policies.cache_aware import WAIT_WEIGHT
from repro_torch.core.policies.routing import least_loaded
from repro_torch.core.prefix_tree import path_fingerprints, session_segments


@register_policy("cache_aware_gossip")
class CacheAwareGossipRouting(RoutingPolicy):
    """Route to the cheapest (digest-estimated prefill + queue wait)
    instance, reading gossiped cache digests instead of the caches.
    Sessionless requests fall back to least_loaded; a fleet with no
    gossip plane attached degrades to least_loaded-with-wait (every
    estimate is 0). Pooled-mode pinning mirrors ``cache_aware``."""

    needs_sessions = True

    def __init__(self, cfg):
        super().__init__(cfg)
        self._pinned: Dict[int, int] = {}           # rid -> pre-bound inst

    def _estimate(self, inst, req, router, eff: int) -> int:
        plane = router.gossip
        if plane is None:
            return 0
        digest = plane.get(inst.inst_id, router.clock)
        if digest is None:                           # unknown or too stale
            return 0
        segs = req.prefix_segments or session_segments(req.session_id, eff)
        want = path_fingerprints(segs)
        by_fp = dict(digest.entries)
        est = 0
        for fp, cum in want:                         # shallow -> deep
            adv = by_fp.get(fp)
            if adv is not None:
                est = max(est, min(adv, cum))
        est = min(est, eff - 1)
        cache = inst.prefix_cache
        floor = cache.cfg.min_hit_tokens if cache is not None else 0
        if est < floor:
            return 0
        return int(est * plane.discount(digest.age(router.clock)))

    def pick(self, cand, req, router):
        if req is None or req.session_id < 0:
            return least_loaded(cand)
        cm = router.prefill_cm
        eff = max(req.prompt_len - req.migrated_tokens, 1)
        per_queued = WAIT_WEIGHT * cm.prefill_latency(eff)

        def score(inst):
            est = self._estimate(inst, req, router, eff)
            remaining = cm.prefill_latency(max(eff - est, 1))
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
