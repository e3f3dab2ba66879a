"""Built-in adapter_placement policies (multi-LoRA serving).

The decision these policies own: for a request carrying an adapter_id,
trade adapter *locality* (an instance already holding the stamped
version serves it with zero hot-load/swap cost) against *load balance*
(packing a hot tenant onto one instance starves its queue). Requests
without an adapter — and every request when ``ClusterConfig.adapters``
is None — never reach these policies; they go through the ``routing``
policy unchanged.

The port's own copy of `repro/core/policies/adapter_placement.py` (plain
Python and numpy; keep the two in step), with its names, seeds and
arithmetic.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core.api import AdapterPlacement, register_policy
from repro_torch.core.policies.routing import least_loaded


def _holders(cand: List, req) -> List:
    """Instances whose adapter pool already holds the exact
    (adapter_id, version) the request was stamped with."""
    return [i for i in cand
            if getattr(i, "adapters", None) is not None
            and i.adapters.has(req.adapter_id, req.adapter_version)]


@register_policy("affinity_packed")
class AffinityPackedPlacement(AdapterPlacement):
    """Pack each adapter onto as few instances as possible: prefer the
    least-loaded instance already holding the stamped version, spilling
    to the fleet-wide least-loaded instance only when every holder is
    past ``RouterConfig.affinity_overflow_load`` (the same overflow knob
    session_affinity uses). Minimizes swaps; a hot tenant grows replicas
    only under real load pressure."""

    def pick(self, cand, req, router):
        holders = _holders(cand, req)
        if holders:
            best = least_loaded(holders)
            if best.load() <= self.cfg.affinity_overflow_load:
                return best
        return least_loaded(cand)


@register_policy("replicate_hot")
class ReplicateHotPlacement(AdapterPlacement):
    """Deliberately replicate hot adapters: a tenant whose running share
    of adapter traffic reaches its fair share (1/n_candidates) is routed
    pure least-loaded — its adapter spreads across the fleet, buying
    balance at the cost of extra hot-loads — while cold tenants stay
    packed on their holders like affinity_packed."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self._counts: Dict[int, int] = {}
        self._total = 0

    def pick(self, cand, req, router):
        n = self._counts.get(req.adapter_id, 0) + 1
        self._counts[req.adapter_id] = n
        self._total += 1
        if n / self._total >= 1.0 / max(len(cand), 1):
            return least_loaded(cand)
        holders = _holders(cand, req)
        if holders:
            best = least_loaded(holders)
            if best.load() <= self.cfg.affinity_overflow_load:
                return best
        return least_loaded(cand)
