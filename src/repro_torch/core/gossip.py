"""Asynchronous cache-summary gossip plane for fleet-scale routing.

``cache_aware`` routing synchronously peeks every candidate's
prefix cache on every dispatch — O(fleet) cache probes per request,
which does not survive fleets well beyond 16 instances. This module
models the alternative every large serving fleet converges on: each
instance periodically publishes a *compact digest* of its prefix tree
(top-k prefix fingerprints + cached token counts, bounded bytes), and
the router scores placements from the digests alone — **zero
synchronous peeks on the dispatch path**.

The price of asynchrony is staleness: a digest describes the cache as
it was up to one gossip period ago (plus propagation delay, which we
fold into the period). ``cache_aware_gossip`` therefore discounts the
estimated hit linearly with digest age and a digest at or past the
``staleness_bound_s`` is *never* used (``get`` returns ``None``, the
instance scores as a cold cache). The staleness math and the decision
table vs synchronous ``cache_aware`` are in docs/cluster.md.

Everything here is deterministic (dict state keyed by instance id, the
simulator's clock, no RNG) — gossip runs are bit-reproducible per seed.

The port's own copy of `repro/core/gossip.py` (plain Python and numpy; keep
the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Modeled wire format: a fixed header (instance id, publish time, total /
# capacity token counters) plus one (fingerprint, token count) entry per
# digest slot. 64-bit fingerprint + 32-bit token count per entry.
DIGEST_HEADER_BYTES = 24
DIGEST_ENTRY_BYTES = 12


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Spec block ``cluster.gossip`` (ExperimentSpec schema v2)."""

    period_s: float = 2.0            # publish interval per instance
    staleness_bound_s: float = 10.0  # digests at/past this age are dead
    top_k: int = 8                   # prefix fingerprints per digest
    max_bytes: int = 256             # hard cap on digest wire size

    def effective_top_k(self) -> int:
        """``top_k`` after the byte budget: entries that do not fit in
        ``max_bytes`` are dropped heaviest-last (the digest is sorted by
        token mass, so the cheap-to-lose tail goes first)."""
        budget = (self.max_bytes - DIGEST_HEADER_BYTES) // DIGEST_ENTRY_BYTES
        return max(min(self.top_k, budget), 0)


@dataclasses.dataclass(frozen=True)
class CacheDigest:
    """One instance's published cache summary, immutable once published."""

    inst_id: int
    t: float                                   # publish time
    total_tokens: int                          # tree-wide cached tokens
    capacity_tokens: int
    # (fingerprint, tokens), heaviest first
    entries: Tuple[Tuple[int, int], ...]
    size_bytes: int

    def age(self, now: float) -> float:
        return max(now - self.t, 0.0)


class GossipPlane:
    """The fleet-wide digest store: publish side driven by the
    ``ClusterSim`` step loop (one pump per epoch, per-instance period),
    read side driven by the ``cache_aware_gossip`` policy at dispatch.

    In a real deployment this is a gossip/broadcast bus; the simulator
    models its *information* properties (bounded size, bounded
    staleness, periodic refresh) rather than its transport.
    """

    def __init__(self, cfg: GossipConfig):
        self.cfg = cfg
        self._digests: Dict[int, CacheDigest] = {}
        self.published = 0
        self.bytes_published = 0
        self.reads = 0
        self.stale_discards = 0
        self.max_used_age = 0.0

    def publish(self, inst_id: int, now: float, tree) -> CacheDigest:
        """Snapshot ``tree`` into a digest for ``inst_id`` at ``now``.
        ``tree`` is a ``RadixPrefixTree`` (duck-typed: ``digest(k)``,
        ``used_tokens``, ``capacity_tokens``)."""
        k = self.cfg.effective_top_k()
        entries = tuple(tree.digest(k))
        d = CacheDigest(
            inst_id=inst_id,
            t=now,
            total_tokens=tree.used_tokens,
            capacity_tokens=tree.capacity_tokens,
            entries=entries,
            size_bytes=DIGEST_HEADER_BYTES + DIGEST_ENTRY_BYTES * len(entries),
        )
        self._digests[inst_id] = d
        self.published += 1
        self.bytes_published += d.size_bytes
        return d

    def get(self, inst_id: int, now: float) -> Optional[CacheDigest]:
        """The freshest digest for ``inst_id``, or ``None`` when there is
        none or it has aged past the staleness bound — the caller must
        treat ``None`` as an unknown (cold) cache, never fall back to a
        synchronous peek."""
        d = self._digests.get(inst_id)
        if d is None:
            return None
        age = d.age(now)
        if age >= self.cfg.staleness_bound_s:
            self.stale_discards += 1
            return None
        self.reads += 1
        if age > self.max_used_age:
            self.max_used_age = age
        return d

    def discount(self, age: float) -> float:
        """Hit-probability multiplier for a digest of ``age``: linear
        decay from 1 (fresh) to 0 at the staleness bound. The cache may
        have evicted what the digest advertises; the closer to the bound,
        the less the advertisement is worth."""
        bound = self.cfg.staleness_bound_s
        if bound <= 0:
            return 0.0
        return max(1.0 - age / bound, 0.0)

    def drop(self, inst_id: int) -> None:
        """Forget an instance's digest (killed / preempted — its cache is
        gone, advertising it would misroute until the bound expired)."""
        self._digests.pop(inst_id, None)

    def __len__(self) -> int:
        return len(self._digests)
