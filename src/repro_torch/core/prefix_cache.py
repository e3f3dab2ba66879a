"""Per-instance prefix cache: modeled KV reuse for cache-aware routing.

The first version of this module was a session-keyed LRU — an instance
that already held a session's prompt KV could skip prefill for the
cached prefix. The engine is now a cross-session **radix prefix
tree** (``core/prefix_tree.py``, RadixAttention-style): prompts are
ordered ``(segment_id, n_tokens)`` runs, so *different* sessions that
share a leading segment (a per-tenant system prompt, a few-shot header —
the ``shared_prefix`` trace scenario) hit each other's cached KV.
``PrefixCache`` survives as a thin adapter that keeps the LRU's public
API and stats, and — crucially — reproduces the old LRU *bit-exactly*
for session-keyed traffic: a request without ``prefix_segments`` maps to
a single-run path keyed by its session, which the tree stores as one
node with whole-entry LRU eviction, i.e. exactly the old OrderedDict.

Capacity is still real memory: construction reserves whole chunks from
the instance's ``UnifiedAllocator`` reusable pool (``prefix_reserve``),
which shrinks both the finetune window's capacity and the instance's KV
admission budget — a bigger cache trades decode/finetune headroom for
TTFT, it is not free.

Everything is deterministic (plain dict/tree state, no RNG), so cluster
runs stay bit-reproducible for a fixed seed (tested).

The port's own copy of `repro/core/prefix_cache.py` (plain Python; keep the
two in step): `tests/test_torch_allocator.py` holds it against the
reference's on a seeded sequence, and `tests/test_torch_simulator.py`
drives it through `DecodeInstanceSim`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.allocator import UnifiedAllocator
from repro_torch.core.prefix_tree import (
    RadixPrefixTree,
    Segments,
    normalize_segments,
    session_segments,
)


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    chunks: int = 16               # capacity asked from the unified pool
    min_hit_tokens: int = 32       # ignore hits too small to matter
    cross_session: bool = True     # honor prefix_segments (False = the
    #                                session-keyed LRU baseline, used as
    #                                the no-sharing arm in benchmarks)


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0               # dispatch-time lookups only
    hits: int = 0
    misses: int = 0
    hit_tokens: int = 0            # prefill tokens saved, summed
    shared_hit_tokens: int = 0     # subset of hit_tokens matched on a
    #                                non-terminal run, i.e. KV another
    #                                session (or turn-prefix) cached
    insertions: int = 0
    evictions: int = 0             # nodes evicted (== sessions for
    #                                session-keyed traffic)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PrefixCache:
    """Radix-tree prefix cache for one instance, with the session-keyed
    LRU's API.

    ``lookup`` is called by the router at dispatch time (the instance is
    chosen first, then its cache is consulted); ``insert`` is called by
    the instance when a request's prompt KV becomes resident at decode
    admission. A session moved to another instance (affinity overflow)
    simply goes cold here and warms up there — LRU ages it out, but its
    *shared* leading segments stay hot as long as any session uses them.
    """

    def __init__(self, cfg: PrefixCacheConfig, alloc: UnifiedAllocator):
        self.cfg = cfg
        self.granted_chunks = alloc.prefix_reserve(max(cfg.chunks, 0))
        self.capacity_tokens = self.granted_chunks * alloc.tokens_per_chunk
        self.tree = RadixPrefixTree(self.capacity_tokens)
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------ paths --
    def _path(self, session_id: int, total_tokens: int,
              segments: Segments) -> Segments:
        if segments and self.cfg.cross_session:
            return normalize_segments(segments)
        return session_segments(session_id, total_tokens)

    # ---------------------------------------------------------- queries --
    def lookup(self, session_id: int, prompt_len: int,
               segments: Segments = ()) -> int:
        """Tokens of ``prompt_len`` covered by the cached tree (0 on
        miss). A hit refreshes the matched path's LRU position. At least
        one token always remains to prefill — the new turn's tokens are
        never cached. The hit itself is ``peek``'s computation, so a
        routing decision made on a peek is granted exactly what it saw."""
        self.stats.lookups += 1
        hit, shared, path = self._probe(session_id, prompt_len, segments)
        if hit == 0:
            self.stats.misses += 1
            return 0
        self.tree.touch(path)
        self.stats.hits += 1
        self.stats.hit_tokens += hit
        self.stats.shared_hit_tokens += shared
        return hit

    def peek(self, session_id: int, prompt_len: int,
             segments: Segments = ()) -> int:
        """Non-mutating ``lookup``: same hit computation (min-hit floor,
        last token never covered) but no stats and no LRU refresh — the
        probe cross-instance cache-aware routing uses to compare every
        candidate's cache before committing to one (whose ``lookup`` then
        grants exactly the peeked credit)."""
        hit, _, _ = self._probe(session_id, prompt_len, segments)
        return hit

    def _probe(self, session_id: int, prompt_len: int,
               segments: Segments) -> Tuple[int, int, Segments]:
        path = self._path(session_id, prompt_len, segments)
        total, final_run = self.tree.match(path)
        hit = min(total, prompt_len - 1)
        if hit < self.cfg.min_hit_tokens:
            return 0, 0, path
        shared = max(min(total - final_run, hit), 0)
        return hit, shared, path

    def revoke(self, hit_tokens: int) -> None:
        """Reverse one granted hit's accounting (the router calls this
        when a pooled-mode pin breaks after prefill already ran short):
        the saved tokens were spent, but the hit must not count as a
        cache win. Grant and revoke bookkeeping both live here. The
        shared-token split is left as granted — it describes what the
        tree matched, not what the request ultimately saved."""
        self.stats.hits -= 1
        self.stats.misses += 1
        self.stats.hit_tokens -= hit_tokens

    # ---------------------------------------------------------- updates --
    def insert(self, session_id: int, prefix_tokens: int,
               segments: Segments = ()) -> None:
        """Record that this request's prompt KV (``prefix_tokens``) is
        now resident, evicting least-recently-used tree leaves past
        capacity."""
        if self.capacity_tokens <= 0 or prefix_tokens <= 0:
            return
        self.tree.insert(self._path(session_id, prefix_tokens, segments))
        self.stats.insertions += 1
        self._sync_evictions()

    def _sync_evictions(self) -> None:
        if self.tree.evicted_nodes:
            self.stats.evictions += self.tree.evicted_nodes
            self.tree.evicted_nodes = 0

    def invalidate_all(self) -> None:
        """Drop every cached prefix at once — the instance's KV memory is
        gone (host failure, cluster failure layer). The cache object stays
        alive: ``revoke`` must still work for in-flight requests whose pin
        to this instance breaks after the kill. Flushed nodes count as
        evictions in the stats."""
        self.stats.evictions += self.tree.clear()

    # ------------------------------------------------------- inspection --
    def __len__(self) -> int:
        return len(self.tree)

    @property
    def used_tokens(self) -> int:
        return self.tree.used_tokens

    def check_invariants(self) -> None:
        self.tree.check_invariants()
