"""Cross-session radix prefix tree: the engine behind ``PrefixCache``.

The simulator has no real token content, so token identity is symbolic:
a prompt is an ordered tuple of ``(segment_id, n_tokens)`` runs
(``Request.prefix_segments``). Two prompts share a prefix exactly while
they consume the same segment ids with full-length matches, diverging
mid-segment at the shorter length — the same structure RadixAttention
(SGLang) exploits on real token ids. A session-keyed trace degenerates
to one run per session (``SESSION_SEG_BASE + session_id``), which is how
the ``PrefixCache`` adapter reproduces the session-keyed LRU
bit-identically; the
``shared_prefix`` scenario layers a per-tenant system-prompt segment
under the session run, so *different* sessions hit each other's cached
system prompts.

Tree semantics (chosen so the single-run path is exactly the old LRU):

  * **match** walks the query runs, crediting ``min(edge, run)`` tokens
    and stopping at the first divergence. Non-mutating.
  * **insert** stores the path with *terminal-replace* semantics: the
    inserted path's total length becomes exactly the stored length for
    that chain (a shorter re-insert truncates, dropping anything beyond
    — the pop-old/set-new behaviour of the LRU), while interior shared
    segments split radix-style so sibling branches survive.
  * **eviction is node-granular LRU**: every insert/hit refreshes the
    whole matched path, and capacity pressure evicts the
    least-recently-used *leaf* — so a hot shared system-prompt node
    stays resident while the cold session tails under it age out.

Determinism: plain dict state, a monotone touch clock, no RNG — cluster
runs stay bit-reproducible for a fixed seed (tested).

``digest(k)`` summarizes the tree for the gossip plane (core/gossip.py):
the top-k prefix paths by cached tokens, each as a stable 64-bit FNV-1a
fingerprint over the (collapsed) segment-id path plus the cached token
count along it. ``path_fingerprints`` computes the matching query-side
fingerprints, so a router can estimate a hit from the digest alone —
zero synchronous peeks.

The port's own copy of `repro/core/prefix_tree.py` (plain Python; keep the
two in step), the engine of `core/prefix_cache.py`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.serving.request import GROUP_SEG_BASE  # noqa: F401  (re-export)
from repro_torch.serving.request import SESSION_SEG_BASE

Segments = Tuple[Tuple[int, int], ...]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv_step(fp: int, seg_id: int) -> int:
    """One 64-bit FNV-1a step folding ``seg_id`` into a path fingerprint.
    Deterministic across processes (unlike ``hash``) and cheap."""
    for shift in (0, 8, 16, 24, 32, 40, 48, 56):
        fp = ((fp ^ ((seg_id >> shift) & 0xFF)) * _FNV_PRIME) & _MASK64
    return fp


def path_fingerprints(segments: Segments) -> List[Tuple[int, int]]:
    """Query-side digest keys: for every cumulative run prefix of
    ``segments``, the (fingerprint, cumulative_tokens) pair — ordered
    shallowest first. Matches ``RadixPrefixTree.digest`` keys by
    construction (both collapse consecutive duplicate segment ids)."""
    out: List[Tuple[int, int]] = []
    fp, cum, prev = _FNV_OFFSET, 0, None
    for sid, n in segments:
        if n <= 0:
            continue
        cum += n
        if sid != prev:
            fp = _fnv_step(fp, sid)
            prev = sid
            out.append((fp, cum))
        else:
            out[-1] = (fp, cum)
    return out


def session_segments(session_id: int, prompt_len: int) -> Segments:
    """The single-run path a session-keyed (segment-less) request maps
    to — the degenerate tree shape that reproduces the session-keyed
    LRU."""
    return ((SESSION_SEG_BASE + session_id, prompt_len),)


class _Node:
    __slots__ = ("seg_id", "length", "children", "parent", "last_use")

    def __init__(self, seg_id: int, length: int, parent: "_Node"):
        self.seg_id = seg_id
        self.length = length
        self.children: Dict[int, _Node] = {}
        self.parent = parent
        self.last_use = 0


class RadixPrefixTree:
    """Radix tree over symbolic ``(segment_id, n_tokens)`` runs with
    node-granular LRU eviction under a token capacity."""

    def __init__(self, capacity_tokens: int):
        self.capacity_tokens = max(capacity_tokens, 0)
        self.root = _Node(-1, 0, None)   # sentinel, never evicted
        self.used_tokens = 0
        self.node_count = 0
        self.evicted_nodes = 0
        self._clock = 0

    # ------------------------------------------------------------ match --
    def match(self, segments: Segments) -> Tuple[int, int]:
        """Tokens of ``segments`` covered by the cached tree, walked from
        the root to the first divergence. Returns ``(matched_total,
        matched_on_final_run)`` — the difference is the shared-prefix
        share (tokens matched on non-terminal runs, e.g. a system prompt
        another session inserted). Non-mutating."""
        total = 0
        final_run = 0
        cur = self.root
        last = len(segments) - 1
        for i, (sid, n) in enumerate(segments):
            rem = n
            while rem > 0:
                child = cur.children.get(sid)
                if child is None:
                    return total, final_run
                take = min(child.length, rem)
                total += take
                if i == last:
                    final_run += take
                if child.length > rem:
                    # the edge extends beyond the query run: the stored
                    # content diverges past here, stop
                    return total, final_run
                rem -= child.length
                cur = child
        return total, final_run

    def touch(self, segments: Segments) -> None:
        """Refresh the LRU clock of every node on the matched path (the
        hit-side analogue of the LRU's ``move_to_end``)."""
        self._clock += 1
        cur = self.root
        for sid, n in segments:
            rem = n
            while rem > 0:
                child = cur.children.get(sid)
                if child is None:
                    return
                child.last_use = self._clock
                if child.length > rem:
                    return
                rem -= child.length
                cur = child

    # ----------------------------------------------------------- insert --
    def insert(self, segments: Segments) -> None:
        """Store the path with terminal-replace semantics (module
        docstring), refresh its LRU recency, then evict LRU leaves while
        over capacity. The inserted path itself is clamped to capacity
        (truncated from the tail) so it always fits."""
        if self.capacity_tokens <= 0:
            return
        segments = self._clamp(segments)
        if not segments:
            return
        self._clock += 1
        cur = self.root
        last = len(segments) - 1
        for i, (sid, n) in enumerate(segments):
            final = i == last
            rem = n
            while rem > 0:
                child = cur.children.get(sid)
                if child is None:
                    child = _Node(sid, rem, cur)
                    cur.children[sid] = child
                    self.used_tokens += rem
                    self.node_count += 1
                    rem = 0
                elif child.length <= rem:
                    if final and not child.children:
                        # grow the terminal edge in place: a chain with
                        # no branches stays ONE node, which is what makes
                        # the single-run (session-keyed) path reproduce
                        # the LRU's pop-old/set-new + whole-entry
                        # eviction exactly
                        self.used_tokens += rem - child.length
                        child.length = rem
                        rem = 0
                    else:
                        rem -= child.length
                        cur = child
                        cur.last_use = self._clock
                        continue
                elif final:
                    # shorter re-insert of this chain: truncate the edge
                    # and drop everything beyond (LRU pop-old/set-new)
                    self.used_tokens -= child.length - rem
                    child.length = rem
                    self._drop_subtree(child, count_evictions=True)
                    rem = 0
                else:
                    # interior divergence mid-edge: radix split so the
                    # existing continuation (and its branches) survive
                    self._split(child, rem)
                    rem = 0
                cur = child
                cur.last_use = self._clock
            if final:
                # terminal-replace: the stored chain ends exactly here
                self._drop_subtree(cur, count_evictions=True)
        while self.used_tokens > self.capacity_tokens:
            victim = self._lru_leaf()
            if victim is None:       # only the just-inserted path remains
                break
            self._evict(victim)

    def _clamp(self, segments: Segments) -> Segments:
        total = sum(n for _, n in segments if n > 0)
        budget = self.capacity_tokens
        if total <= budget:
            return tuple((s, n) for s, n in segments if n > 0)
        out: List[Tuple[int, int]] = []
        for sid, n in segments:
            if n <= 0 or budget <= 0:
                break
            take = min(n, budget)
            out.append((sid, take))
            budget -= take
        return tuple(out)

    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s edge at ``at`` tokens: the top keeps the
        parent link, a same-seg continuation child inherits the rest and
        the original children. Token totals are unchanged."""
        cont = _Node(node.seg_id, node.length - at, node)
        cont.children = node.children
        for ch in cont.children.values():
            ch.parent = cont
        cont.last_use = node.last_use
        node.children = {node.seg_id: cont}
        node.length = at
        self.node_count += 1

    def _drop_subtree(self, node: _Node, count_evictions: bool) -> int:
        """Remove every descendant of ``node`` (not the node itself)."""
        dropped = 0
        stack = list(node.children.values())
        node.children = {}
        while stack:
            n = stack.pop()
            self.used_tokens -= n.length
            self.node_count -= 1
            dropped += 1
            stack.extend(n.children.values())
        if count_evictions:
            self.evicted_nodes += dropped
        return dropped

    # --------------------------------------------------------- eviction --
    def _lru_leaf(self) -> Optional[_Node]:
        """The least-recently-used evictable leaf (ties impossible: the
        touch clock is strictly monotone). The most recently touched
        path is visited last by construction, so the just-inserted
        terminal is only ever returned when it is the sole leaf left —
        and the insert-time clamp guarantees that case fits."""
        best: Optional[_Node] = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif best is None or n.last_use < best.last_use:
                best = n
        if best is not None and best.last_use == self._clock \
                and len(self.root.children) == 1 \
                and self.node_count == self._path_len(best):
            return None
        return best

    def _path_len(self, node: _Node) -> int:
        n = 0
        while node is not None and node is not self.root:
            n += 1
            node = node.parent
        return n

    def _evict(self, node: _Node) -> None:
        assert not node.children
        self.used_tokens -= node.length
        self.node_count -= 1
        self.evicted_nodes += 1
        del node.parent.children[node.seg_id]

    def clear(self) -> int:
        """Drop everything (instance KV loss). Returns nodes dropped."""
        n = self._drop_subtree(self.root, count_evictions=False)
        self.used_tokens = 0
        return n

    # ----------------------------------------------------------- digest --
    def digest(self, k: int) -> Tuple[Tuple[int, int], ...]:
        """Top-``k`` cached prefix paths by token mass, as
        ``(fingerprint, cached_tokens)`` pairs sorted heaviest first
        (fingerprint ascending on ties, so the digest is deterministic).
        Fingerprints collapse same-seg continuation edges, matching
        ``path_fingerprints`` on the query side; a collapsed path keeps
        its deepest (largest) token count."""
        by_fp: Dict[int, int] = {}
        stack = [(child, _FNV_OFFSET, 0, -1)
                 for child in self.root.children.values()]
        while stack:
            node, fp, cum, prev_sid = stack.pop()
            if node.seg_id != prev_sid:
                fp = _fnv_step(fp, node.seg_id)
            cum += node.length
            if cum > by_fp.get(fp, 0):
                by_fp[fp] = cum
            for ch in node.children.values():
                stack.append((ch, fp, cum, node.seg_id))
        top = sorted(by_fp.items(), key=lambda e: (-e[1], e[0]))
        return tuple(top[:max(k, 0)])

    # ------------------------------------------------------- invariants --
    def __len__(self) -> int:
        return self.node_count

    def check_invariants(self) -> None:
        total, count = 0, 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            assert n.length > 0, "zero-length node"
            assert n.parent.children.get(n.seg_id) is n, "broken parent link"
            total += n.length
            count += 1
            stack.extend(n.children.values())
        assert total == self.used_tokens, \
            (total, self.used_tokens)
        assert count == self.node_count
        assert self.used_tokens <= max(self.capacity_tokens, 0)


def normalize_segments(segments: Iterable[Tuple[int, int]]) -> Segments:
    """Drop empty runs and merge consecutive runs with the same segment
    id (the tree and fingerprints assume adjacent runs differ)."""
    out: List[Tuple[int, int]] = []
    for sid, n in segments:
        if n <= 0:
            continue
        if out and out[-1][0] == sid:
            out[-1] = (sid, out[-1][1] + n)
        else:
            out.append((sid, n))
    return tuple(out)
