"""Unified memory allocator (paper §4).

One arbiter owns the instance's unified HBM pool (everything left after the
inference model's weights). Three typed sub-pools share it:

  * KV pool        — chunk-granular (chunk = n_layers x 2 blocks, block 2MB),
                     exactly the paper's two-level layout;
  * finetune window — whole chunks lent to the finetune task to hold frozen
                     layer weights (window-based swapping, §4.3);
  * small-tensor pool — fixed-size buddy-managed region (2KB granularity)
                     for sub-2MB activations (§4.5);
  * prefix cache    — whole chunks lent to the session prefix cache
                     (core/prefix_cache.py) so sticky-session KV reuse is
                     charged against the same reusable pool as the window;
  * adapter pool    — whole chunks holding hot-loaded LoRA adapter weights
                     (core/adapters.py): multi-tenant serving competes for
                     the same HBM as KV admission and the finetune window.

Mechanism difference vs the paper (recorded in DESIGN.md §2): CUDA VMM
remapping is replaced by budget re-partitioning at decode-round boundaries
(JAX buffer donation); the *policies* — window sizing from free chunks,
reserved headroom Mem_reserved = (T_swap/QoS)·max_bs·Mem_kv, immediate
reclaim within one swap latency — are the paper's.

The port's own copy of `repro/core/allocator.py` (plain Python; keep the
two in step). As in the reference, only the simulator (`core/simulator.py`)
drives it; the engines do not yet gate admission on it (ROADMAP item 1).
`tests/test_torch_allocator.py` holds its state against the reference's
after every operation of a seeded sequence.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.buddy import BuddyAllocator

BLOCK_BYTES = 2 * 1024 * 1024


@dataclasses.dataclass
class AllocatorConfig:
    total_bytes: int               # unified pool size (per instance)
    n_layers: int                  # inference model depth (chunk geometry)
    kv_bytes_per_token: int        # across all layers
    max_bs: int                    # max decode batch (headroom formula)
    qos_s: float                   # decode QoS target (50ms in §4.4 formula)
    swap_time_s: float             # T: time to swap one finetune layer
    small_pool_bytes: int = 256 * 1024 * 1024
    block_bytes: int = BLOCK_BYTES


class UnifiedAllocator:
    def __init__(self, cfg: AllocatorConfig):
        self.cfg = cfg
        self.chunk_bytes = cfg.n_layers * 2 * cfg.block_bytes
        pool = cfg.total_bytes - cfg.small_pool_bytes
        assert pool > 0, "pool smaller than small-tensor region"
        self.total_chunks = pool // self.chunk_bytes
        assert self.total_chunks > 0, "pool smaller than one chunk"
        self.kv_chunks = 0
        self.window_chunks = 0
        self.prefix_chunks = 0         # session prefix cache (prefix_cache.py)
        self.adapter_chunks = 0        # resident LoRA adapters (adapters.py)
        self.kv_tokens = 0
        self.reclaims = 0              # window chunks reclaimed by KV pressure
        # paired-accounting audit for adapter churn: every chunk reserved
        # must eventually be released; adapter_leak exposes the difference
        self.adapter_reserved_total = 0
        self.adapter_released_total = 0
        self.small = BuddyAllocator(cfg.small_pool_bytes)
        # metrics timeline for Fig. 13
        self.timeline: List[Dict] = []

    # ------------------------------------------------------- geometry ----
    @property
    def tokens_per_chunk(self) -> int:
        return max(self.chunk_bytes // max(self.cfg.kv_bytes_per_token, 1), 1)

    @property
    def free_chunks(self) -> int:
        return self.total_chunks - self.kv_chunks - self.window_chunks \
            - self.prefix_chunks - self.adapter_chunks

    @property
    def reserved_chunks(self) -> int:
        """Paper §4.4: Mem_reserved = (T_swap / QoS) * max_bs * Mem_kv —
        enough KV headroom that inference never waits for a window shrink."""
        tokens = math.ceil(self.cfg.swap_time_s / self.cfg.qos_s
                           * self.cfg.max_bs)
        reserved_bytes = tokens * self.cfg.kv_bytes_per_token
        return max(math.ceil(reserved_bytes / self.chunk_bytes), 1)

    # ------------------------------------------------------------ KV -----
    def kv_capacity_tokens(self) -> int:
        return self.kv_chunks * self.tokens_per_chunk

    def kv_alloc_tokens(self, n_tokens: int) -> bool:
        """Grow the KV pool to hold n more tokens. Inference is prioritized
        (paper §2.3): when free chunks don't cover the growth, the window is
        reclaimed on the spot — the reserved headroom guarantees the reclaim
        latency is hidden (§4.4); the finetune side observes the shrink on
        its next pump and evicts. Returns False only when genuinely OOM."""
        need_total = self.kv_tokens + n_tokens
        need_chunks = math.ceil(need_total / self.tokens_per_chunk)
        grow = need_chunks - self.kv_chunks
        if grow > 0:
            short = grow - self.free_chunks
            if short > 0:
                if short > self.window_chunks:
                    return False        # truly out of memory
                self.window_chunks -= short
                self.reclaims += short
            self.kv_chunks += grow
        self.kv_tokens = need_total
        return True

    def kv_free_tokens(self, n_tokens: int) -> None:
        self.kv_tokens = max(self.kv_tokens - n_tokens, 0)
        need_chunks = math.ceil(self.kv_tokens / self.tokens_per_chunk) \
            if self.kv_tokens else 0
        self.kv_chunks = max(need_chunks, 0)

    # --------------------------------------------------------- prefix ----
    def prefix_reserve(self, chunks: int) -> int:
        """Carve session-prefix-cache capacity out of the reusable pool.
        Charged like the finetune window — it shrinks both the window
        capacity and (via the caller reducing its KV admission budget) the
        KV pool — so cached prefixes are real memory, not free TTFT. The
        grant never eats the §4.4 reserved headroom. Returns chunks
        granted (may be fewer than asked)."""
        granted = max(min(chunks, self.free_chunks - self.reserved_chunks),
                      0)
        self.prefix_chunks += granted
        return granted

    # -------------------------------------------------------- adapters ----
    def adapter_reserve(self, chunks: int) -> bool:
        """Pin a LoRA adapter's weight chunks. Adapters serve inference, so
        like KV growth they may reclaim finetune-window chunks on the spot —
        but the grant is all-or-nothing (partial adapter weights are useless)
        and never eats the §4.4 reserved headroom. Returns False when the
        adapter genuinely does not fit (caller evicts a colder adapter and
        retries, or serves at the base model)."""
        if chunks <= 0:
            return True
        avail = max(self.free_chunks - self.reserved_chunks, 0) \
            + self.window_chunks
        if chunks > avail:
            return False
        short = chunks - max(self.free_chunks - self.reserved_chunks, 0)
        if short > 0:
            self.window_chunks -= short
            self.reclaims += short
        self.adapter_chunks += chunks
        self.adapter_reserved_total += chunks
        return True

    def adapter_release(self, chunks: int) -> None:
        assert 0 <= chunks <= self.adapter_chunks
        self.adapter_chunks -= chunks
        self.adapter_released_total += chunks

    @property
    def adapter_leak(self) -> int:
        """Reserve/release pairing audit: nonzero means an adapter load or
        eviction lost track of chunks. Asserted zero by check_invariants."""
        return self.adapter_reserved_total - self.adapter_released_total \
            - self.adapter_chunks

    # --------------------------------------------------------- window ----
    def window_capacity_chunks(self) -> int:
        """How many chunks the finetune window may hold right now: free
        chunks minus the reserved headroom (§4.4)."""
        return max(self.free_chunks + self.window_chunks
                   - self.reserved_chunks, 0)

    def resize_window(self, chunks: int) -> int:
        """Clamp to capacity; returns the granted window size (chunks)."""
        granted = min(chunks, self.window_capacity_chunks())
        self.window_chunks = max(granted, 0)
        return self.window_chunks

    def pressure_shrink(self) -> int:
        """Called when KV needs memory: shed window chunks down to what the
        current capacity allows. Returns chunks released."""
        cap = self.window_capacity_chunks()
        released = max(self.window_chunks - cap, 0)
        self.window_chunks -= released
        return released

    # --------------------------------------------------------- metrics ---
    def snapshot(self, t: float) -> Dict:
        s = {
            "t": t,
            "kv_bytes": self.kv_chunks * self.chunk_bytes,
            "window_bytes": self.window_chunks * self.chunk_bytes,
            "prefix_bytes": self.prefix_chunks * self.chunk_bytes,
            "adapter_bytes": self.adapter_chunks * self.chunk_bytes,
            "small_bytes": self.cfg.small_pool_bytes,
            "free_bytes": self.free_chunks * self.chunk_bytes,
            "kv_tokens": self.kv_tokens,
            "window_chunks": self.window_chunks,
        }
        self.timeline.append(s)
        return s

    def check_invariants(self) -> None:
        assert 0 <= self.kv_chunks
        assert 0 <= self.window_chunks
        assert 0 <= self.prefix_chunks
        assert 0 <= self.adapter_chunks
        assert self.adapter_leak == 0
        assert self.kv_chunks + self.window_chunks + self.prefix_chunks \
            + self.adapter_chunks <= self.total_chunks
        assert self.kv_tokens <= self.kv_capacity_tokens() or \
            self.kv_chunks == 0
