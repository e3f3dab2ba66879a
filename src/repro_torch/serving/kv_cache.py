"""Paged KV-cache pool (the serving-side half of Harli's unified allocator).

Port of `repro/serving/kv_cache.py`:
  * the *pool* is one pre-allocated tensor of pages:
      kv_pages: (n_layers, 2, num_pages, page_tokens, kv_heads, head_dim)
  * a *page table* per request maps logical token blocks -> physical pages
  * `PageTableManager` is the host-side accounting (free list, usable cap);
    `paged_read`/`paged_write`/`kv_positions` are the torch gather/scatter
    paths. The paged decode kernel reads the pool's pages directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PagePoolSpec:
    n_layers: int
    num_pages: int
    page_tokens: int
    kv_heads: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def page_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return (self.n_layers * 2 * self.page_tokens * self.kv_heads
                * self.head_dim * itemsize)

    def alloc(self, device) -> torch.Tensor:
        return torch.zeros((self.n_layers, 2, self.num_pages, self.page_tokens,
                            self.kv_heads, self.head_dim), dtype=self.dtype,
                           device=device)


def spec_for(cfg: ModelConfig, num_pages: int, page_tokens: int = 16
             ) -> PagePoolSpec:
    return PagePoolSpec(
        n_layers=len(cfg.attn_layer_indices()) or 1,
        num_pages=num_pages, page_tokens=page_tokens,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)


class PageTableManager:
    """Host-side page tables: request -> list of physical pages.

    Allocation order is FIFO over a free list; the unified allocator may
    shrink the usable region (lending pages to the finetune window), which
    is enforced here via ``set_usable``.
    """

    def __init__(self, spec: PagePoolSpec, max_slots: int,
                 max_pages_per_seq: int):
        self.spec = spec
        self.max_slots = max_slots
        self.max_pages_per_seq = max_pages_per_seq
        self.free: List[int] = list(range(spec.num_pages))
        self.usable = spec.num_pages
        self.tables: Dict[int, List[int]] = {}      # slot -> pages
        self.lengths: Dict[int, int] = {}           # slot -> tokens stored

    # -- accounting ------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.spec.num_pages - len(self.free)

    def set_usable(self, usable_pages: int) -> None:
        """Unified-allocator hook: cap how many pages KV may occupy."""
        self.usable = usable_pages

    def can_alloc(self, n_tokens: int) -> bool:
        need = self._pages_needed(n_tokens)
        return (self.pages_in_use + need) <= self.usable and \
            len(self.free) >= need

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.spec.page_tokens)

    # -- lifecycle ---------------------------------------------------------
    def admit(self, slot: int, prompt_len: int) -> bool:
        need = self._pages_needed(prompt_len)
        if not self.can_alloc(prompt_len) or slot in self.tables:
            return False
        self.tables[slot] = [self.free.pop() for _ in range(need)]
        self.lengths[slot] = prompt_len
        return True

    def extend(self, slot: int, n_tokens: int = 1) -> bool:
        """Grow a sequence; allocates a new page on boundary crossings."""
        cur = self.lengths[slot]
        need = self._pages_needed(cur + n_tokens) - len(self.tables[slot])
        if need > 0:
            if len(self.free) < need or \
                    self.pages_in_use + need > self.usable:
                return False
            self.tables[slot] += [self.free.pop() for _ in range(need)]
        self.lengths[slot] = cur + n_tokens
        return True

    def release(self, slot: int) -> None:
        self.free.extend(self.tables.pop(slot, []))
        self.lengths.pop(slot, None)

    def table_array(self, slots: List[int]) -> np.ndarray:
        """(len(slots), max_pages_per_seq) int32, -1 padded."""
        out = np.full((len(slots), self.max_pages_per_seq), -1, np.int32)
        for i, s in enumerate(slots):
            pages = self.tables.get(s, [])
            out[i, :len(pages)] = pages
        return out


# ------------------------------------------------------- paged gather ops --
def paged_read(pool: torch.Tensor, page_table: torch.Tensor, layer: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather a layer's K/V for a batch.

    pool: (L, 2, P, pt, KV, hd); page_table: (B, n_pages) int32 (-1 pad).
    Returns k, v: (B, n_pages*pt, KV, hd); padded pages read page 0 but are
    masked by kv_pos logic downstream.
    """
    pt = page_table.long().clamp(min=0)
    k = pool[layer, 0][pt]                     # (B, n_pages, ptok, KV, hd)
    v = pool[layer, 1][pt]
    B, n_pages, ptok, KV, hd = k.shape
    return (k.reshape(B, n_pages * ptok, KV, hd),
            v.reshape(B, n_pages * ptok, KV, hd))


def paged_write(pool: torch.Tensor, page_table: torch.Tensor, layer: int,
                positions: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor) -> torch.Tensor:
    """Scatter one token per request into the pool, in place.

    positions: (B,) absolute token index; k_new/v_new: (B, KV, hd)."""
    ptok = pool.shape[3]
    pos = positions.long()
    page_idx = pos // ptok
    slot_in_page = pos % ptok
    phys = torch.gather(page_table.long().clamp(min=0), 1,
                        page_idx[:, None])[:, 0]
    pool[layer, 0, phys, slot_in_page] = k_new.to(pool.dtype)
    pool[layer, 1, phys, slot_in_page] = v_new.to(pool.dtype)
    return pool


def kv_positions(page_table: torch.Tensor, lengths: torch.Tensor,
                 page_tokens: int) -> torch.Tensor:
    """(B, n_pages*pt) absolute positions for gathered caches (-1 invalid)."""
    B, n_pages = page_table.shape
    logical = torch.arange(n_pages * page_tokens, dtype=torch.int32,
                           device=page_table.device)[None, :]
    valid = (logical < lengths[:, None]) & \
        (page_table.repeat_interleave(page_tokens, dim=1) >= 0)
    return torch.where(valid, logical, -1).to(torch.int32)
