"""Buddy allocator for the small-tensor pool (paper §4.5).

Both tasks issue thousands of sub-2MB allocations per iteration (activations,
router buffers, norms). Serving them from the 2MB-block pool would fragment
it badly, so Harli gives them a dedicated pool with 2KB granularity managed
by a classic power-of-two buddy scheme. Pure bookkeeping (offsets into a
pre-allocated region), hypothesis-tested in tests/test_allocator.py.

The port's own copy of `repro/core/buddy.py` (plain Python; keep the two in
step): `tests/test_torch_allocator.py` holds its state against the
reference's after every operation of a seeded sequence.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class BuddyAllocator:
    def __init__(self, size_bytes: int, min_block: int = 2048):
        assert size_bytes % min_block == 0
        self.min_block = min_block
        # round pool down to a power-of-two multiple of min_block
        self.levels = (size_bytes // min_block).bit_length() - 1
        self.size = min_block * (1 << self.levels)
        # free lists per level: level 0 = whole pool, level L = min blocks
        self.free: List[List[int]] = [[] for _ in range(self.levels + 1)]
        self.free[0] = [0]
        self.allocated: Dict[int, int] = {}   # offset -> level
        self.allocated_bytes = 0
        self.peak_bytes = 0

    def _level_for(self, size: int) -> int:
        size = max(size, self.min_block)
        block = self.min_block * (1 << self.levels)
        lvl = 0
        while lvl < self.levels and block // 2 >= size:
            block //= 2
            lvl += 1
        return lvl

    def block_size(self, level: int) -> int:
        return self.size >> level

    def alloc(self, size: int) -> Optional[int]:
        """Returns byte offset or None if out of memory."""
        if size <= 0 or size > self.size:
            return None
        lvl = self._level_for(size)
        # find the deepest level <= lvl with a free block
        src = lvl
        while src >= 0 and not self.free[src]:
            src -= 1
        if src < 0:
            return None
        off = self.free[src].pop()
        while src < lvl:                      # split down
            src += 1
            buddy = off + self.block_size(src)
            self.free[src].append(buddy)
        self.allocated[off] = lvl
        self.allocated_bytes += self.block_size(lvl)
        self.peak_bytes = max(self.peak_bytes, self.allocated_bytes)
        return off

    def freeb(self, off: int) -> None:
        lvl = self.allocated.pop(off)
        self.allocated_bytes -= self.block_size(lvl)
        # coalesce with buddy while possible
        while lvl > 0:
            bsize = self.block_size(lvl)
            buddy = off ^ bsize
            if buddy in self.free[lvl]:
                self.free[lvl].remove(buddy)
                off = min(off, buddy)
                lvl -= 1
            else:
                break
        self.free[lvl].append(off)

    # ------------------------------------------------------- invariants --
    def check_invariants(self) -> None:
        """No overlap, full coverage. O(n log n); used by tests."""
        spans = []
        for off, lvl in self.allocated.items():
            spans.append((off, off + self.block_size(lvl), "a"))
        for lvl, offs in enumerate(self.free):
            for off in offs:
                spans.append((off, off + self.block_size(lvl), "f"))
        spans.sort()
        cursor = 0
        for lo, hi, _ in spans:
            assert lo == cursor, f"gap/overlap at {lo} (cursor {cursor})"
            cursor = hi
        assert cursor == self.size, f"coverage {cursor} != {self.size}"

    @property
    def fragmentation_bytes(self) -> int:
        """Free bytes not in the largest free block (external fragmentation)."""
        free_total = self.size - self.allocated_bytes
        largest = 0
        for lvl, offs in enumerate(self.free):
            if offs:
                largest = max(largest, self.block_size(lvl))
        return free_total - largest
