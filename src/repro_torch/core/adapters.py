"""Multi-LoRA adapter lifecycle: the finetune→serve loop.

Harli's colocated finetune jobs *produce* LoRA adapters; this module makes
the fleet *serve* them, closing the MaaS loop the ROADMAP calls
"continuous adapter deployment":

  * ``AdapterRegistry``      — fleet-level versioned store. The cluster
    publishes a new version for each tenant's adapter as its finetune job
    accumulates iterations (``AdapterServingConfig.publish_every_iters``).
  * ``AdapterPool``          — per-instance runtime. Decode instances
    hot-load the (adapter_id, version) a request was stamped with on
    demand; the weight bytes are charged to the instance's
    ``UnifiedAllocator`` (``adapter_reserve``/``adapter_release``), so
    resident adapters genuinely compete with KV admission, the finetune
    window and prefix-cache reservations. Load/swap time is priced by
    ``CostModel.adapter_load_time`` into the decode round the load lands
    in.
  * ``TenantConfig``         — a tenant in the arrival mix: its traffic
    weight and optional per-tenant TTFT/TPOT SLOs (threaded onto every
    request so ``request_slo`` scores each tenant against its own target).

Placement (which instance should serve an adapter-carrying request) is a
pluggable policy kind — ``adapter_placement`` in core/api.py, builtins in
core/policies/adapter_placement.py.

The port's own copy of `repro/core/adapters.py` (plain Python; keep the two
in step), on the port's `LoRAConfig`: `tests/test_torch_allocator.py` holds
the pool against the reference's on a seeded sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.allocator import UnifiedAllocator
from repro_torch.models.config import LoRAConfig, ModelConfig


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant of the multi-tenant arrival mix. ``weight`` is its share
    of arrivals (normalized across tenants); the SLO fields override the
    router-wide targets for this tenant's requests (None = router default).
    A tenant's adapter_id is its index in ``ExperimentSpec.tenants``."""
    name: str = "tenant"
    weight: float = 1.0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class AdapterServingConfig:
    """Cluster-level switch for multi-LoRA serving (None = off, and the
    whole subsystem is inert — bit-identical to the adapter-less sim)."""
    rank: int = 16                   # LoRA rank of the served adapters
    publish_every_iters: float = 1.0  # finetune iters between versions
    continuous: bool = True          # False = static baseline: v1 only
    max_loaded: int = 0              # per-instance residency cap (0 = HBM-bound)
    policy: str = "affinity_packed"  # adapter_placement registry name


@dataclasses.dataclass(frozen=True)
class InstanceAdapterConfig:
    """Per-instance geometry the cluster derives once from the model and
    AdapterServingConfig: chunk footprint and DMA load time of one adapter."""
    chunks: int                      # allocator chunks per resident adapter
    load_time_s: float               # CostModel.adapter_load_time(bytes)
    max_loaded: int = 0


def adapter_bytes(cfg: ModelConfig, rank: int) -> float:
    """bf16 weight bytes of one LoRA adapter at ``rank`` for this model."""
    lora = cfg.lora if cfg.lora is not None else LoRAConfig()
    scaled = dataclasses.replace(cfg, lora=dataclasses.replace(
        lora, rank=rank))
    return scaled.lora_param_count() * 2.0


class AdapterRegistry:
    """Fleet-level versioned adapter store. Versions are monotone per
    adapter; ``publish`` of a non-increasing version is a no-op so the
    cluster can republish idempotently every epoch."""

    def __init__(self) -> None:
        self._latest: Dict[int, int] = {}
        # (t, adapter_id, version) in publish order — the deployment log
        self.published: List[Tuple[float, int, int]] = []

    def publish(self, adapter_id: int, version: int, t: float) -> bool:
        if version <= self._latest.get(adapter_id, 0):
            return False
        self._latest[adapter_id] = version
        self.published.append((t, adapter_id, version))
        return True

    def latest(self, adapter_id: int) -> int:
        """Newest published version (0 = never published: serve base)."""
        return self._latest.get(adapter_id, 0)

    @property
    def versions_published(self) -> int:
        return len(self.published)


class AdapterPool:
    """Per-instance adapter residency. ``require`` queues a hot-load at
    request admission; ``take_load_time`` performs the queued loads at the
    next decode round (evicting LRU adapters not pinned by in-flight
    requests when HBM is short) and returns the DMA seconds to fold into
    that round's latency. All weight chunks go through the allocator's
    paired adapter_reserve/adapter_release so churn is leak-audited."""

    def __init__(self, alloc: UnifiedAllocator,
                 cfg: InstanceAdapterConfig) -> None:
        self.alloc = alloc
        self.cfg = cfg
        self.resident: Dict[int, int] = {}      # adapter_id -> version
        self._lru: Dict[int, int] = {}          # adapter_id -> last-use tick
        self._tick = 0
        self._queued: List[Tuple[int, int]] = []  # pending (aid, version)
        self.loads = 0
        self.evictions = 0
        self.load_failures = 0                  # served at base model instead
        self.load_time_total_s = 0.0

    def has(self, adapter_id: int, version: int) -> bool:
        return self.resident.get(adapter_id) == version

    def require(self, adapter_id: int, version: int) -> None:
        """Mark (adapter_id, version) needed; refreshes LRU recency either
        way so an already-resident adapter isn't the next eviction victim."""
        if adapter_id < 0:
            return
        self._tick += 1
        self._lru[adapter_id] = self._tick
        if self.resident.get(adapter_id) == version:
            return
        if (adapter_id, version) not in self._queued:
            self._queued.append((adapter_id, version))

    def take_load_time(self, in_use: Set[int]) -> float:
        """Perform all queued loads now; returns total load seconds charged
        to the current round. ``in_use`` is the set of adapter ids pinned
        by in-flight requests — never evicted to make room."""
        if not self._queued:
            return 0.0
        total = 0.0
        queued, self._queued = self._queued, []
        for aid, ver in queued:
            if self.resident.get(aid) == ver:
                continue            # a later require already satisfied it
            if self._load(aid, ver, in_use):
                total += self.cfg.load_time_s
                self.loads += 1
            else:
                self.load_failures += 1
        self.load_time_total_s += total
        return total

    def _load(self, aid: int, ver: int, in_use: Set[int]) -> bool:
        # version swap: the old version's chunks are released first, so an
        # upgrade never needs net-new HBM
        if aid in self.resident:
            self._evict(aid)
        while not self._fits():
            if not self._evict_coldest(in_use, protect=aid):
                return False        # nothing evictable: serve at base
        if not self.alloc.adapter_reserve(self.cfg.chunks):
            # allocator-level shortage (KV/prefix pressure): shed colder
            # adapters until the reserve succeeds or nothing is left
            while self._evict_coldest(in_use, protect=aid):
                if self.alloc.adapter_reserve(self.cfg.chunks):
                    break
            else:
                return False
        self.resident[aid] = ver
        return True

    def _fits(self) -> bool:
        return self.cfg.max_loaded <= 0 \
            or len(self.resident) < self.cfg.max_loaded

    def _evict_coldest(self, in_use: Set[int], protect: int) -> bool:
        victims = [a for a in self.resident
                   if a not in in_use and a != protect]
        if not victims:
            return False
        self._evict(min(victims, key=lambda a: self._lru.get(a, 0)))
        return True

    def _evict(self, aid: int) -> None:
        del self.resident[aid]
        self.alloc.adapter_release(self.cfg.chunks)
        self.evictions += 1

    def evict_all(self) -> None:
        """Release everything (instance killed/retired) so the allocator's
        paired accounting closes out."""
        for aid in list(self.resident):
            self._evict(aid)
        self._queued.clear()
