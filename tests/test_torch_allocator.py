"""The port's unified allocator, buddy allocator, prefix cache and adapter
pool against the reference's.

Each is plain Python, copied into the port (which imports nothing of the
JAX package). A seeded sequence of operations is applied to the
reference's object and to the port's, side by side: every return value,
and the whole state after every step (each attribute, nested objects and
the timeline included), is equal.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import adapters as JAD  # noqa: E402
from repro.core import allocator as JAL  # noqa: E402
from repro.core import buddy as JBD  # noqa: E402
from repro.core import prefix_cache as JPC  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import adapters as TAD  # noqa: E402
from repro_torch.core import allocator as TAL  # noqa: E402
from repro_torch.core import buddy as TBD  # noqa: E402
from repro_torch.core import prefix_cache as TPC  # noqa: E402

STEPS = 400
SEEDS = (0, 1)


def _state(x, skip=("parent", "alloc")):
    """x's state as plain values: dataclasses as dicts, objects by their
    attributes (less back-references), containers element-wise."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _state(getattr(x, f.name), skip)
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _state(v, skip) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_state(v, skip) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _state(v, skip) for k, v in vars(x).items()
                if k not in skip}
    if hasattr(type(x), "__slots__"):          # the radix tree's nodes
        return {k: _state(getattr(x, k), skip) for k in type(x).__slots__
                if k not in skip}
    return x


def _alloc_cfg(mod, n_layers=4, kv=64 * 1024):
    return mod.AllocatorConfig(
        total_bytes=2 * 1024 ** 3, n_layers=n_layers,
        kv_bytes_per_token=kv, max_bs=16, qos_s=0.04, swap_time_s=0.002)


def _pair_allocators():
    return (JAL.UnifiedAllocator(_alloc_cfg(JAL)),
            TAL.UnifiedAllocator(_alloc_cfg(TAL)))


def _allocator_ops(rng, n):
    """(method name, args) of a seeded sequence over every operation."""
    kinds = ("kv_alloc_tokens", "kv_free_tokens", "resize_window",
             "pressure_shrink", "prefix_reserve", "adapter_reserve",
             "adapter_release", "snapshot", "small_alloc", "small_free")
    for i in range(n):
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == "kv_alloc_tokens":
            yield kind, (int(rng.integers(1, 3000)),)
        elif kind == "kv_free_tokens":
            yield kind, (int(rng.integers(1, 3000)),)
        elif kind in ("resize_window", "prefix_reserve", "adapter_reserve",
                      "adapter_release"):
            yield kind, (int(rng.integers(0, 12)),)
        elif kind == "snapshot":
            yield kind, (float(i) * 0.01,)
        elif kind == "small_alloc":
            yield kind, (int(rng.integers(1, 4 * 1024 ** 2)),)
        elif kind == "pressure_shrink":
            yield kind, ()
        else:
            yield kind, (int(rng.integers(1 << 30)),)


def _apply(alloc, kind, args, small_offsets):
    if kind == "adapter_release":
        return alloc.adapter_release(min(args[0], alloc.adapter_chunks))
    if kind == "small_alloc":
        off = alloc.small.alloc(*args)
        if off is not None:
            small_offsets.append(off)
        return off
    if kind == "small_free":
        if not small_offsets:
            return None
        return alloc.small.freeb(small_offsets.pop(args[0] %
                                                   len(small_offsets)))
    return getattr(alloc, kind)(*args)


@pytest.mark.parametrize("seed", SEEDS)
def test_unified_allocator_matches_reference(seed):
    ref, port = _pair_allocators()
    offs_ref, offs_port = [], []
    ops = list(_allocator_ops(np.random.default_rng(seed), STEPS))
    for i, (kind, args) in enumerate(ops):
        got = _apply(port, kind, args, offs_port)
        want = _apply(ref, kind, args, offs_ref)
        assert got == want, (i, kind, args)
        assert _state(port) == _state(ref), (i, kind, args)
        port.check_invariants()
    assert port.timeline and port.timeline == ref.timeline
    assert (port.free_chunks, port.reserved_chunks, port.adapter_leak,
            port.window_capacity_chunks()) == \
        (ref.free_chunks, ref.reserved_chunks, ref.adapter_leak,
         ref.window_capacity_chunks())


@pytest.mark.parametrize("seed", SEEDS)
def test_buddy_allocator_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = JBD.BuddyAllocator(1 << 22), TBD.BuddyAllocator(1 << 22)
    live = []
    for i in range(STEPS):
        if live and rng.random() < 0.45:
            off = live.pop(int(rng.integers(len(live))))
            assert port.freeb(off) == ref.freeb(off)
        else:
            size = int(rng.integers(1, 1 << 19))
            got, want = port.alloc(size), ref.alloc(size)
            assert got == want, (i, size)
            if got is not None:
                live.append(got)
        assert _state(port) == _state(ref), i
        assert port.fragmentation_bytes == ref.fragmentation_bytes
        port.check_invariants()


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_cache_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref_alloc, port_alloc = _pair_allocators()
    cfg = dict(chunks=6, min_hit_tokens=16)
    ref = JPC.PrefixCache(JPC.PrefixCacheConfig(**cfg), ref_alloc)
    port = TPC.PrefixCache(TPC.PrefixCacheConfig(**cfg), port_alloc)
    assert port.granted_chunks == ref.granted_chunks > 0
    for i in range(STEPS):
        sid = int(rng.integers(8))
        n = int(rng.integers(8, 2000))
        # shared leading segments half of the time (the radix path)
        segs = () if rng.random() < 0.5 else (
            (int(rng.integers(3)), int(rng.integers(1, 400))),
            (1000 + sid, n))
        op = int(rng.integers(5))
        if op == 0:
            args = (sid, n, segs)
            assert port.lookup(*args) == ref.lookup(*args), i
        elif op == 1:
            args = (sid, n, segs)
            assert port.peek(*args) == ref.peek(*args), i
        elif op == 2 and ref.stats.hits:
            hit = int(rng.integers(1, 64))
            port.revoke(hit)
            ref.revoke(hit)
        elif op == 3 and rng.random() < 0.05:
            port.invalidate_all()
            ref.invalidate_all()
        else:
            port.insert(sid, n, segments=segs)
            ref.insert(sid, n, segments=segs)
        assert _state(port) == _state(ref), (i, op)
        assert (len(port), port.used_tokens) == (len(ref), ref.used_tokens)
        port.check_invariants()
    assert _state(port_alloc) == _state(ref_alloc)


@pytest.mark.parametrize("seed", SEEDS)
def test_adapter_pool_matches_reference(seed):
    rng = np.random.default_rng(seed)
    cfg_ref = jconfigs.get_config("llama3-8b")
    cfg_port = tconfigs.get_config("llama3-8b")
    assert TAD.adapter_bytes(cfg_port, 16) == JAD.adapter_bytes(cfg_ref, 16)
    ref_alloc, port_alloc = _pair_allocators()
    geo = dict(chunks=3, load_time_s=0.004, max_loaded=4)
    ref = JAD.AdapterPool(ref_alloc, JAD.InstanceAdapterConfig(**geo))
    port = TAD.AdapterPool(port_alloc, TAD.InstanceAdapterConfig(**geo))
    reg_ref, reg_port = JAD.AdapterRegistry(), TAD.AdapterRegistry()
    for i in range(STEPS):
        aid, ver = int(rng.integers(-1, 7)), int(rng.integers(1, 4))
        op = int(rng.integers(6))
        if op <= 2:
            port.require(aid, ver)
            ref.require(aid, ver)
        elif op == 3:
            in_use = {int(a) for a in rng.integers(0, 7, size=2)}
            assert port.take_load_time(in_use) == \
                ref.take_load_time(in_use), i
        elif op == 4:
            args = (max(aid, 0), ver, i * 0.5)
            assert reg_port.publish(*args) == reg_ref.publish(*args)
            assert reg_port.latest(args[0]) == reg_ref.latest(args[0])
        elif rng.random() < 0.1:
            port.evict_all()
            ref.evict_all()
        else:
            # the KV side takes memory from under the pool
            n = int(rng.integers(1, 4000))
            assert port_alloc.kv_alloc_tokens(n) == \
                ref_alloc.kv_alloc_tokens(n)
        assert port.has(max(aid, 0), ver) == ref.has(max(aid, 0), ver)
        assert _state(port) == _state(ref), (i, op)
        assert _state(port_alloc) == _state(ref_alloc), (i, op)
        port_alloc.check_invariants()
    assert _state(reg_port) == _state(reg_ref)
    assert port.loads == ref.loads > 0
