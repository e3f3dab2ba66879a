"""CUDA graphs: the port's counterpart of the reference's `jax.jit`.

The reference jits its decode step and compiles one program per quantum
level k (`repro/core/colocation.py`). On the card the port captures the
decode step once (`serving/engine.py::DecodeGraph`) and one graph per
finetune unit (`core/colocation.py::GraphedUnits`) and replays them, so a
round costs the host a few graph launches in place of some 2,600 kernel
launches. Eager rounds stay: on the CPU, where CUDA graphs do not exist,
and where a caller asks for them (`resolve`).

Capture: the caller warms each body up for real on a side stream
(`on_side_stream`), puts back what the warm-up changed (`snapshot`,
`restore`), then `capture`s it into a memory pool that all the graphs of
one owner share: the co-located runner's decode graph and its unit graphs
take one pool (`torch.cuda.graph_pool_handle()`), which lives as long as
they do (PyTorch refuses a capture into a pool whose graphs are all
gone, so a pool is not kept beyond its owner).

The shared pool is safe by one invariant: no graph leaves a tensor in the
pool behind it. Everything a graph reads or writes beyond its own replay
(its static inputs and outputs, the cache, the finetune state) was
allocated outside any capture, and the graph writes its results into those
tensors in place. The pool then holds only temporaries that die within a
replay, so the graphs can share it and replay in any order, one at a time
on one stream. That is why the unit engine updates its state in place
(`training/peft.py`).

Kernel counters: the kernel wrappers count launches on the host, when they
are called, and `models/attention.py` counts the int8 caches' oracle
decodes. Capture calls them without launching anything, so `capture`
takes the counts that moved back out, and `Graph.replay` adds them again
at every replay: the counters keep counting device launches.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _k1
from repro_torch.kernels import lora_matmul as _k2
from repro_torch.kernels import ssd_scan as _k3
from repro_torch.models import attention as _attn
from repro_torch.tree import tree_leaves

_COUNTED = (_k1, _k2, _k3, _attn)


def resolve(graphs: Optional[bool], device) -> bool:
    """Whether an entry point replays CUDA graphs: by default on a CUDA
    device and never on the CPU. Asking for graphs off the card raises."""
    dev = torch.device(device)
    if graphs is None:
        return dev.type == "cuda"
    if graphs and dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}; pass "
                         "graphs=False (or leave it unset) for eager rounds")
    return bool(graphs)


def _counts() -> Dict[Tuple[object, str], int]:
    return {(m, n): getattr(m, n) for m in _COUNTED for n in m.COUNTERS}


class Graph:
    """A captured graph and the kernel launches it makes at each replay."""

    def __init__(self, graph: torch.cuda.CUDAGraph,
                 launches: Dict[Tuple[object, str], int]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for (mod, name), n in self.launches.items():
            setattr(mod, name, getattr(mod, name) + n)


def capture(fn: Callable[[], object], pool: tuple) -> Graph:
    """Capture `fn` (warmed up already) into `pool`. A failed capture
    raises; nothing falls back to eager rounds."""
    before = _counts()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, pool=pool):
            fn()
        moved = {k: n - before[k] for k, n in _counts().items()
                 if n != before[k]}
    finally:
        for (mod, name), n in before.items():
            setattr(mod, name, n)
    if any(name == "PLAIN_CALLS" for _, name in moved):
        raise RuntimeError("a kernel's plain version was captured in a CUDA "
                           "graph")
    return Graph(g, moved)


def measured(precompile: Callable[[], object], device
             ) -> Tuple[float, int, int]:
    """Run a capture (`precompile`) and return its seconds and the growth
    of allocated memory (the static buffers) and of reserved memory (with
    the graphs' pool), both read after `empty_cache`, which keeps the
    segments of a live graph's pool."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    alloc = torch.cuda.memory_allocated(device)
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    precompile()
    torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return (secs, torch.cuda.memory_allocated(device) - alloc,
            torch.cuda.memory_reserved(device) - reserved)


def on_side_stream(fn: Callable[[], object]) -> None:
    """Run `fn` for real on a side stream, ordered after and before the
    current stream's work (the warm-up `torch.cuda.graph` asks for)."""
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)


def snapshot(tree) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(tensor, copy) for every tensor of `tree`, to undo a warm-up."""
    return [(t, t.clone()) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def restore(snap: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    for t, saved in snap:
        t.copy_(saved)


def addresses(tree) -> List[int]:
    """The data pointers of `tree`'s tensors: what a graph captured on it
    reads and writes."""
    return [t.data_ptr() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]
