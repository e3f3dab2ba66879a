"""Per-device step analysis: the port's counterpart of
`repro/launch/hlo_analysis.py`.

The reference reads its numbers out of XLA's compiled HLO text: matmul
FLOPs from the `dot` ops, collective bytes from the collectives' result
shapes, loop bodies multiplied by their trip counts, and the memory from
`compiled.memory_analysis()`. The port has no compiled program: it runs the
step eagerly, in the dry-run on meta tensors (shapes and dtypes, no memory,
no arithmetic) laid out as DTensors over the `fake` process group, and
`analyze()` watches it with one TorchDispatchMode (`StepAnalysis`). A
DTensor op is passed on to DTensor (the mode returns NotImplemented for
it, as `torch.distributed._tools.mem_tracker.MemTracker` does), which runs
it as ops on the local shards and the collectives its layouts need; the
mode counts those. So every number is PER DEVICE, as the reference's are
(the SPMD module is per partition):

  dot_flops          2 x M x N x K of every matrix product the local shards
                     run (the ops `torch.utils.flop_counter` knows: mm,
                     addmm, bmm, baddbmm, SDPA, ...), forward, backward and
                     every recompute alike;
  collective_bytes   the result size of each collective, by the reference's
  collective_counts  kinds (`COLLECTIVES`), from the `_c10d_functional` ops
                     that DTensor issues (and `_dtensor.shard_dim_alltoall`);
                     any other c10d op raises, so none goes uncounted;
  memory             argument bytes: the local storages of the step's inputs;
                     output bytes: those of its outputs; alias bytes: the
                     outputs that are inputs updated in place (the reference
                     donates the cache, the adapters and the optimizer state,
                     `dryrun.py:173-176`); temp bytes: the peak of the
                     storages the step allocated and still held, less the
                     bytes of its outputs that it allocated. So argument +
                     output + temp - alias, the reference's resident sum, is
                     the step's peak above what was allocated before its
                     inputs.

What has no counterpart in eager torch is left out: loop trip counts (the
layer loop is Python, so each op is seen as often as it runs),
`cpu_bf16_upcast_bytes` (XLA's CPU backend legalizes bf16 dots through f32
weight copies; eager torch makes none) and `total_tpu` (no f32 collectives
carry legalized bf16 data). A storage's bytes are counted from its first
sight to its release by Python's reference counting (weak references, as
`MemTracker` tracks storages), not by the caching allocator's rounding or
the workspaces that kernels take inside one op. One exception: the
result of `_dtensor.shard_dim_alltoall` counts its own bytes, not its
storage's. Its meta kernel concatenates one copy of the input per rank of
the group and returns that rank's chunk, a view of a storage the size of
the whole gathered dim; NCCL's all-to-all returns a buffer the size of
its input.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# schema name -> the reference's kind
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
# schema names of the c10d namespaces that move no data: each returns its
# input (on the meta device as a new tensor, which is not counted again)
_NOT_COLLECTIVES = frozenset({"_c10d_functional::wait_tensor",
                              "_c10d_functional::_wrap_tensor_autograd"})


@dataclasses.dataclass
class StepStats:
    dot_flops: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0        # the peak of what the step allocated and held

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    @property
    def resident_bytes(self) -> int:
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)

    def as_dict(self) -> Dict[str, Any]:
        """The reference's `HloStats.as_dict` keys that have a counterpart."""
        return {"dot_flops": self.dot_flops,
                "collective_bytes": dict(self.collective_bytes,
                                         total=self.collective_total),
                "collective_counts": dict(self.collective_counts)}

    def memory(self) -> Dict[str, int]:
        """The reference's `memory_analysis()` keys, and the resident sum."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.temp_bytes,
                "alias_size_in_bytes": self.alias_bytes,
                "resident_bytes": self.resident_bytes}


def local_tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree, each DTensor as its local shard."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            yield x.to_local() if hasattr(x, "placements") else x


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of a tree's local tensors, each storage once."""
    out = {}
    for t in local_tensors(tree):
        st = t.untyped_storage()
        out[_key(st)] = st.nbytes()
    return out


def _key(st) -> int:
    """A storage's identity: its address, or for a meta storage (which has
    none) its Python object's, which lives as long as the storage."""
    return id(st) if st.device.type == "meta" else st.data_ptr()


def _passed_on_types():
    """The tensor types the mode leaves to their own dispatch: DTensor and
    a collective's pending result, which run their ops on local tensors
    (counted then), and fake tensors, on which DTensor's sharding
    propagation runs an op of the global shapes the first time it meets a
    layout (never counted)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    return (DTensor, AsyncCollectiveTensor), FakeTensor


class StepAnalysis(TorchDispatchMode):
    """Counts the ops on local tensors (see the module's docstring); use
    it through `analyze`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.wrappers, self.fake = _passed_on_types()
        self.stats = StepStats()
        self.arguments: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self.outputs: Dict[int, int] = {}

    def hold_arguments(self, args) -> None:
        self.arguments.update(_storages(args))

    def returned(self, out):
        """Record the step's outputs; returns them."""
        self.outputs = _storages(out)
        return out

    def finish(self) -> None:
        st = self.stats
        st.argument_bytes = sum(self.arguments.values())
        st.output_bytes = sum(self.outputs.values())
        st.alias_bytes = sum(n for k, n in self.outputs.items()
                             if k in self.arguments)
        st.peak_bytes = self.peak
        st.temp_bytes = max(self.peak - (st.output_bytes - st.alias_bytes),
                            0)

    def _release(self, key: int, nbytes: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, out, own_bytes: bool = False) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or \
                    isinstance(t, self.wrappers):
                continue
            st = t.untyped_storage()
            key = _key(st)
            if key in self._held or key in self.arguments:
                continue
            n = t.numel() * t.element_size() if own_bytes else st.nbytes()
            self._held[key] = n
            self.live += n
            weakref.finalize(st, self._release, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.wrappers) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in _NOT_COLLECTIVES or any(
                issubclass(t, self.fake) for t in types) or any(
                isinstance(t, self.fake) for t in tree_leaves(out)):
            return out
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            self.stats.collective_bytes[kind] += sum(
                t.numel() * t.element_size() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
            self.stats.collective_counts[kind] += 1
        elif name.split("::")[0] in ("c10d", "_c10d_functional",
                                     "_dtensor"):
            raise NotImplementedError(f"step_analysis: {name} is a "
                                      "collective it does not count")
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.stats.dot_flops += self.flop_registry[packet](
                *args, **kwargs, out_val=out)
        self._track(out, own_bytes=name == "_dtensor::shard_dim_alltoall")
        return out


@contextlib.contextmanager
def analyze(args) -> Iterator[StepAnalysis]:
    """Count a step run inside: `with analyze(args) as a: out =
    a.returned(step(*args))`; then `a.stats` holds the counts (`run_step`
    does just that)."""
    mode = StepAnalysis()
    mode.hold_arguments(args)
    with mode:
        yield mode
    mode.finish()


def run_step(step, args):
    """(out, StepStats) of `step(*args)` run under the counters, on
    whatever device its inputs lie (meta in the dry-run, the card in
    `chip_smoke.py`'s check of the counts)."""
    with analyze(args) as a:
        out = a.returned(step(*args))
    return out, a.stats
