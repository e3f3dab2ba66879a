"""Logical-axis sharding for the whole model zoo, on a torch DeviceMesh.

Port of `repro/distributed/sharding.py`. Models annotate activations with
*logical* axis names (`constrain`); a mesh-rules context (`use_mesh`)
resolves them to mesh axes and lays the tensor out as a DTensor with those
placements. Without an active context every `constrain` returns its input
unchanged, so all model code runs as before on one card, CUDA graphs
included.

A layout is a `Spec`, the port's `PartitionSpec`: one entry per tensor dim,
each a mesh-axis name, a tuple of them, or None (replicated); missing
trailing entries are None. `placements` turns it into DTensor placements:
a dim sharded over several mesh axes, such as ("pod", "data"), is a
`Shard(dim)` on each of those mesh dims (their order is the mesh's, the
outer axis major, as in a `PartitionSpec`).

Parallelism mapping (production mesh):
  batch   -> ("pod", "data")   pure DP (pod axis crosses pods)
  heads / kv_heads / ff / expert / vocab -> "model"   TP / EP
  seq_sp  -> "model"           sequence-parallel residual stream between layers
  rank    -> None              LoRA rank stays replicated (tiny)

Under `use_mesh`, a plain tensor that meets a DTensor counts as replicated
(`implicit_replication`): the positions, masks and index tensors the models
make with `torch.arange` are the same on every rank, as a constant is under
GSPMD. The few ops that DTensor cannot run on their inputs' layouts
(`REPLICATED_OPS`, `UNEVEN_VIEW_OPS`) run replicated, in one place
(`_ReplicatedFallback`): their inputs are gathered before them, as GSPMD
does with an op it cannot partition, and `FALLBACKS` counts each by name.
Any other op that DTensor refuses raises.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.tree import tree_leaves, tree_map

Axis = Union[str, Tuple[str, ...], None]

# Default logical->mesh rules for the production meshes. "pod" is folded into
# the batch axes only when the mesh has one.
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,          # sequence dim of *inputs* stays replicated-within-dp
    "seq_sp": "model",    # sequence-parallel residual stream
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "q_per_kv": None,
    "head_dim": None,
    "ff": "model",
    "expert": ("data", "model"),   # full EP when E divides (deepseek: 256)
    "expert_cap": None,
    "vocab": "model",
    "rank": None,
    "layers": None,
    "kv_seq": None,       # KV-cache sequence dim
    "state": None,
    "pages": ("pod", "data"),
}

# FSDP strategy: activations purely batch-sharded over every axis; weights
# fully sharded, gathered per layer on use.
FSDP_RULES: Dict[str, Axis] = {k: None for k in DEFAULT_RULES}
FSDP_RULES["batch"] = ("pod", "data", "model")
FSDP_RULES["pages"] = ("pod", "data")


class Spec(tuple):
    """A tensor's layout: one mesh axis (a name, a tuple of names, or None)
    per dim, like `jax.sharding.PartitionSpec`, which it also follows in
    writing a one-name tuple as the name and an empty one as None."""

    def __new__(cls, *dims: Axis):
        def canon(d):
            if isinstance(d, tuple) and len(d) <= 1:
                return d[0] if d else None
            return d
        return super().__new__(cls, (canon(d) for d in dims))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec: Sequence[Axis], ndim: int):
    """DTensor placements over `mesh` of a rank-`ndim` tensor laid out by
    `spec`: Shard(dim) on every mesh dim that some tensor dim names,
    Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axis in enumerate(tuple(spec)[:ndim]):
        axes = () if axis is None else (axis,) if isinstance(axis, str) \
            else tuple(axis)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} of {tuple(spec)}: the axes {axes} "
                             f"are not in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims of "
                                 f"{tuple(spec)}")
            out[i] = Shard(dim)
    return out


def distribute(x: torch.Tensor, mesh, spec: Sequence[Axis]):
    """x, the same full tensor on every rank, as a DTensor laid out by
    `spec` (each rank keeps its shard: no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements(mesh, spec, x.ndim),
                             src_data_rank=None)


def write_slots(cache: dict, slots, entries: dict) -> None:
    """cache[name][b, slots[b, j]] = entries[name][b, j] for every entry,
    row b and token j, in place: decode's cache write. Each buffer is
    (B, S, ...), slots (B, s) int64, each entry (B, s, ...). Plain
    tensors take one `index_put_` each, all with one row index. A DTensor
    laid out as `partitioning.cache_specs` lays a cache out (batch on the
    data axes, sequence on "model"), whose in-place `index_put_` DTensor
    refuses, is written block by block (`_write_sharded`)."""
    if not any(hasattr(cache[name], "placements") for name in entries):
        bidx = torch.arange(slots.shape[0], device=slots.device)[:, None]
        for name, t in entries.items():
            cache[name][bidx, slots] = t.to(cache[name].dtype)
        return
    for name, t in entries.items():
        _write_sharded(cache[name], slots, t)


def _write_sharded(buf, slots, values) -> None:
    """`write_slots` of one DTensor buffer, block by block (`local_map`):
    each rank takes the rows of the slots and values that its batch block
    holds, and writes of them only the tokens whose slot falls in its own
    sequence range, with no host read. The values are gathered along the
    sequence axes (decode's new token is replicated there already); the
    buffer never moves, as GSPMD's partitioned `.at[].set` leaves it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = buf.device_mesh
    if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(1)))
           for p in buf.placements):
        raise ValueError(f"write_slots: a buffer laid out {buf.placements}; "
                         "only the batch and sequence dims may be sharded")
    rows = tuple(p if p == Shard(0) else Replicate() for p in buf.placements)
    # the first slot of this rank's sequence block (the outer mesh dim
    # major, as DTensor splits a dim over several mesh dims)
    n, first = buf.shape[1], 0
    coord = mesh.get_coordinate()
    for i, p in enumerate(buf.placements):
        if p == Shard(1):
            if n % mesh.size(i):
                raise ValueError(f"write_slots: {buf.shape[1]} slots do "
                                 f"not split evenly over {mesh.shape}")
            n //= mesh.size(i)
            first += coord[i] * n

    def dt(x):
        return x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local_map(_write_block, out_placements=(buf.placements,),
              in_placements=(buf.placements, rows, rows, None),
              device_mesh=mesh, redistribute_inputs=True)(
        buf, dt(slots), dt(values), first)


def _write_block(buf, slots, values, first: int):
    """`write_slots` on one rank's block: buf (b, n, ...) holds slots
    first..first+n-1 of its b rows; a token whose slot lies outside them
    writes the slot's own value back (a clamped index, so no row reads
    its slot from the host). One column of tokens at a time, so that no
    (row, slot) pair repeats within one `index_put_`."""
    n = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    for j in range(slots.shape[1]):
        local = slots[:, j] - first
        inside = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        keep = inside.reshape((-1,) + (1,) * (values.ndim - 2))
        buf[rows, local] = torch.where(keep, values[:, j].to(buf.dtype),
                                       buf[rows, local])
    return buf


# ----------------------------------------------- the replicated fallback --
# op name -> times it ran replicated under `use_mesh` (what the tests list)
FALLBACKS: Counter = Counter()
# ops that always run replicated. The scatters take an index that may be
# smaller than their target, so DTensor's local op, given a batch-sharded
# index and a replicated target, writes the wrong rows without an error;
# DTensor's vocab-parallel `gather` leaves a masked partial sum that a
# later redistribution cannot reduce.
REPLICATED_OPS = frozenset({"gather", "scatter", "scatter_", "scatter_add",
                            "scatter_add_", "scatter_reduce",
                            "scatter_reduce_"})
# ops that run replicated only where DTensor refuses their layouts: a
# reshape that would split a sharded dim unevenly (qwen3's and mixtral's
# column-sharded heads at smoke size on a 4-way model axis; it runs
# through `_Reshape`, so that its backward does the same), and a product
# whose batch dims it cannot fold into rows: torch 2.11's DTensor refuses
# to flatten a sharded dim (a sequence-parallel activation (B, S, d) laid
# out on S, going into `x @ w`), which 2.13's lays out as a strided shard
UNEVEN_VIEW_OPS = frozenset({"reshape", "__matmul__", "matmul"})


def _in_place(name: str) -> bool:
    return name.endswith("_") and not name.endswith("__")


def _reshape(x, shape):
    """A DTensor's reshape, replicated where DTensor refuses its layout."""
    from torch.distributed.tensor import DTensor, Replicate
    try:
        return x.reshape(shape)
    except RuntimeError:
        pass
    FALLBACKS["reshape"] += 1
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    full = x.redistribute(mesh, rep).to_local().reshape(shape)
    return DTensor.from_local(full, mesh, rep, run_check=False)


class _Reshape(torch.autograd.Function):
    """`_reshape`, whose backward reshapes the gradient back the same way.
    Autograd's own backward of a reshape that DTensor ran is a view of the
    gradient, which fails where the gradient is laid out on a dim that the
    forward merged and the view splits unevenly: qwen3-14b's attention
    output (40 heads merged, then laid out over a 16-way axis by the o
    projection) on the 2x16x16 mesh."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = x.shape
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape(grad, ctx.shape), None


def _shape_arg(args, kwargs):
    """The target shape of `x.reshape(...)` or `torch.reshape(x, ...)`."""
    shape = kwargs["shape"] if "shape" in kwargs else \
        args[1] if len(args) == 2 else args[1:]
    return (shape,) if isinstance(shape, int) else tuple(shape)


class _ReplicatedFallback(TorchFunctionMode):
    """The named ops that DTensor cannot run on their inputs' layouts run
    replicated: every DTensor input is redistributed to Replicate(), the
    op runs on the local, full tensors, and its tensor outputs come back
    as replicated DTensors. GSPMD does the same with an op it cannot
    partition. The values are the op's own; the redistributions are
    differentiable, so the backward pass follows. An in-place op writes a
    full copy of its target, which is then copied back into the target in
    its layout. `REPLICATED_OPS` always run so; `UNEVEN_VIEW_OPS` only
    after DTensor refused them; any other op's failure is raised."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        leaves = tree_leaves((args, kwargs))
        dts = [x for x in leaves if isinstance(x, DTensor)]
        if not dts:
            return func(*args, **kwargs)
        mesh = dts[0].device_mesh
        rep = [Replicate()] * mesh.ndim

        def wrap(x):
            if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                return DTensor.from_local(x, mesh, rep, run_check=False)
            return x
        if len(dts) < sum(isinstance(x, torch.Tensor) for x in leaves):
            # a plain tensor beside a DTensor is replicated: wrapped here,
            # so that the backward pass sees DTensors only
            args, kwargs = tree_map(wrap, args), tree_map(wrap, kwargs)
        if name == "reshape" and isinstance(args[0], DTensor):
            return _Reshape.apply(args[0], _shape_arg(args, kwargs))
        if name not in REPLICATED_OPS:
            if name not in UNEVEN_VIEW_OPS:
                return func(*args, **kwargs)
            try:
                return func(*args, **kwargs)
            except RuntimeError:
                pass
        FALLBACKS[name] += 1

        def local(x):
            if isinstance(x, DTensor):
                return x.redistribute(x.device_mesh, rep).to_local()
            return x
        out = tree_map(wrap, func(*tree_map(local, args),
                                  **tree_map(local, kwargs)))
        if not _in_place(name):
            return out
        # the op wrote a full copy of its target: copy it back, laid out
        # as the target is
        target = args[0]
        target.copy_(out.redistribute(mesh, target.placements))
        return target


# ---------------------------------------------------------- mesh context --
class _MeshCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Axis] = {}


_CTX = _MeshCtx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axis]] = None):
    """Install a mesh + logical-axis rules for the models; plain tensors
    meeting DTensors count as replicated inside."""
    rules = DEFAULT_RULES if rules is None else rules
    # Drop rules that reference axes absent from this mesh.
    resolved = {k: _present(mesh, v) for k, v in rules.items()}
    with _installed(mesh, resolved):
        yield


@contextlib.contextmanager
def _installed(mesh, resolved: Dict[str, Axis]):
    from torch.distributed.tensor.experimental import implicit_replication
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, resolved
    try:
        with implicit_replication(), _ReplicatedFallback():
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current():
    """The mesh context now active, as a context manager to re-enter it
    later: the autograd engine runs a custom Function's backward and a
    checkpoint's recompute without the mesh context, the fallback and the
    implicit replication that their forward ran under. A null context
    without a mesh."""
    if _CTX.mesh is None:
        return contextlib.nullcontext()
    return _installed(_CTX.mesh, dict(_CTX.rules))


def checkpoint_contexts():
    """`context_fn` of `torch.utils.checkpoint`: the recompute runs under
    the forward's mesh context (`current`)."""
    return contextlib.nullcontext(), current()


def active_mesh():
    return _CTX.mesh


def resolve(logical: Sequence[Optional[str]]) -> Spec:
    return Spec(*(None if name is None else _CTX.rules.get(name)
                  for name in logical))


def _present(mesh, axis: Axis) -> Axis:
    """axis restricted to the mesh's axes (None if none is left)."""
    names = set(mesh.mesh_dim_names)
    if not axis:
        return None
    if isinstance(axis, str):
        return axis if axis in names else None
    kept = tuple(a for a in axis if a in names)
    return kept if kept else None


def _axis_size(mesh, axis: Axis) -> int:
    if not axis:
        return 1
    if isinstance(axis, str):
        return mesh_sizes(mesh)[axis]
    n = 1
    for a in axis:
        n *= _axis_size(mesh, a)
    return n


def _fit(mesh, dim: int, axis: Axis) -> Axis:
    """axis (restricted to the mesh's axes) if it splits dim evenly over
    more than one rank, else None (replicated)."""
    axis = _present(mesh, axis)
    if axis is None:
        return None
    n = _axis_size(mesh, axis)
    return axis if (n > 1 and dim % n == 0) else None


def constrain(x, logical: Sequence[Optional[str]]):
    """Lay x out by logical axis names; x itself without a mesh.
    Axes that do not divide the dimension evenly are dropped (replicated) —
    e.g. mixtral's 8 experts on a 16-way model axis."""
    if _CTX.mesh is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs logical "
                         f"{logical}")
    from torch.distributed.tensor import DTensor, Replicate
    mesh = _CTX.mesh
    spec = resolve(logical)
    fixed = []
    used: set = set()
    for dim, axis in zip(x.shape, tuple(spec) + (None,) * (x.ndim - len(spec))):
        # a mesh axis may appear on at most one dim: first dim wins
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a not in used) or None
            if isinstance(axis, tuple) and len(axis) == 1:
                axis = axis[0]
        elif axis in used:
            axis = None
        keep = _fit(mesh, dim, axis)
        if keep is not None:
            used.update(keep if isinstance(keep, tuple) else (keep,))
        fixed.append(keep)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    # A redistribution leaves its local result contiguous but keeps the
    # global strides. Given a transposed tensor, or in the backward pass
    # a transposed gradient, its result is a shard laid out unlike its
    # global view; DTensor refuses a later view of it, and a reshape then
    # runs replicated, gathering the whole activation (deepseek-v3's MoE
    # layout, forward and backward): both go in contiguous.
    y = x.contiguous().redistribute(mesh, placements(mesh, fixed, x.ndim))
    if y.requires_grad:
        y.register_hook(torch.Tensor.contiguous)
    return y


def named_sharding(logical: Sequence[Optional[str]]):
    """The active mesh's placements for these logical axes (None without
    a mesh)."""
    if _CTX.mesh is None:
        return None
    return placements(_CTX.mesh, resolve(logical), len(logical))


def sharding_for(mesh, spec: Sequence[Axis], ndim: Optional[int] = None):
    """The placements of `spec` over `mesh` (rank `ndim`, `len(spec)` by
    default)."""
    return placements(mesh, spec, len(spec) if ndim is None else ndim)
