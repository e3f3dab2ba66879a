"""Parameter / cache / batch partitioning rules for the production mesh.

Port of `repro/distributed/partitioning.py`, over a torch DeviceMesh and
the port's own trees (whose leaf paths are the reference's, `interop.py`).
Path-based rules with divisibility fallback: every dim annotated with a
mesh axis must divide evenly, otherwise that dim falls back to replication
(e.g. mamba2's vocab 50280 is not 16-divisible -> embed replicated).

Strategy: DP on ("pod","data") for batch dims; TP on "model" for
head/ff/expert/vocab dims; the KV cache shards its *sequence* dim on
"model"; SP on the residual stream for training. A spec tree mirrors its
tree with a `sharding.Spec` at every leaf; `to_named` lays a tree out as
DTensors by it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.distributed.sharding import Spec, _fit, distribute
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...] = ("pod", "data")   # batch axes
    tp: str = "model"

    def present(self, mesh) -> "MeshAxes":
        names = set(mesh.mesh_dim_names)
        return MeshAxes(dp=tuple(a for a in self.dp if a in names),
                        tp=self.tp if self.tp in names else "")


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh, ax: MeshAxes,
               stacked: bool, tied: bool = False) -> Spec:
    """Spec of a parameter leaf identified by its tree path."""
    tp = ax.tp
    dims: list = [None] * len(shape)
    body = shape[1:] if stacked else shape
    off = 1 if stacked else 0

    def col(i):   # shard output/column dim
        dims[off + i] = _fit(mesh, body[i], tp)

    name = path.split("/")[-1]
    if name == "embed":
        if tied:
            col(0)           # (V, d): vocab-sharded (serves logits too)
        else:
            col(1)           # d-sharded: token lookup stays gather-local
    elif name == "unembed":
        col(0)                                     # (V, d): vocab (logits)
    elif name in ("wq", "wk", "wv", "wq_b", "wkv_b", "in_y", "in_x",
                  "in_proj"):
        col(len(body) - 1)                         # (d, out): out dim
    elif name in ("wo", "out_proj"):
        col(0)                                     # (in, d): in dim
    elif name in ("gate", "up", "down") and len(body) == 3:
        # MoE expert weights: (E, d, ff) or (E, ff, d). Expert-parallel over
        # as many axes as E divides; remaining axes shard the ff dim so the
        # footprint always spreads over the whole mesh (deepseek-v3: EP=256;
        # mixtral: E=8 -> d/ff 2D sharding).
        ff_i = 2 if name in ("gate", "up") else 1
        d_i = 1 if name in ("gate", "up") else 2
        full_ep = _fit(mesh, body[0], ("data", "model"))
        if full_ep is not None:
            dims[off + 0] = full_ep
        elif _fit(mesh, body[0], tp) is not None:
            dims[off + 0] = tp
            dims[off + ff_i] = _fit(mesh, body[ff_i], "data")
        else:
            dims[off + ff_i] = _fit(mesh, body[ff_i], tp)
            dims[off + d_i] = _fit(mesh, body[d_i], "data")
    elif name in ("gate", "up"):
        col(1)                                     # (d, ff)
    elif name == "down":
        col(0)                                     # (ff, d)
    elif name == "router":
        col(len(body) - 1)                         # (d, E)
    elif name in ("conv_w",):
        col(len(body) - 1)                         # (w, channels)
    elif name in ("conv_b", "gate_norm", "lamb"):
        col(0) if len(body) == 1 and body[0] >= 128 else None
    elif name in ("gate_a", "gate_x"):
        col(0)                                     # (nb, bs, bs): blocks
    elif name == "proj":                           # mtp (2d, d)
        col(1)
    elif name in ("wq_a", "wkv_a"):
        col(len(body) - 1)
    # everything else (norms, A_log, dt_bias, D, q_norm, ...) replicated
    return Spec(*dims)


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params, mesh, axes: MeshAxes = MeshAxes()):
    """Spec tree mirroring `model.init_params`' output."""
    ax = axes.present(mesh)

    def spec(path, leaf):
        stacked = ("scan" in path.split("/")) and leaf.ndim >= 1
        return _leaf_spec(path, tuple(leaf.shape), mesh, ax, stacked,
                          tied=cfg.tie_embeddings)

    return _walk(params, spec)


def fsdp_param_specs(cfg: ModelConfig, params, mesh):
    """Fully-sharded weights: every leaf sharded on its largest divisible
    dim over the flattened mesh (then progressively fewer axes)."""
    axis_opts = [("pod", "data", "model"), ("data", "model"),
                 ("model",), ("data",)]

    def spec(path, leaf):
        stacked = ("scan" in path.split("/")) and leaf.ndim >= 2
        off = 1 if stacked else 0
        body = tuple(leaf.shape)[off:]
        dims = [None] * leaf.ndim
        if not body:
            return Spec(*dims)
        # largest dim first
        order = sorted(range(len(body)), key=lambda i: -body[i])
        for ax in axis_opts:
            fit = next((i for i in order
                        if _fit(mesh, body[i], ax) is not None), None)
            if fit is not None:
                dims[off + fit] = _fit(mesh, body[fit], ax)
                return Spec(*dims)
        return Spec(*dims)

    return _walk(params, spec)


def adapter_specs(cfg: ModelConfig, adapters, mesh,
                  axes: MeshAxes = MeshAxes()):
    """LoRA adapters are tiny: replicate everything."""
    return _walk(adapters, lambda path, leaf: Spec())


def _cache_leaf_spec(path: str, shape, mesh, ax: MeshAxes,
                     stacked: bool) -> Spec:
    dp, tp = ax.dp, ax.tp
    name = path.split("/")[-1]
    dims: list = [None] * len(shape)
    off = 1 if stacked else 0
    body = shape[off:]
    if not body:
        return Spec(*dims)
    dims[off] = _fit(mesh, body[0], dp)            # batch dim first
    if name in ("k", "v", "c_kv", "k_rope", "kv_pos", "xk", "xv") \
            and len(body) >= 2:
        dims[off + 1] = _fit(mesh, body[1], tp)    # sequence dim
    elif name == "h" and len(body) >= 2:           # ssm/rg state
        dims[off + 1] = _fit(mesh, body[1], tp)    # heads / width
    elif name == "conv" and len(body) == 3:
        dims[off + 2] = _fit(mesh, body[2], tp)    # channels
    return Spec(*dims)


def cache_specs(cfg: ModelConfig, cache, mesh, axes: MeshAxes = MeshAxes()):
    ax = axes.present(mesh)

    def spec(path, leaf):
        stacked = ("scan" in path.split("/"))
        return _cache_leaf_spec(path, tuple(leaf.shape), mesh, ax, stacked)

    return _walk(cache, spec)


def batch_specs(batch: Dict[str, Any], mesh, axes: MeshAxes = MeshAxes()):
    ax = axes.present(mesh)

    def spec(path, leaf):
        dims = [None] * leaf.ndim
        if leaf.ndim >= 1:
            dims[0] = _fit(mesh, leaf.shape[0], ax.dp)
        return Spec(*dims)

    return _walk(batch, spec)


def to_named(tree, tree_specs, mesh):
    """`tree` laid out as DTensors over `mesh`, leaf by leaf by its spec
    tree (each rank holds the full tree and keeps its shards); non-tensor
    leaves (host counters) stay as they are."""
    import torch

    def lay(x, spec):
        return distribute(x, mesh, spec) if isinstance(x, torch.Tensor) \
            else x
    return tree_map(lay, tree, tree_specs)
