"""Production mesh construction (single-pod 16x16, multi-pod 2x16x16).

Port of `repro/launch/mesh.py` on `torch.distributed.device_mesh`. Functions,
not module-level constants: importing this module touches no process
group. The caller initialises the default process group first (the world
size must cover the mesh) and names the device type: "cuda" by default,
"cpu" for gloo or the single-process `fake` group.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist


def _mesh(shape: Sequence[int], names: Sequence[str], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} ranks, have {have} — "
            "initialise the process group with a world size that covers it")
    ranks = torch.arange(need).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 4,
                    device_type: str = "cuda"):
    """Small mesh for tests (needs a world of at least data * model)."""
    return _mesh((data, model), ("data", "model"), device_type)
