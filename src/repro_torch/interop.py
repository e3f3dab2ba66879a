"""Params and caches between the JAX package's numpy form and the port.

`to_torch` turns a tree of arrays (dicts, lists, tuples; any leaf that
`np.asarray` accepts, such as a JAX array) into the port's tensors with the
same structure: stacked `"scan"` leaves stay stacked and `pre`/`post`
lists are kept. `to_numpy` goes back. bfloat16 crosses exactly, as a
uint16 view of the same bits. A 0-d integer array becomes a Python int and
a Python int a 0-d int32 array: the port keeps the finetune state's
counters (`unit_idx`, `iter`, the optimizer's `t`, ...) on the host, where
the reference keeps int32 scalars. So a JAX `ft_state` crosses both ways.
The tests use this to give both sides the same weights and inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(x, device):
    a = np.asarray(x)
    if a.ndim == 0 and a.dtype.kind in "iu":
        return int(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16)))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _leaf_to_numpy(t) -> np.ndarray:
    if isinstance(t, int):
        return np.asarray(t, np.int32)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # np.dtype("bfloat16") exists once ml_dtypes is loaded (JAX loads it)
        return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree: Any, device="cpu") -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)
