"""AdamW on adapter trees, plus the warmup schedule.

Port of `repro/training/optimizer.py`: the same clip, warmup and bias
correction (`optimizer.py:45-68`), with the same f32 arithmetic. The step
count `t` is a Python int on the host, so the schedule and the bias
corrections are f32 scalars computed on the host (numpy f32, as the
reference computes them on the device) and no step reads a device scalar.
Updates are functional: new trees are returned, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 10


def adamw_init(params) -> Dict[str, Any]:
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    return {"m": zeros(), "v": zeros(), "t": 0}


def lr_at(cfg: AdamWConfig, t: int) -> float:
    """The learning rate at step t (linear warmup), as an f32 value."""
    warm = np.minimum(np.float32(t) / np.float32(max(cfg.warmup_steps, 1)),
                      np.float32(1.0))
    return float(np.float32(cfg.lr) * warm)


def global_norm(tree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves) + 1e-12)


def adamw_update(cfg: AdamWConfig, grads, state, params
                 ) -> Tuple[Any, Dict[str, Any]]:
    t = int(state["t"]) + 1
    if cfg.grad_clip > 0:
        gn = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                           max=1.0)
        grads = tree_map(lambda g: g.float() * clip, grads)
    else:
        grads = tree_map(lambda g: g.float(), grads)
    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g,
                 state["m"], grads)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g,
                 state["v"], grads)
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** tf)
    lr = lr_at(cfg, t)
    lr_wd = float(np.float32(lr) * np.float32(cfg.weight_decay))

    def upd(p, m_, v_):
        step = lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr_wd * p.float()
        return (p.float() - step).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "t": t}
