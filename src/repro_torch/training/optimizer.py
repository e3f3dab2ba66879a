"""AdamW on adapter trees, plus the warmup schedule.

Port of `repro/training/optimizer.py`: the same clip, warmup and bias
correction (`optimizer.py:45-68`), with the same f32 arithmetic. The step
count `t` is a Python int on the host, so the schedule and the bias
corrections are f32 scalars computed on the host (numpy f32, as the
reference computes them on the device) and no step reads a device scalar.

Two forms of one update. `adamw_update` is functional: new trees are
returned, as in the reference (`make_train_step` and the parity tests).
`adamw_update_` writes the params, `m` and `v` in place and takes lr and
the bias corrections from a small f32 tensor (`adamw_hparams`, written by
the host before the step) on the params' device, so the layer-unit
engine's OPT unit can be captured in a CUDA graph: a replay then reads the
step's scalars and updates the tensors the graph was captured on.
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


def adamw_hparams(cfg: AdamWConfig, t: int) -> np.ndarray:
    """f32 [lr, bc1, bc2, lr * weight_decay] of step t (t counts from 1)."""
    tf = np.float32(t)
    lr = np.float32(lr_at(cfg, t))
    return np.array([lr, np.float32(1.0) - np.float32(cfg.b1) ** tf,
                     np.float32(1.0) - np.float32(cfg.b2) ** tf,
                     lr * np.float32(cfg.weight_decay)], np.float32)


def _moments(cfg: AdamWConfig, grads, state):
    """The clipped f32 grads' new first and second moments."""
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
    return m, v


def _stepped(cfg: AdamWConfig, p, m_, v_, lr, bc1, bc2, lr_wd):
    """p after one step, in p's dtype; the scalars are Python floats or
    0-d f32 tensors, which round alike."""
    step = lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
    if cfg.weight_decay:
        step = step + lr_wd * p.float()
    return (p.float() - step).to(p.dtype)


def adamw_update(cfg: AdamWConfig, grads, state, params
                 ) -> Tuple[Any, Dict[str, Any]]:
    t = int(state["t"]) + 1
    m, v = _moments(cfg, grads, state)
    hp = [float(x) for x in adamw_hparams(cfg, t)]
    new_params = tree_map(lambda p, m_, v_: _stepped(cfg, p, m_, v_, *hp),
                          params, m, v)
    return new_params, {"m": m, "v": v, "t": t}


def adamw_update_(cfg: AdamWConfig, grads, state, params,
                  hp: torch.Tensor) -> None:
    """`adamw_update` in place: writes `params`, `state["m"]` and
    `state["v"]`, bit for bit what the functional form returns on the CPU.
    hp: `adamw_hparams(cfg, state["t"] + 1)` as an f32 tensor on the
    params' device. Launches kernels only (no host read, no new tensor
    outlives the call), so it can be captured in a CUDA graph; the caller
    writes hp before it runs and advances the host's `t` after."""
    m, v = _moments(cfg, grads, state)
    lr, bc1, bc2, lr_wd = hp.unbind()
    for p, m_old, v_old, m_, v_ in zip(tree_leaves(params),
                                       tree_leaves(state["m"]),
                                       tree_leaves(state["v"]),
                                       tree_leaves(m), tree_leaves(v)):
        p.copy_(_stepped(cfg, p, m_, v_, lr, bc1, bc2, lr_wd))
        m_old.copy_(m_)
        v_old.copy_(v_)
