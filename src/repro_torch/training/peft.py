"""PEFT (LoRA) finetune engine with layer-wise scheduling units (paper §6.1).

Port of `repro/training/peft.py`. An iteration is a sequence of units, each
of which `unit_step` runs one at a time, so a co-located round can run `k`
of them after its decode step (`core/colocation.py`):

  per microbatch: EMBED | L x FWD(layer i) | HEAD(loss, dx)
                  | L x BWD(layer j, descending) | EMBED_BWD(data advance)
  then:           OPT (AdamW on the accumulated adapter grads)

FWD units run without autograd and save each layer's input as a bf16
residual. BWD units recompute their layer from that residual and call
`torch.autograd.grad` with respect to (the layer input, that layer's
adapters): the port's counterpart of the reference's `jax.vjp`, and the
same layer-granular activation checkpointing that bounds the co-located
memory footprint (§4.3).

The state is a dict like the reference's `ft_state`, with two differences.
Its counters (`unit_idx`, `data_idx`, `iter`, `consumed`, and the
optimizer's `t`) are Python ints on the host, so choosing the next unit
reads no device scalar (`interop` turns them into the reference's int32
scalars and back). And `unit_step` updates the residuals and the
accumulated grads in place and returns the same dict: a unit then copies
no (L+1, B, S, d) stack.

`use_kernels` routes every adapted projection of the FWD and BWD units
through the LoRA matmul kernel: 7 launches per FWD unit and 14 per BWD unit
(the recomputed forward and the dx of each projection) on a dense layer
with all seven targets adapted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lora as LR
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.tree import tree_map

RESIDUAL_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class PeftConfig:
    micro_batch: int = 2          # paper §8.2: micro-batched to bs=2
    seq_len: int = 1024
    accum: int = 8                # minibatch 16 = 8 x 2 (paper baseline bs)
    n_stage: int = 2              # host-staged microbatch ring depth
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


# ===================================================== full train step ====
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    use_kernels: bool = False, remat: bool = True):
    """One-shot PEFT train step (grads with respect to the adapters only)."""

    def train_step(params, adapters, opt_state, batch):
        ad = tree_map(lambda t: t.detach().requires_grad_(), adapters)
        with torch.enable_grad():
            loss, metrics = MD.loss_fn(params, cfg, batch, adapters=ad,
                                       use_kernels=use_kernels, remat=remat)
            loss.backward()
        grads = tree_map(lambda t: t.grad, ad)
        new_adapters, new_opt = adamw_update(opt_cfg, grads, opt_state,
                                             tree_map(torch.Tensor.detach,
                                                      ad))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new_adapters, new_opt, metrics

    return train_step


# ===================================================== layer-unit engine ==
def n_units_per_mb(cfg: ModelConfig) -> int:
    _, _, n_scan, _ = MD._plan(cfg)
    return 2 * n_scan + 3


def units_per_iteration(cfg: ModelConfig, accum: int) -> int:
    return accum * n_units_per_mb(cfg) + 1


def init_ft_state(cfg: ModelConfig, pc: PeftConfig, params, seed: int,
                  staged: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """staged: {"tokens": (n_stage, B, S), "labels": ..., "mask": ...} from
    `data.Prefetcher.stacked()`, copied to the params' device."""
    _, _, n_scan, _ = MD._plan(cfg)
    dev = params["embed"].device
    B, S, d = pc.micro_batch, pc.seq_len, cfg.d_model
    adapters = MD.init_adapters(cfg, seed, device=dev)
    return {
        "adapters": adapters,
        "opt": adamw_init(adapters),
        "grads": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          adapters),
        "x": torch.zeros((B, S, d), dtype=RESIDUAL_DTYPE, device=dev),
        "residuals": torch.zeros((n_scan + 1, B, S, d), dtype=RESIDUAL_DTYPE,
                                 device=dev),
        "data": {k: torch.as_tensor(v, device=dev) for k, v in staged.items()},
        "data_idx": 0,
        "unit_idx": 0,
        "loss": torch.zeros((), dtype=torch.float32, device=dev),
        "last_loss": torch.zeros((), dtype=torch.float32, device=dev),
        "iter": 0,
        "consumed": 0,
    }


def make_unit_step(cfg: ModelConfig, pc: PeftConfig, params, *,
                   use_kernels: bool = False):
    """Build `unit_step(state) -> state`, which runs exactly one unit."""
    _, scan_kind, n_scan, _ = MD._plan(cfg)
    scale = LR.lora_scale(cfg)
    upm = n_units_per_mb(cfg)
    total_units = units_per_iteration(cfg, pc.accum)
    positions = torch.arange(pc.seq_len, dtype=torch.int32,
                             device=params["embed"].device
                             ).expand(pc.micro_batch, pc.seq_len)

    def current_batch(state):
        idx = state["data_idx"] % pc.n_stage
        return {k: v[idx] for k, v in state["data"].items()}

    def layer(i, x, lora):
        y, _ = MD.apply_layer(MD._layer(params["scan"], i), x, positions,
                              cfg, scan_kind, mode="full", lora=lora,
                              scale=scale, use_kernels=use_kernels)
        return y

    def u_embed(state, _u):
        x, _, _ = MD._embed_inputs(params, cfg,
                                   {"tokens": current_batch(state)["tokens"]})
        state["x"] = x.to(RESIDUAL_DTYPE)
        state["residuals"][0] = x

    def u_fwd(state, u):
        i = u - 1
        ad = LR.slice_adapters(state["adapters"]["scan"], i)
        y = layer(i, state["x"], ad)
        state["x"] = y.to(RESIDUAL_DTYPE)
        state["residuals"][i + 1] = y

    def head_loss(x, state):
        batch = current_batch(state)
        h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        mask = batch.get("mask")
        return L.chunked_softmax_xent(
            h[:, :-1], table, batch["labels"][:, 1:],
            None if mask is None else mask[:, 1:])

    def u_head(state, _u):
        x = state["x"].detach().requires_grad_()
        with torch.enable_grad():
            loss = head_loss(x, state)
            (dx,) = torch.autograd.grad(loss, [x])
        state["x"] = dx.to(RESIDUAL_DTYPE)
        state["loss"] = state["loss"] + loss.detach() / pc.accum

    def u_bwd(state, u):
        i = 2 * n_scan + 1 - u                   # layer index, descending
        x_in = state["residuals"][i].detach().requires_grad_()
        ad = {name: {k: t[i].detach().requires_grad_() for k, t in v.items()}
              for name, v in state["adapters"]["scan"].items()}
        names = list(ad)
        with torch.enable_grad():
            y = layer(i, x_in, LR.as_pairs(ad))
            grads = torch.autograd.grad(
                y, [x_in] + [ad[n][k] for n in names for k in ("a", "b")],
                grad_outputs=state["x"].to(y.dtype))
        acc = state["grads"]["scan"]
        for j, n in enumerate(names):
            acc[n]["a"][i] += grads[1 + 2 * j].float()
            acc[n]["b"][i] += grads[2 + 2 * j].float()
        state["x"] = grads[0].to(RESIDUAL_DTYPE)

    def u_embed_bwd(state, _u):
        state["data_idx"] += 1
        state["consumed"] += 1

    def u_opt(state, _u):
        state["adapters"], state["opt"] = adamw_update(
            pc.opt, state["grads"], state["opt"], state["adapters"])
        tree_map(torch.Tensor.zero_, state["grads"])
        state["last_loss"] = state["loss"]
        state["loss"] = torch.zeros_like(state["loss"])
        state["iter"] += 1

    def branch(unit_idx: int):
        if unit_idx >= pc.accum * upm:
            return u_opt
        u = unit_idx % upm
        if u == 0:
            return u_embed
        if u <= n_scan:
            return u_fwd
        if u == n_scan + 1:
            return u_head
        if u <= 2 * n_scan + 1:
            return u_bwd
        return u_embed_bwd

    @torch.no_grad()
    def unit_step(state):
        unit_idx = state["unit_idx"]
        branch(unit_idx)(state, unit_idx % upm)
        state["unit_idx"] = (unit_idx + 1) % total_units
        return state

    return unit_step


def run_units(unit_step, state, k: int):
    """Run k units, in order, on the current stream."""
    for _ in range(max(k, 0)):
        state = unit_step(state)
    return state
