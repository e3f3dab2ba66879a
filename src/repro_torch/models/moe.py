"""Mixture-of-Experts FFN with capacity-based, sort-ranked dispatch.

Port of `repro/models/moe.py`. Tokens dispatch within groups (GShard
style): a group is a batch row when rows are long enough for a capacity to
mean something (S * k >= 2 E), otherwise the whole batch is one group (the
decode step). Each group gives every expert C slots; an assignment ranked
C or later within its expert is dropped. The rank within an expert comes
from a stable argsort (megablocks style, O(T k) memory), not a one-hot
cumsum.

Routing: softmax top-k (mixtral) or sigmoid top-k (deepseek-v3 style),
renormalised, plus optional always-on shared experts.

Everything here has a shape fixed by the input's shape alone, and nothing
reads a device value on the host: no `.item()`, no `nonzero`, no boolean
mask indexing. So the layer runs inside a CUDA graph (the decode step's
and the finetune units'). The reference's `.at[].max` on the slot plan
becomes `scatter_reduce_(..., "amax")` on a flat (G, E * C) view: a slot
takes at most one kept assignment, and a dropped one writes -1, so the
plan is the same whatever order the atomics run in (the reference's
`.at[].add` builds per-slot weights that nothing reads, and is left
out). The dispatch's backward gathers each token's slot gradients in a
fixed order (`_Dispatch`), where autograd's would scatter-add them with
atomics, so the layer's backward is bit-reproducible at any top-k (a
graphed finetune unit then equals its eager twin). The expert FFN is
three batched
products over the expert axis (`torch.bmm`): plain matrix products, which
the reference leaves to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.bfloat16) -> Dict:
    """Router, routed experts and shared experts of `n_layers` layers,
    stacked on a leading axis, at the reference's scales, drawn on `gen`'s
    device one expert of one layer at a time (the f32 draw of a whole
    mixtral layer would be 1.9 GB). The router is f32, the rest `dtype`."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dev = gen.device

    def normal(shape, std, dt=dtype):
        out = torch.empty((n_layers,) + shape, dtype=dt, device=dev)
        for layer in out:
            for sub in (layer if len(shape) == 3 else [layer]):
                sub.copy_(torch.randn(sub.shape, generator=gen, device=dev)
                          * std)
        return out

    s = d ** -0.5
    p = {"router": normal((d, E), s, torch.float32),
         "gate": normal((E, d, ff), s),
         "up": normal((E, d, ff), s),
         "down": normal((E, ff, d), ff ** -0.5)}
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * ff
        p["shared"] = {"gate": normal((d, sf), s),
                       "up": normal((d, sf), s),
                       "down": normal((sf, d), sf ** -0.5)}
    return p


def _rank_in_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Position of each assignment within its expert, per group.

    e_flat: (G, A) integer expert ids. Returns (G, A) int32 ranks: the
    assignments of one expert are ranked in their order in the group."""
    G, A = e_flat.shape
    e = e_flat.long()
    order = torch.argsort(e, dim=1, stable=True)                 # (G, A)
    counts = torch.zeros((G, E), dtype=torch.long, device=e.device)
    counts.scatter_add_(1, e, torch.ones_like(e))
    starts = torch.cumsum(counts, dim=1) - counts                # (G, E)
    e_sorted = torch.gather(e, 1, order)
    pos_sorted = torch.arange(A, device=e.device)[None, :] - \
        torch.gather(starts, 1, e_sorted)
    ranks = torch.zeros_like(e).scatter_(1, order, pos_sorted)
    return ranks.to(torch.int32)


class _Dispatch(torch.autograd.Function):
    """xe[g, s] = xt[g, slot_tok[g, s]], 0 where the slot holds no token.

    Autograd's backward of that gather is a scatter-add, whose atomics add
    a token's up to k slot gradients in any order: with k > 2 two runs (a
    CUDA graph and its eager twin) then differ in the last bits. This
    backward gathers instead: token t's gradient is the sum, in choice
    order and in f32, of the gradients of the slots its kept assignments
    fill (`slot_of`; a dropped one fills none)."""

    @staticmethod
    def forward(ctx, xt, slot_tok, slot_of, keep, k):
        G, T, d = xt.shape
        ids = slot_tok.clamp(min=0)[..., None].expand(G, slot_tok.shape[1], d)
        ctx.save_for_backward(slot_of, keep)
        ctx.k, ctx.T = k, T
        ctx.mesh = SH.current()
        return torch.where((slot_tok >= 0)[..., None],
                           torch.gather(xt, 1, ids), 0)

    @staticmethod
    def backward(ctx, dxe):
        slot_of, keep = ctx.saved_tensors
        k, T = ctx.k, ctx.T
        G, _, d = dxe.shape
        with ctx.mesh:
            dx = None
            for ki in range(k):
                part = torch.gather(dxe, 1, slot_of[:, ki::k, None].expand(
                    G, T, d))
                part = torch.where(keep[:, ki::k, None], part.float(), 0.0)
                dx = part if dx is None else dx.add_(part)
        return dx.to(dxe.dtype), None, None, None, None


def _constrain_ecf(t, G: int):
    """The reference's ("batch", "expert", None, None) layout of a (G, E,
    C, f) activation, on the port's (E, G * C, f) form of it; t itself
    without a mesh."""
    if SH.active_mesh() is None:
        return t
    E, GC, f = t.shape
    t4 = t.reshape(E, G, GC // G, f).transpose(0, 1)
    t4 = SH.constrain(t4, ("batch", "expert", None, None))
    return t4.transpose(0, 1).reshape(E, GC, f)


def _top_k(scores: torch.Tensor, k: int):
    """The k largest scores and their experts, ties to the lower index, as
    `jax.lax.top_k` breaks them (`torch.topk` does not promise an order
    among equals; a saturated sigmoid router scores several experts 1.0)."""
    w, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                router_type: str = "softmax", lora=None,
                lora_scale: float = 0.0,
                capacity_factor: Optional[float] = None,
                use_kernels: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux); aux = {"lb_loss", "dropped_frac"} (f32
    scalars). lora/use_kernels reach the shared experts only (the routed
    experts take no adapters, `models/lora.py`)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor
    if S * k >= 2 * E:
        G, T = B, S
        C = max(int(round(T * k * cf / E)), 1)
    else:
        # decode / tiny batches: one group, 4x the mean load per expert
        G, T = 1, B * S
        C = min(T, max(8, 4 * (-(-T * k // E))))
    dev = x.device

    xt = x.reshape(G, T, d)
    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"].float())
    if router_type == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(scores, k)                             # (G, T, k)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    A = T * k
    e_flat = top_i.reshape(G, A)
    ranks = _rank_in_expert(e_flat, E)
    keep = ranks < C
    pos_c = torch.clamp(ranks, max=C - 1)
    tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(A)
    slot_of = e_flat * C + pos_c                                  # (G, A)
    w_keep = torch.where(keep, top_w.reshape(G, A), 0.0)

    # --- slot plan: which token fills each (expert, slot), -1 for none ---
    slot_tok = torch.full((G, E * C), -1, dtype=torch.long, device=dev)
    slot_tok.scatter_reduce_(1, slot_of, torch.where(keep, tok[None, :], -1),
                             reduce="amax")

    # --- dispatch: a direct (G, E, C, d) gather ---------------------------
    xt = SH.constrain(xt, ("batch", None, None))
    xe = _Dispatch.apply(xt, slot_tok, slot_of, keep, k)
    xe = SH.constrain(xe.reshape(G, E, C, d), ("batch", "expert", None, None))
    xe = xe.transpose(0, 1).reshape(E, G * C, d)

    # --- expert FFN: batched over the experts -----------------------------
    g = torch.bmm(xe, p["gate"].to(x.dtype))
    u = torch.bmm(xe, p["up"].to(x.dtype))
    h = _constrain_ecf(F.silu(g.float()).to(x.dtype) * u, G)
    ye = _constrain_ecf(torch.bmm(h, p["down"].to(x.dtype)), G)  # (E, GC, d)
    ye_flat = ye.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # --- combine: k strided gathers back to the tokens --------------------
    y = torch.zeros((G, T, d), dtype=torch.float32, device=dev)
    for ki in range(k):
        idx = slot_of[:, ki::k]                                   # (G, T)
        part = torch.gather(ye_flat, 1, idx[..., None].expand(G, T, d))
        y = y + part.float() * w_keep[:, ki::k, None]
    y = SH.constrain(y.to(x.dtype).reshape(B, S, d), ("batch", "seq_sp", None))

    if cfg.num_shared_experts and "shared" in p:
        sh = p["shared"]
        y = y + L.glu_mlp(x, sh["gate"], sh["up"], sh["down"], act=cfg.act,
                          lora=lora, lora_scale=lora_scale,
                          use_kernels=use_kernels)

    # --- aux: load-balance loss (Switch style) and the dropped share ------
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))              # (E,)
    first = top_i[..., 0, None] == torch.arange(E, device=dev)   # one-hot
    ce = first.float().sum(dim=(0, 1)) / (G * T)
    aux = {"lb_loss": E * (me * ce).sum(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux
