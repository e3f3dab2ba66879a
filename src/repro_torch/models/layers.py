"""Shared neural building blocks: norms, RoPE, projections, MLPs, flash
attention, embeddings and the losses.

Port of `repro/models/layers.py`. The chunked online-softmax attention is
plain torch, as the reference is plain jnp: prefill attention has no TPU
kernel to port. It mirrors `_flash_fwd` and returns 0 for fully masked
rows, which is why the path does not call `scaled_dot_product_attention`;
its backward is plain autograd (the reference's custom VJP recomputes the
softmax blocks to save memory; the training units recompute one layer at a
time, which bounds the same memory).

`lora_proj` is the one projection helper that `glu_mlp` and the attention
projections call. Without `use_kernels` it computes what the reference's
einsums compute, rounding for rounding; with it, an adapted projection goes
through the LoRA matmul kernel (`kernels/ops.lora_matmul`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python number: a tensor made from it on the card would
    # be a blocking host-to-device copy, twice per layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------- projections ----
def lora_proj(x, w, lora, name: str, lora_scale: float,
              use_kernels: bool = False) -> torch.Tensor:
    """y = x @ W (+ s * (x @ A) @ B when `lora` has `name`), in x's dtype.

    Plain: the reference's rounding points (each product rounded to x's
    dtype, then the scaled delta, then the sum). With use_kernels, the
    adapted projection is one LoRA matmul kernel launch (f32 sum, xa
    rounded once, one rounding of the output); unadapted ones stay plain."""
    w = w.to(x.dtype)
    if lora is None or name not in lora:
        return x @ w
    a, b = lora[name]
    a, b = a.to(x.dtype), b.to(x.dtype)
    if use_kernels:
        return kops.lora_matmul(x, w, a, b, lora_scale)
    return x @ w + lora_scale * ((x @ a) @ b)


# ----------------------------------------------------------------- MLPs ----
def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def glu_mlp(x, gate_w, up_w, down_w, act: str = "silu",
            lora=None, lora_scale: float = 0.0, use_kernels: bool = False):
    """SwiGLU / GeGLU MLP with optional LoRA deltas.

    lora: dict with optional keys gate/up/down -> (A: (d, r), B: (r, ff))."""
    g = lora_proj(x, gate_w, lora, "gate", lora_scale, use_kernels)
    u = lora_proj(x, up_w, lora, "up", lora_scale, use_kernels)
    h = _act(act)(g.float()).to(x.dtype) * u
    return lora_proj(h, down_w, lora, "down", lora_scale, use_kernels)


# --------------------------------------------------- flash attention -------
def flash_attention(
    q: torch.Tensor,                # (B, Sq, H, hd)
    k: torch.Tensor,                # (B, Sk, KV, hd)
    v: torch.Tensor,                # (B, Sk, KV, vd)
    *,
    causal: bool = True,
    q_offset: Optional[torch.Tensor] = None,  # absolute pos of q[:, 0]
    window: int = 0,                # sliding-window size (0 = full)
    soft_cap: float = 0.0,          # scores -> cap * tanh(s / cap) (0 = off)
    scale: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Chunked online-softmax attention (GQA-aware), O(S) memory.

    Scores and the running (m, l, o) are f32; the soft cap, when set,
    applies after the scale and before the mask (`_flash_fwd`); the
    softmax weights are cast to v's dtype before the PV product, as in the
    reference. Returns (B, Sq, H, vd) in v's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    vd = v.shape[-1]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    if q_offset is None:
        q_offset = torch.full((B,), Sk - Sq if causal else 0,
                              dtype=torch.int32, device=q.device)
    qr = q.reshape(B, Sq, KV, g, hd).float()
    kf, vf = k.float(), v.float()
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qb = qr[:, q0:q0 + q_chunk]
        qc = qb.shape[1]
        q_pos = q_offset[:, None].long() + q0 + \
            torch.arange(qc, device=q.device)[None, :]          # (B, qc)
        m = torch.full((B, KV, g, qc), -torch.inf, device=q.device)
        l = torch.zeros((B, KV, g, qc), device=q.device)
        o = torch.zeros((B, KV, g, qc, vd), device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            kb, vb = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb) * scale
            if soft_cap > 0.0:
                s = soft_cap * torch.tanh(s / soft_cap)
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)
            mask = torch.ones((B, qc, kb.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (kpos[None, None, :] <= q_pos[:, :, None])
            if window > 0:
                mask = mask & (kpos[None, None, :] > q_pos[:, :, None] - window)
            mask = mask[:, None, None]
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(v.dtype).float(), vb)
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(v.dtype))     # (B, qc, KV, g, vd)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, vd)


# ------------------------------------------------------------ embeddings ---
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); table: (V, d) -> logits (B, S, V)."""
    return x @ table.to(x.dtype).t()


def _xent_chunk_sum(x, table, labels, mask):
    """Sum of masked (lse - gold) over one chunk, logits in f32."""
    logits = (x @ table.to(x.dtype).t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_softmax_xent(x, table, labels, mask=None, chunk: int = 256):
    """Fused final projection + cross-entropy over sequence chunks.

    Never holds (B, S, V): each chunk computes its logits, LSE and gold
    score, and is recomputed in the backward pass (`torch.utils.checkpoint`,
    the reference's `jax.checkpoint`), so autograd keeps no chunk's f32
    logits. Nothing here draws random numbers, so the checkpoint keeps no
    RNG state: reading or setting the card's generator is refused while a
    CUDA graph captures (the HEAD unit's graph). x: (B, S, d) final hidden
    states (normed, shifted); labels: (B, S) aligned with x. Returns the
    masked mean."""
    B, S, _ = x.shape
    c = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        tot = tot + checkpoint(_xent_chunk_sum, x[:, sl], table,
                               labels[:, sl], mask[:, sl],
                               use_reentrant=False, preserve_rng_state=False)
    return tot / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits, labels, mask=None):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
