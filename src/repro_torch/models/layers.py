"""Shared neural building blocks: norms, RoPE, projections, MLPs, flash
attention, embeddings and the losses.

Port of `repro/models/layers.py`. The chunked online-softmax attention is
plain torch, as the reference is plain jnp: prefill attention has no TPU
kernel to port. It mirrors `_flash_fwd` and returns 0 for fully masked
rows, which is why the path does not call `scaled_dot_product_attention`.
Under autograd it is a `torch.autograd.Function` whose backward mirrors
the reference's custom VJP (`_flash_bwd`): it keeps q, k, v, o and an f32
log-sum-exp, and recomputes each block's softmax weights, so training
holds no (q-chunk, kv-chunk) block. `flash_attention_plain`, the same
forward under plain autograd, is the yardstick the tests and the card's
timing hold it against.

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

from repro_torch.distributed import sharding as SH
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
    def proj(h, w, key, out_logical):
        y = lora_proj(h, w, lora, key, lora_scale, use_kernels)
        return SH.constrain(y, out_logical) if y.ndim == 3 else y
    g = proj(x, gate_w, "gate", ("batch", None, "ff"))
    u = proj(x, up_w, "up", ("batch", None, "ff"))
    h = _act(act)(g.float()).to(x.dtype) * u
    return proj(h, down_w, "down", ("batch", "seq_sp", None))


# --------------------------------------------------- flash attention -------
def _flash_fwd(q, k, v, q_offset, causal: bool, window: int, soft_cap: float,
               scale: float, q_chunk: int, kv_chunk: int, need_lse: bool):
    """`_flash_fwd` of the reference: (o (B, Sq, H, vd) in v's dtype, lse
    (B, KV, g, Sq) f32, or None without need_lse).

    Scores and the running (m, l, o) are f32; each q and k block is
    widened to f32 inside its loop (a bf16 x bf16 product is exact in f32,
    so the values are those of bf16 inputs with f32 accumulation, and no
    f32 copy of the whole K or V is made); the soft cap, when set, applies
    after the scale and before the mask; the softmax weights are rounded
    to v's dtype before the PV product. A ragged last chunk is a shorter
    slice, not a padded one. A fully masked row gives o = 0 and lse =
    -inf."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    vd = v.shape[-1]
    g = H // KV
    qr = q.reshape(B, Sq, KV, g, hd)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    outs, lses = [], []
    for q0 in range(0, Sq, qc):
        qb = qr[:, q0:q0 + qc].float()
        n = qb.shape[1]
        q_pos = q_offset[:, None].long() + q0 + \
            torch.arange(n, device=q.device)[None, :]            # (B, qc)
        # the running (m, l, o) start from the first block's terms (what
        # -inf, 0 and 0 would give, exactly), so that on a mesh they are
        # laid out as the blocks are and no global-shaped buffer is made
        m = l = o = None
        for k0 in range(0, Sk, kc):
            kb = k[:, k0:k0 + kc].float()
            vb = v[:, k0:k0 + kc]
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb) * scale
            if soft_cap > 0.0:
                s = soft_cap * torch.tanh(s / soft_cap)
            mask = _block_mask(q_pos, k0, kb.shape[1], causal, window)
            s = torch.where(mask, s, -torch.inf)
            m_new = s.amax(dim=-1) if m is None else \
                torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v.dtype).float(),
                              vb.float())
            if m is None:
                l, o = p.sum(dim=-1), pv
            else:
                corr = torch.where(torch.isneginf(m), 0.0,
                                   torch.exp(m - m_safe))
                l = l * corr + p.sum(dim=-1)
                o = o * corr[..., None] + pv
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).to(v.dtype))    # (B, qc, KV, g, vd)
        if need_lse:
            lses.append(torch.where(
                l > 0, m + torch.log(torch.clamp(l, min=1e-30)), -torch.inf))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, vd)
    return out, (torch.cat(lses, dim=-1) if need_lse else None)


def _block_mask(q_pos, k0: int, n_k: int, causal: bool, window: int):
    """(B, 1, 1, qc, n_k) bool: which keys k0..k0+n_k-1 each query row at
    `q_pos` (B, qc) sees."""
    B, n_q = q_pos.shape
    kpos = k0 + torch.arange(n_k, device=q_pos.device)
    # built from q_pos, so that on a mesh it is laid out as q_pos is
    mask = torch.ones_like(q_pos[:, :, None].expand(B, n_q, n_k),
                           dtype=torch.bool)
    if causal:
        mask = mask & (kpos[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        mask = mask & (kpos[None, None, :] > q_pos[:, :, None] - window)
    return mask[:, None, None]


def _acc(total, term):
    """total += term in place, or term where nothing is summed yet."""
    return term if total is None else total.add_(term)


def _flash_bwd(q, k, v, q_offset, o, lse, do, causal: bool, window: int,
               soft_cap: float, scale: float, q_chunk: int, kv_chunk: int):
    """`_flash_bwd` of the reference: (dq, dk, dv) by recomputing each
    (q-block, kv-block)'s softmax weights from q, k and the saved lse:
        dv += p^T do ;  dp = do v^T ;  ds = p (dp - D), D = rowsum(do o) ;
        [soft cap: ds *= 1 - t^2, t = tanh(s / cap)] ;
        dq += ds k ;  dk += ds^T q.
    p and ds are rounded to the input dtype before the products that use
    them; dq, dk and dv accumulate in f32. A row whose lse is -inf (fully
    masked) contributes nothing."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    vd = v.shape[-1]
    g = H // KV
    in_dtype = q.dtype
    qr = q.reshape(B, Sq, KV, g, hd)
    dor = do.reshape(B, Sq, KV, g, vd)
    D = (dor.float() * o.reshape(B, Sq, KV, g, vd).float()).sum(dim=-1)
    D = D.permute(0, 2, 3, 1)                                # (B, KV, g, Sq)
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    # f32 sums, one per kv block, each started from its first term (so
    # that a sharded path's DTensor inputs give DTensor grads)
    dks, dvs = {}, {}
    dqs = []
    for q0 in range(0, Sq, qc):
        qb = qr[:, q0:q0 + qc].float()
        n = qb.shape[1]
        dob = dor[:, q0:q0 + qc].float()
        lseb = lse[..., q0:q0 + qc]
        dead = torch.isneginf(lseb)[..., None]
        lse_safe = torch.where(dead[..., 0], 0.0, lseb)[..., None]
        Db = D[..., q0:q0 + qc, None]
        q_pos = q_offset[:, None].long() + q0 + \
            torch.arange(n, device=q.device)[None, :]
        dq_b = None
        for k0 in range(0, Sk, kc):
            kb = k[:, k0:k0 + kc].float()
            vb = v[:, k0:k0 + kc].float()
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb) * scale
            cap_grad = 1.0
            if soft_cap > 0.0:
                t = torch.tanh(s / soft_cap)
                s = soft_cap * t
                cap_grad = 1.0 - t * t
            mask = _block_mask(q_pos, k0, kb.shape[1], causal, window)
            p = torch.where(mask & ~dead, torch.exp(s - lse_safe), 0.0)
            del s, mask                 # a block's f32 tensors: free early
            dp = torch.einsum("bqkgh,bskh->bkgqs", dob, vb)
            ds = (p * (dp - Db) * cap_grad).to(in_dtype).float()
            del dp, cap_grad
            dq_b = _acc(dq_b, torch.einsum("bkgqs,bskh->bqkgh", ds, kb)
                        * scale)
            dks[k0] = _acc(dks.get(k0), torch.einsum(
                "bkgqs,bqkgh->bskh", ds, qb) * scale)
            dvs[k0] = _acc(dvs.get(k0), torch.einsum(
                "bkgqs,bqkgh->bskh", p.to(in_dtype).float(), dob))
        dqs.append(dq_b.to(in_dtype))
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, hd)
    dk = torch.cat([dks[k0] for k0 in sorted(dks)], dim=1)
    dv = torch.cat([dvs[k0] for k0 in sorted(dvs)], dim=1)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP (`_make_flash`): the forward saves q, k,
    v, q_offset, o and the f32 lse (B, KV, g, Sq), and the backward
    recomputes the softmax blocks from them, so that no (qc, kc) block
    outlives its loop iteration."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, soft_cap, scale,
                q_chunk, kv_chunk):
        o, lse = _flash_fwd(q, k, v, q_offset, causal, window, soft_cap,
                            scale, q_chunk, kv_chunk, need_lse=True)
        ctx.save_for_backward(q, k, v, q_offset, o, lse)
        ctx.args = (causal, window, soft_cap, scale, q_chunk, kv_chunk)
        ctx.mesh = SH.current()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_offset, o, lse = ctx.saved_tensors
        with ctx.mesh:
            dq, dk, dv = _flash_bwd(q, k, v, q_offset, o, lse, do,
                                    *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash_args(q, k, causal, q_offset, window, soft_cap, scale, q_chunk,
                kv_chunk):
    """The positional arguments after (q, k, v) of `_flash_fwd`."""
    B, Sq, _, hd = q.shape
    if q_offset is None:
        q_offset = torch.full((B,), k.shape[1] - Sq if causal else 0,
                              dtype=torch.int32, device=q.device)
    return (q_offset, bool(causal), int(window), float(soft_cap),
            float(scale if scale is not None else hd ** -0.5),
            int(q_chunk), int(kv_chunk))


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
    """Chunked online-softmax attention (GQA-aware), O(S) memory in both
    directions. Returns (B, Sq, H, vd) in v's dtype, 0 on fully masked
    rows.

    When autograd records (grad enabled and an input requires grad), it
    runs as `_FlashAttention`, whose backward recomputes the softmax
    blocks (the reference's custom VJP); otherwise (serving, the encoder,
    a CUDA graph's capture) it is the forward alone, which saves nothing
    and computes no lse."""
    args = _flash_args(q, k, causal, q_offset, window, soft_cap, scale,
                       q_chunk, kv_chunk)
    k, v = SH.expand_kv(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, *args)
    return _flash_fwd(q, k, v, *args, need_lse=False)[0]


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset=None,
                          window: int = 0, soft_cap: float = 0.0,
                          scale: Optional[float] = None, q_chunk: int = 512,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """`flash_attention`'s forward under plain autograd, which keeps every
    block's f32 scores, weights and mask for the backward pass. The
    yardstick of the tests and the card's timing; no model path calls
    it."""
    args = _flash_args(q, k, causal, q_offset, window, soft_cap, scale,
                       q_chunk, kv_chunk)
    k, v = SH.expand_kv(q, k, v)
    return _flash_fwd(q, k, v, *args, need_lse=False)[0]


# ------------------------------------------------------------ embeddings ---
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); table: (V, d) -> logits (B, S, V)."""
    return SH.constrain(x @ table.to(x.dtype).t(), ("batch", None, "vocab"))


def _gold_nll(logits, labels):
    """(lse - gold logit) per row of logits (..., V) in f32. On a mesh the
    logits are laid out as `lm_logits` lays them out, ("batch", ...,
    "vocab"), and the labels are laid out as their rows, so that under the
    TP rules both reductions over the vocabulary run on its shards
    (`sharding.logsumexp`, `sharding.gather`): no rank holds a row's every
    logit."""
    labels = SH.constrain(labels.long(),
                          ("batch",) + (None,) * (labels.ndim - 1))
    lse = SH.logsumexp(logits, dim=-1)
    return lse - SH.gather(logits, -1, labels[..., None])[..., 0]


def _xent_chunk_sum(x, table, labels, mask):
    """Sum of masked (lse - gold) over one chunk, logits in f32."""
    return (_gold_nll(lm_logits(x, table).float(), labels) * mask).sum()


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
    # the table laid out by "vocab": split over the model axis under the
    # TP rules, whole under FSDP's (gathered on use, as FSDP gathers a
    # layer's weights), so that each chunk's logits keep x's batch layout
    # and no rank computes every row's
    table = SH.constrain(table, ("vocab", None))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        tot = tot + checkpoint(_xent_chunk_sum, x[:, sl], table,
                               labels[:, sl], mask[:, sl],
                               use_reentrant=False, preserve_rng_state=False,
                               context_fn=SH.checkpoint_contexts)
    return tot / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits, labels, mask=None):
    nll = _gold_nll(logits.float(), labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
