"""Attention layers: the GQA/MHA half (+ qk_norm, SWA windows) of the
reference.

Port of `repro/models/attention.py` for full and sliding-window
(unquantized) caches. Two execution paths per layer:
  * prefill/train: chunked flash attention over the whole sequence
  * decode: one-token attention against a KV cache (`decode_attn_ref`
    here; the CUDA kernel is swapped in by `kernels/ops.decode_attention`)

Cache layout per layer (per-request absolute positions, so continuous
batching works): k/v (B, S, KV, hd), kv_pos (B, S) int32 (-1 = empty).
A full cache has S = s_max and token p in slot p. A windowed (SWA) cache
is a ring of S = min(s_max, window) slots, token p in slot p % S, so after
position p is written it holds exactly positions max(0, p - S + 1)..p.
Unlike the reference, cache writes update the given tensors in place and
return the same dict: a decode round then moves no cache copy.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def make_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None, window: int = 0
               ) -> Dict[str, torch.Tensor]:
    """Empty per-layer cache (without the leading layer axis); a ring of
    min(s_max, window) slots when windowed."""
    eff = min(s_max, window) if window else s_max
    shape = (batch, eff, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "kv_pos": torch.full((batch, eff), -1, dtype=torch.int32,
                             device=device),
    }


# ------------------------------------------------------------- GQA paths ---
def _project_qkv(p: Params, x, cfg: ModelConfig, lora, lora_scale,
                 use_kernels: bool = False):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(w, name, n_out):
        y = L.lora_proj(x, w, lora, name, lora_scale, use_kernels)
        return y.reshape(B, S, n_out, hd)

    q = proj(p["wq"], "q", H)
    k = proj(p["wk"], "k", KV)
    v = proj(p["wv"], "v", KV)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out_proj(p: Params, o, cfg: ModelConfig, lora, lora_scale,
              use_kernels: bool = False):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return L.lora_proj(o, p["wo"], lora, "o", lora_scale, use_kernels)


def attn_prefill(p: Params, x, positions, cfg: ModelConfig, *,
                 window: int = 0, cache: Optional[Dict] = None, lora=None,
                 lora_scale: float = 0.0, use_kernels: bool = False):
    """Full-sequence attention. positions: (B, S) absolute. Returns (out,
    cache); the cache, when given, is written in place (None: the training
    path's "full" mode). use_kernels routes the adapted projections through
    the LoRA matmul kernel."""
    q, k, v = _project_qkv(p, x, cfg, lora, lora_scale, use_kernels)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v, causal=True, window=window,
                          q_offset=positions[:, 0])
    out = _out_proj(p, o, cfg, lora, lora_scale, use_kernels)
    if cache is not None:
        cache = _cache_write_prefill(cache, k, v, positions, window)
    return out, cache


def _cache_write_bulk(cache, k, v, positions, window: int = 0):
    """Scatter a token chunk (B, s, KV, hd) at `positions` (B, s), in
    place; into slot p % S of the ring when windowed."""
    S_max = cache["k"].shape[1]
    slots = (positions % S_max if window else positions).long()
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["kv_pos"][bidx, slots] = positions.to(torch.int32)
    return cache


def _cache_write_prefill(cache, k, v, positions, window: int = 0):
    """Contiguous prefill write (prompt positions are arange-contiguous
    per request, from 0), in place. A full cache takes the first S_max
    tokens from slot 0, as does a ring of W slots a chunk of S <= W tokens
    (token p in slot p % W = p). A ring takes of S > W tokens only the
    last W, as two slice writes split at S % W."""
    S_max = cache["k"].shape[1]
    S = k.shape[1]
    if not window or S <= S_max:
        n = min(S, S_max)
        cache["k"][:, :n] = k[:, :n].to(cache["k"].dtype)
        cache["v"][:, :n] = v[:, :n].to(cache["v"].dtype)
        cache["kv_pos"][:, :n] = positions[:, :n].to(torch.int32)
        return cache
    W = S_max
    split = S % W
    first = W - split
    for name, t in (("k", k), ("v", v), ("kv_pos", positions)):
        buf, t = cache[name], t[:, -W:].to(cache[name].dtype)
        buf[:, split:] = t[:, :first]
        if split:
            buf[:, :split] = t[:, first:]
    return cache


def attn_decode(p: Params, x, positions, cache: Dict, cfg: ModelConfig, *,
                window: int = 0, lora=None, lora_scale: float = 0.0,
                decode_attn_fn: Optional[Callable] = None):
    """One-token decode. x: (B, 1, d); positions: (B,). Returns (out,
    cache); the new token's K/V are written into the cache in place."""
    q, k, v = _project_qkv(p, x, cfg, lora, lora_scale)
    q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
    k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
    cache = _cache_write_bulk(cache, k, v, positions[:, None], window)
    fn = decode_attn_ref if decode_attn_fn is None else decode_attn_fn
    o = fn(q[:, 0], cache["k"], cache["v"], cache["kv_pos"], positions,
           window)
    out = _out_proj(p, o[:, None], cfg, lora, lora_scale)
    return out, cache


def decode_attn_ref(q, kc, vc, kv_pos, positions, window: int = 0,
                    scale: Optional[float] = None, scales=None):
    """Dense decode attention oracle. q: (B, H, hd); cache (B, S, KV, hd).

    Keeps the reference's bf16 behaviour: the softmax weights are cast to
    the cache dtype before the PV product (f32 accumulation), and the
    output is in the cache dtype."""
    if scales is not None and scales[0] is not None:
        raise NotImplementedError(
            "int8 KV caches (kv_quant) are not ported yet (ROADMAP.md §1 "
            "item 5.7)")
    B, H, hd = q.shape
    KV = kc.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qr = q.reshape(B, KV, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qr, kc.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= positions[:, None])
    if window > 0:
        valid = valid & (kv_pos > positions[:, None] - window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    pmax = s.amax(dim=-1, keepdim=True)
    pmax = torch.where(torch.isneginf(pmax), 0.0, pmax)
    e = torch.exp(s - pmax)
    e = torch.where(valid, e, 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", e.to(vc.dtype).float(), vc.float())
    o = o / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return o.reshape(B, H, hd).to(vc.dtype)
