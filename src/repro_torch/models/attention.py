"""Attention layers: GQA/MHA (+ qk_norm, SWA windows) and MLA.

Port of `repro/models/attention.py`. Two execution paths per layer:
  * prefill/train: chunked flash attention over the whole sequence
  * decode: one-token attention against a KV cache (`decode_attn_ref`
    here; the CUDA kernel is swapped in by `kernels/ops.decode_attention`)

Cache layout per layer (per-request absolute positions, so continuous
batching works): k/v (B, S, KV, hd), kv_pos (B, S) int32 (-1 = empty).
A full cache has S = s_max and token p in slot p. A windowed (SWA) cache
is a ring of S = min(s_max, window) slots, token p in slot p % S, so after
position p is written it holds exactly positions max(0, p - S + 1)..p.
An int8 cache (`quantized`, the model's `kv_quant`) holds k/v as int8 and
per-token f32 scales k_scale/v_scale (B, S): each token's K (and V) is
scaled by its largest |value| over (KV, hd) / 127 and rounded half to
even (`_quantize_tok`). Decode reads it through `decode_attn_ref` alone,
the scales folded into the scores and the softmax weights, as in the
reference: K1 has no int8 path there either (`attn_decode` counts these
calls in `INT8_ORACLE_CALLS`).
An MLA cache (deepseek-v3) holds the latent instead: c_kv (B, S, kv_rank),
k_rope (B, S, rope_dim), kv_pos (B, S); it stays bf16 under `kv_quant`.
Unlike the reference, cache writes update the given tensors in place and
return the same dict: a decode round then moves no cache copy.

MLA's decode is the reference's absorbed form: W_kv_b's key half folds
into q and its value half is applied after the latent PV product, so
attention runs in the kv_rank space and reads only the latent cache.
Every MLA product is a plain matrix product, as in the reference (no
Pallas kernel covers MLA; its decode takes no `decode_attn_fn`); the
adapted q and o projections go through the LoRA matmul kernel with
`use_kernels`, as the GQA projections do. `mla_decode_expanded` is the
unabsorbed form on the same cache, the oracle the absorbed decode is
held against.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

# decode calls that an int8 cache sent to `decode_attn_ref`; a CUDA graph
# that captured them adds them again at every replay (`core/graphs.py`)
INT8_ORACLE_CALLS = 0
COUNTERS = ("INT8_ORACLE_CALLS",)


def make_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None, window: int = 0,
               quantized: bool = False) -> Dict[str, torch.Tensor]:
    """Empty per-layer cache (without the leading layer axis); a ring of
    min(s_max, window) slots when windowed; int8 K/V with per-token f32
    scales when quantized (not for MLA, whose latent cache stays in
    `dtype`, as in the reference)."""
    eff = min(s_max, window) if window else s_max
    if cfg.mla:
        return {
            "c_kv": torch.zeros((batch, eff, cfg.mla_kv_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, eff, cfg.mla_rope_dim),
                                  dtype=dtype, device=device),
            "kv_pos": torch.full((batch, eff), -1, dtype=torch.int32,
                                 device=device),
        }
    shape = (batch, eff, cfg.num_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if quantized else dtype
    c = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "kv_pos": torch.full((batch, eff), -1, dtype=torch.int32,
                             device=device),
    }
    if quantized:
        c["k_scale"] = torch.zeros((batch, eff), dtype=torch.float32,
                                   device=device)
        c["v_scale"] = torch.zeros((batch, eff), dtype=torch.float32,
                                   device=device)
    return c


def _quantize_tok(x):
    """Per-token symmetric int8: x (B, S, KV, hd) -> (q int8, scale (B, S)
    f32), scale = max(amax, 1e-6) / 127 and q = round(x / scale) clipped
    to +-127; `torch.round` rounds half to even, as `jnp.round` does."""
    x = x.float()
    scale = torch.clamp(x.abs().amax(dim=(2, 3)), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale[:, :, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_entries(cache, k, v, positions):
    """{cache leaf name: what to write into it} for a token chunk: k/v
    (int8 with their scales for an int8 cache) and the positions."""
    if "k_scale" not in cache:
        return {"k": k, "v": v, "kv_pos": positions}
    kq, ks = _quantize_tok(k)
    vq, vs = _quantize_tok(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
            "kv_pos": positions}


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
    return SH.constrain(L.lora_proj(o, p["wo"], lora, "o", lora_scale,
                                    use_kernels), ("batch", "seq_sp", None))


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
    q = SH.constrain(q, ("batch", None, "heads", None))
    k = SH.constrain(k, ("batch", None, "kv_heads", None))
    v = SH.constrain(v, ("batch", None, "kv_heads", None))
    o = L.flash_attention(q, k, v, causal=True, window=window,
                          q_offset=positions[:, 0])
    out = _out_proj(p, o, cfg, lora, lora_scale, use_kernels)
    if cache is not None:
        # the cache's (seq-sharded, heads-replicated) layout before the write
        kw = SH.constrain(k, ("batch", "seq_sp", None, None))
        vw = SH.constrain(v, ("batch", "seq_sp", None, None))
        cache = _cache_write_prefill(cache, kw, vw, positions, window)
    return out, cache


def _cache_write_bulk(cache, k, v, positions, window: int = 0):
    """Scatter a token chunk (B, s, KV, hd) at `positions` (B, s), in
    place; into slot p % S of the ring when windowed; quantized per token
    first into an int8 cache. On a mesh-laid-out cache each rank writes
    its own block (`sharding.write_slots`)."""
    S_max = cache["k"].shape[1]
    slots = (positions % S_max if window else positions).long()
    SH.write_slots(cache, slots, _kv_entries(cache, k, v, positions))
    return cache


def _cache_write_prefill(cache, k, v, positions, window: int = 0):
    """Contiguous prefill write (prompt positions are arange-contiguous
    per request, from 0), in place; quantized per token first into an int8
    cache. A full cache takes the first S_max tokens from slot 0, as does
    a ring of W slots a chunk of S <= W tokens (token p in slot p % W = p:
    the reference's `_ring_quant_fallback` scatter writes the same slots).
    A ring takes of S > W tokens only the last W, as two slice writes
    split at S % W."""
    S_max = cache["k"].shape[1]
    S = k.shape[1]
    entries = _kv_entries(cache, k, v, positions)
    if not window or S <= S_max:
        n = min(S, S_max)
        for name, t in entries.items():
            cache[name][:, :n] = t[:, :n].to(cache[name].dtype)
        return cache
    W = S_max
    split = S % W
    first = W - split
    for name, t in entries.items():
        buf, t = cache[name], t[:, -W:].to(cache[name].dtype)
        buf[:, split:] = t[:, :first]
        if split:
            buf[:, :split] = t[:, first:]
    return cache


def attn_decode(p: Params, x, positions, cache: Dict, cfg: ModelConfig, *,
                window: int = 0, lora=None, lora_scale: float = 0.0,
                decode_attn_fn: Optional[Callable] = None):
    """One-token decode. x: (B, 1, d); positions: (B,). Returns (out,
    cache); the new token's K/V are written into the cache in place. An
    int8 cache goes to `decode_attn_ref` with its scales whatever
    `decode_attn_fn` is (the reference's route: K1 has no int8 path),
    counted in `INT8_ORACLE_CALLS`."""
    global INT8_ORACLE_CALLS
    q, k, v = _project_qkv(p, x, cfg, lora, lora_scale)
    # the new token's q/k/v replicated on the model axis, as the
    # sequence-sharded cache they meet
    q = SH.constrain(q, ("batch", None, None, None))
    k = SH.constrain(k, ("batch", None, None, None))
    v = SH.constrain(v, ("batch", None, None, None))
    q = L.apply_rope(q, positions[:, None], cfg.rope_theta)
    k = L.apply_rope(k, positions[:, None], cfg.rope_theta)
    cache = _cache_write_bulk(cache, k, v, positions[:, None], window)
    scales = (cache.get("k_scale"), cache.get("v_scale"))
    if scales[0] is not None:
        INT8_ORACLE_CALLS += 1
        o = decode_attn_ref(q[:, 0], cache["k"], cache["v"], cache["kv_pos"],
                            positions, window, scales=scales)
    else:
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
    output is in the cache dtype. For an int8 cache (scales = (k_scale,
    v_scale), (B, S) f32) the scales fold into the scores and the softmax
    weights, not into the cache: the scores are q rounded to bf16 x the
    int8 K (f32 sums) times k_scale and the scale, the softmax weights
    times v_scale are cast to bf16 before PV, the sum is normalised by the
    weights' sum without v_scale, and the output is in q's dtype, as in
    the reference."""
    B, H, hd = q.shape
    KV = kc.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    quant = scales is not None and scales[0] is not None
    qr = q.reshape(B, KV, g, hd)
    if quant:
        s = torch.einsum("bkgh,bskh->bkgs", qr.to(torch.bfloat16).float(),
                         kc.float()) * scales[0][:, None, None, :] * scale
    else:
        s = torch.einsum("bkgh,bskh->bkgs", qr.float(), kc.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= positions[:, None])
    if window > 0:
        valid = valid & (kv_pos > positions[:, None] - window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    pmax = s.amax(dim=-1, keepdim=True)
    pmax = torch.where(torch.isneginf(pmax), 0.0, pmax)
    e = torch.exp(s - pmax)
    e = torch.where(valid, e, 0.0)
    ew = e * scales[1][:, None, None, :] if quant else e
    o = torch.einsum("bkgs,bskh->bkgh",
                     ew.to(torch.bfloat16 if quant else vc.dtype).float(),
                     vc.float())
    o = o / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return o.reshape(B, H, hd).to(q.dtype if quant else vc.dtype)


# -------------------------------------------------------------- MLA paths ---
def mla_init(normal, ones, cfg: ModelConfig, lead=()) -> Params:
    """MLA weights at the reference's scales (`attention.py:45-59`), drawn
    by `model.init_params`' `normal(shape, std)` and `ones(*shape)`;
    lead = (n_layers,) adds a leading stack axis."""
    d, H = cfg.d_model, cfg.num_heads
    qr, kr = cfg.mla_q_rank, cfg.mla_kv_rank
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    return {"wq_a": normal(lead + (d, qr), d ** -0.5),
            "q_norm": ones(*lead, qr),
            "wq_b": normal(lead + (qr, H * (nd + rd)), qr ** -0.5),
            "wkv_a": normal(lead + (d, kr + rd), d ** -0.5),
            "kv_norm": ones(*lead, kr),
            "wkv_b": normal(lead + (kr, H * (nd + vd)), kr ** -0.5),
            "wo": normal(lead + (H * vd, d), (H * vd) ** -0.5)}


def _mla_q(p: Params, x, positions, cfg: ModelConfig, lora, lora_scale,
           use_kernels: bool = False, decode: bool = False):
    """(q_nope, q_rope) (..., S, H, nd / rd) of x (..., S, d); the q
    adapter sits on the latent cq, after q_norm, as in the reference.
    decode (x (B, 1, d)): q is laid out column-sharded, then replicated,
    in two steps (one would gather the wq_b weight, not q)."""
    H, nd, rd = cfg.num_heads, cfg.mla_nope_dim, cfg.mla_rope_dim
    cq = L.rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = L.lora_proj(cq, p["wq_b"], lora, "q", lora_scale, use_kernels)
    if decode:
        q = SH.constrain(q, ("batch", None, "ff"))
        q = SH.constrain(q, ("batch", None, None))
    q = q.reshape(*x.shape[:-1], H, nd + rd)
    return q[..., :nd], L.apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _mla_latent(p: Params, x, positions, cfg: ModelConfig):
    """(c_kv (..., S, kr), k_rope (..., S, rd)) of x (..., S, d)."""
    kr = cfg.mla_kv_rank
    ckv = x @ p["wkv_a"].to(x.dtype)
    c_kv = L.rms_norm(ckv[..., :kr], p["kv_norm"], cfg.norm_eps)
    k_rope = L.apply_rope(ckv[..., kr:].unsqueeze(-2), positions,
                          cfg.rope_theta).squeeze(-2)
    return c_kv, k_rope


def mla_prefill(p: Params, x, positions, cfg: ModelConfig, *,
                cache: Optional[Dict] = None, lora=None,
                lora_scale: float = 0.0, use_kernels: bool = False):
    """Full-sequence MLA: K/V expanded from the latent through W_kv_b, the
    rope half of K shared by the heads. x: (B, S, d); positions: (B, S)
    absolute. Returns (out, cache); a given cache takes the latent of the
    first s_max tokens, in place (the reference's contiguous prefill
    write)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    q_nope, q_rope = _mla_q(p, x, positions, cfg, lora, lora_scale,
                            use_kernels)
    c_kv, k_rope = _mla_latent(p, x, positions, cfg)
    kv = (c_kv @ p["wkv_b"].to(x.dtype)).reshape(B, S, H, nd + vd)
    k = torch.cat([kv[..., :nd], k_rope[:, :, None, :].expand(B, S, H, rd)],
                  dim=-1)
    q_full = SH.constrain(torch.cat([q_nope, q_rope], dim=-1),
                          ("batch", None, "heads", None))
    k = SH.constrain(k, ("batch", None, "heads", None))
    v = SH.constrain(kv[..., nd:], ("batch", None, "heads", None))
    o = L.flash_attention(q_full, k, v, causal=True,
                          scale=(nd + rd) ** -0.5, q_offset=positions[:, 0])
    out = L.lora_proj(o.reshape(B, S, H * vd), p["wo"], lora, "o",
                      lora_scale, use_kernels)
    out = SH.constrain(out, ("batch", "seq_sp", None))
    if cache is not None:
        n = min(S, cache["c_kv"].shape[1])
        c_kv = SH.constrain(c_kv, ("batch", "seq_sp", None))
        cache["c_kv"][:, :n] = c_kv[:, :n].to(cache["c_kv"].dtype)
        cache["k_rope"][:, :n] = k_rope[:, :n].to(cache["k_rope"].dtype)
        cache["kv_pos"][:, :n] = positions[:, :n].to(torch.int32)
    return out, cache


def _mla_decode_qkv(p: Params, x, positions, cache: Dict, cfg: ModelConfig,
                    lora, lora_scale):
    """The new token's (q_nope, q_rope) (B, H, nd / rd), with its latent
    written into the cache at `positions`, in place."""
    q_nope, q_rope = _mla_q(p, x, positions[:, None], cfg, lora, lora_scale,
                            decode=True)
    c_kv, k_rope = _mla_latent(p, x, positions[:, None], cfg)
    SH.write_slots(cache, positions.long()[:, None],
                   {"c_kv": c_kv, "k_rope": k_rope,
                    "kv_pos": positions[:, None].to(torch.int32)})
    return q_nope[:, 0], q_rope[:, 0]


def _latent_softmax(s, cache: Dict, positions):
    """Masked softmax numerator and denominator of scores s (B, H, S): a
    slot with no valid position gives e = 0 and a clamped denominator, so
    its output is 0, not NaN."""
    valid = (cache["kv_pos"] >= 0) & (cache["kv_pos"] <= positions[:, None])
    valid = valid[:, None, :]
    s = torch.where(valid, s, -torch.inf)
    pmax = s.amax(dim=-1, keepdim=True)
    pmax = torch.where(torch.isneginf(pmax), 0.0, pmax)
    e = torch.where(valid, torch.exp(s - pmax), 0.0)
    return e, torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def mla_decode(p: Params, x, positions, cache: Dict, cfg: ModelConfig, *,
               lora=None, lora_scale: float = 0.0):
    """Absorbed-matmul MLA decode (`attention.py:384-450`): scores and PV
    in the latent space, so the cache stays kv_rank + rope_dim per token.
    x: (B, 1, d); positions: (B,). Scores and the PV sum are f32 (the
    reference's preferred_element_type), the softmax weights cast to the
    cache's dtype before PV, as `decode_attn_ref` does. Returns (out
    (B, 1, d), cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kr = cfg.mla_kv_rank
    q_nope, q_rope = _mla_decode_qkv(p, x, positions, cache, cfg, lora,
                                     lora_scale)
    wkv_b = p["wkv_b"].to(x.dtype).reshape(kr, H, nd + vd)
    q_lat = SH.constrain(torch.einsum("bhn,rhn->bhr", q_nope,
                                      wkv_b[..., :nd]), ("batch", None, None))
    c_kv = cache["c_kv"].float()
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv)
         + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                        cache["k_rope"].float())) * (nd + rd) ** -0.5
    e, denom = _latent_softmax(s, cache, positions)
    o_lat = torch.einsum("bhs,bsr->bhr", e.to(cache["c_kv"].dtype).float(),
                         c_kv) / denom
    o = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), wkv_b[..., nd:])
    out = L.lora_proj(o.reshape(B, 1, H * vd), p["wo"], lora, "o",
                      lora_scale)
    return out, cache


def mla_decode_expanded(p: Params, x, positions, cache: Dict,
                        cfg: ModelConfig):
    """The unabsorbed form of `mla_decode`, in f32: every cached token's
    K and V expanded from its latent through W_kv_b, then plain attention
    over them. The oracle of the absorbed product (no Pallas kernel covers
    MLA); writes the new token's latent as `mla_decode` does. Returns
    (B, 1, d) in x's dtype."""
    B = x.shape[0]
    H = cfg.num_heads
    nd, rd, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    kr = cfg.mla_kv_rank
    q_nope, q_rope = _mla_decode_qkv(p, x, positions, cache, cfg, None, 0.0)
    wkv_b = p["wkv_b"].float().reshape(kr, H, nd + vd)
    kv = torch.einsum("bsr,rho->bsho", cache["c_kv"].float(), wkv_b)
    s = (torch.einsum("bhn,bshn->bhs", q_nope.float(), kv[..., :nd])
         + torch.einsum("bhr,bsr->bhs", q_rope.float(),
                        cache["k_rope"].float())) * (nd + rd) ** -0.5
    e, denom = _latent_softmax(s, cache, positions)
    o = torch.einsum("bhs,bshv->bhv", e, kv[..., nd:]) / denom
    out = o.reshape(B, H * vd) @ p["wo"].float()
    return out[:, None].to(x.dtype)
