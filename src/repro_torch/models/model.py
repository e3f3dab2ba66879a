"""Model assembly: the dense decoder (full or sliding-window attention),
the Mixture-of-Experts decoder (with deepseek-v3's MLA attention, leading
dense layers and multi-token-prediction loss), the SSM family, the hybrid
RG-LRU family, the vision-stub frontend and the encoder-decoder family,
serving and training paths.

Port of `repro/models/model.py`. Params are a dict of tensors under the
JAX pytree's names:
  {"embed": (V, d), "final_norm": (d,), ["unembed": (V, d)],
   "pre": [layer, ...],      # unrolled leading layers, no layer axis
   "scan": {"ln1", "attn": {"wq", "wk", "wv", "wo", ["q_norm", "k_norm"]},
            "ln2", "mlp": {"gate", "up", "down"}},   # leading axis = layer
   "post": [layer, ...],     # unrolled trailing layers, no layer axis
   ["enc": {"scan": layer_stack, "final_norm": (d,)}],
   ["mtp": {"norm_h", "norm_e", "proj", "layer"}]}
or, for an MoE stack (`mixtral-8x7b`), "moe": {"router", "gate", "up",
"down", ["shared"]} in place of "mlp" (`models/moe.py`); with MLA
(`deepseek-v3-671b`) "attn" is {"wq_a", "q_norm", "wq_b", "wkv_a",
"kv_norm", "wkv_b", "wo"} (`attention.mla_init`), `first_dense_layers`
dense layers of kind "attn" come first in "pre", and "mtp" holds the
multi-token-prediction head. For the SSM family (`mamba2-780m`),
   "scan": {"ln1", "ssm": {"in_proj", "conv_w", "conv_b", "A_log",
                           "dt_bias", "D", "gate_norm", "out_proj"}}.
The hybrid family (`recurrentgemma-2b`) stacks superblocks of its
`hybrid_pattern` ("rra": two RG-LRU layers, then local attention):
"scan" is {"sub0", "sub1", "sub2"}, an "rglru" layer being {"ln1", "rg":
{"in_y", "in_x", "conv_w", "conv_b", "gate_a", "gate_x", "lamb",
"out_proj"}, "ln2", "mlp"} (`models/rglru.py`), and the layers left over
when the depth is not a multiple of the pattern go unstacked in "post"
(26 = 8 x 3 + 2 RG-LRU layers).
Caches mirror it: {"pre": [cache, ...], "scan": {"k", "v", "kv_pos"},
"post": [cache, ...]} with k/v (n_layers, B, S, KV, hd), S = s_max or,
for sliding-window and the hybrid's local attention, a ring of
min(s_max, window) slots (`attention.make_cache`); MLA's latent {"c_kv",
"k_rope", "kv_pos"}; {"h": (n_layers, B, nh, hd, ds) f32, "conv":
(n_layers, B, w-1, dinner + 2 ds) bf16} for the SSM family; {"h": (B,
w) f32, "conv": (B, 3, w) bf16} per RG-LRU layer. With `kv_quant` the
GQA caches (full, sliding-window and the hybrid's local rings) hold int8
K/V and per-token f32 "k_scale"/"v_scale" (B, S); MLA's latent cache and
the encoder-decoder's self cache stay bf16, as in the reference.
LoRA adapters mirror it too: {"pre": [{name: {"a": (d_in, r), "b": ...}},
...], "scan": {name: {"a": (n_layers, d_in, r), "b": ...}}, "post": [...]}
with f32 leaves (`models/lora.py`), nested under "sub{i}" for the hybrid.

A vision-stub model (`phi-3-vision-4.2b`) takes `batch["frontend"]`, (B,
F, d) patch embeddings, ahead of its tokens (`_embed_inputs`): prefill
writes the cache at positions 0..F+P-1, and `forward` and `loss_fn` drop
the first F rows of the output.

The encoder-decoder family (`seamless-m4t-large-v2`, family "audio")
stacks "dec" layers: {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}, a
self-attention, a cross-attention over the encoder's output and the MLP.
The bidirectional encoder ("enc" layers, dense layers whose attention is
not causal and takes the soft cap) runs over `batch["enc_frames"]`, (B,
Se, d) stub frame embeddings (`_encode`), without autograd: no adapter
reaches it or the cross-attention, whose LoRA the reference leaves out.
A "dec" layer's cache is {"self": the GQA cache, "xk", "xv": (B, enc_len,
KV, hd)}: prefill writes the cross-attention's K/V of the encoder output
into xk/xv, in place, and decode reads them back (plain flash attention,
no kernel in the reference either), so `decode_step` never encodes.

The reference's `jax.lax.scan` over the stacked params becomes a Python loop
that indexes layer `i` and writes that layer's cache in place: the caller's
cache tensors are updated, and the returned cache is the same dict. The
"pre" layers run first and the "post" layers last, in prefill, decode and
forward alike, as in the reference. An MoE layer's load-balance loss is
`apply_layer`'s third result; `forward` sums it over the layers and
`loss_fn` adds MOE_AUX_COEF times its mean, and MTP_COEF times the MTP
head's cross-entropy, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lora as LR
from repro_torch.models import moe as M
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

Params = Dict[str, Any]

MOE_AUX_COEF = 0.01
MTP_COEF = 0.3

def _plan(cfg: ModelConfig):
    """(pre_kinds, scan_kind, n_scan, post_kinds) — how depth is laid out."""
    if cfg.family == "hybrid" and cfg.hybrid_pattern:
        plen = len(cfg.hybrid_pattern)
        n_blocks = cfg.num_layers // plen
        rem = cfg.num_layers - n_blocks * plen
        return [], "hybrid_block", n_blocks, \
            [_sub_kind(cfg.hybrid_pattern[i]) for i in range(rem)]
    if cfg.family == "ssm":
        return [], "ssm", cfg.num_layers, []
    if cfg.family in ("encdec", "audio") and cfg.cross_attention:
        return [], "dec", cfg.num_layers, []
    if cfg.moe:
        return ["attn"] * cfg.first_dense_layers, "moe", \
            cfg.scanned_layers, []
    return [], "attn", cfg.num_layers, []


def _sub_kind(ch: str) -> str:
    """The layer kind of a hybrid pattern's letter ("r" or "a")."""
    return "rglru" if ch == "r" else "attn"


def _layer_window(cfg: ModelConfig) -> int:
    """The attention window of the attention layers: the hybrid family's
    local window, the SWA window, or 0 (full attention)."""
    if cfg.family == "hybrid":
        return cfg.local_window
    return cfg.window if cfg.attn_type == "swa" else 0


# ===================================================================== init
def init_params(cfg: ModelConfig, seed: int = 0, *, dtype=torch.bfloat16,
                device=None) -> Params:
    """Random weights at the reference's scales (`model.py:40-133`), from a
    torch generator on the device (not the reference's numbers). Each
    leaf is drawn one layer at a time, an MoE layer one expert at a
    time: the f32 draw never exceeds one layer's leaf."""
    pre_kinds, scan_kind, n, post_kinds = _plan(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, V, ff = cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, std):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for sub in (out if len(shape) == 3 else [out]):
            sub.copy_(torch.randn(sub.shape, generator=gen, device=dev) * std)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def gqa(lead):
        attn = {"wq": normal(lead + (d, H * hd), d ** -0.5),
                "wk": normal(lead + (d, KV * hd), d ** -0.5),
                "wv": normal(lead + (d, KV * hd), d ** -0.5),
                "wo": normal(lead + (H * hd, d), (H * hd) ** -0.5)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(*lead, hd)
            attn["k_norm"] = ones(*lead, hd)
        return attn

    def attn_layer(kind, n_layers=0):
        """Layer weights of an "attn", "enc", "dec" or "moe" kind (a "dec"
        layer's cross-attention "xattn" is GQA, never MLA); n_layers > 0
        stacks them on a leading axis."""
        lead = (n_layers,) if n_layers else ()
        attn = A.mla_init(normal, ones, cfg, lead) if cfg.mla else gqa(lead)
        layer = {"ln1": ones(*lead, d), "attn": attn, "ln2": ones(*lead, d)}
        if kind == "dec":
            layer.update(lnx=ones(*lead, d), xattn=gqa(lead))
        if kind == "moe":
            layer["moe"] = M.moe_init(gen, cfg, n_layers, dtype=dtype)
        else:
            layer["mlp"] = mlp(lead)
        return layer

    def mlp(lead):
        return {"gate": normal(lead + (d, ff), d ** -0.5),
                "up": normal(lead + (d, ff), d ** -0.5),
                "down": normal(lead + (ff, d), ff ** -0.5)}

    def layer(kind, n_layers=0):
        """Layer weights of any kind but "ssm" (stacked when n_layers)."""
        lead = (n_layers,) if n_layers else ()
        if kind == "hybrid_block":
            return {f"sub{i}": layer(_sub_kind(ch), n_layers)
                    for i, ch in enumerate(cfg.hybrid_pattern)}
        if kind == "rglru":
            return {"ln1": ones(*lead, d),
                    "rg": RG.rglru_init(gen, cfg, n_layers, dtype=dtype),
                    "ln2": ones(*lead, d), "mlp": mlp(lead)}
        return attn_layer(kind, n_layers)

    pre = [layer(kind) for kind in pre_kinds]
    if scan_kind == "ssm":                  # the embedding first, as before
        embed = normal((V, d), d ** -0.5)
        scan = {"ln1": ones(n, d), "ssm": SSM.ssm_init(gen, cfg, n,
                                                       dtype=dtype)}
    else:
        scan = layer(scan_kind, n)
        embed = normal((V, d), d ** -0.5)
    p: Params = {"embed": embed, "final_norm": ones(d), "pre": pre,
                 "scan": scan, "post": [layer(kind) for kind in post_kinds]}
    if not cfg.tie_embeddings:
        p["unembed"] = normal((V, d), d ** -0.5)
    if cfg.enc_layers:
        p["enc"] = {"scan": layer("enc", cfg.enc_layers),
                    "final_norm": ones(d)}
    if cfg.mtp:
        p["mtp"] = {"norm_h": ones(d), "norm_e": ones(d),
                    "proj": normal((2 * d, d), (2 * d) ** -0.5),
                    "layer": attn_layer("attn")}
    return p


def init_adapters(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """LoRA adapters mirroring pre/scan/post (f32 leaves, B = 0), A drawn
    from a torch generator on the device (not the reference's numbers). A
    "dec" layer's are those of an "attn" layer (self-attention and MLP);
    the encoder and the cross-attention take none, as in the reference."""
    pre_kinds, scan_kind, n, post_kinds = _plan(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def layer(kind, n_layers=0):
        if kind == "hybrid_block":
            return {f"sub{i}": layer(_sub_kind(ch), n_layers)
                    for i, ch in enumerate(cfg.hybrid_pattern)}
        return LR.init_layer_adapters(gen, cfg, {"dec": "attn"}.get(
            kind, kind), n_layers, device=dev)
    return {"pre": [layer(kind) for kind in pre_kinds],
            "scan": layer(scan_kind, n),
            "post": [layer(kind) for kind in post_kinds]}


# ==================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int = 0,
               dtype=torch.bfloat16, device=None) -> Params:
    """Per-layer caches: one per "pre" layer, and the scanned layers'
    stacked on a leading axis. The SSM family's state is f32 `h` and bf16
    `conv` whatever `dtype` says (`make_ssm_state`). enc_len: the encoder
    frames a "dec" layer's cross K/V hold (every request's prefill must
    bring exactly that many). `kv_quant` makes the attention caches int8,
    but a "dec" layer's self cache, as the reference's `layer_cache`
    does."""
    pre_kinds, scan_kind, n, post_kinds = _plan(cfg)
    dev = resolve_device(device)

    def one(kind):
        if kind == "ssm":
            return SSM.make_ssm_state(cfg, batch, device=dev)
        if kind == "rglru":
            return RG.make_rglru_state(cfg, batch, device=dev)
        if kind == "hybrid_block":
            return {f"sub{i}": one(_sub_kind(ch))
                    for i, ch in enumerate(cfg.hybrid_pattern)}
        if kind == "dec":
            cross = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
            return {"self": A.make_cache(cfg, batch, s_max, dtype, dev),
                    "xk": torch.zeros(cross, dtype=dtype, device=dev),
                    "xv": torch.zeros(cross, dtype=dtype, device=dev)}
        return A.make_cache(cfg, batch, s_max, dtype, dev,
                            window=_layer_window(cfg),
                            quantized=cfg.kv_quant)
    return {"pre": [one(kind) for kind in pre_kinds],
            "scan": tree_map(lambda v: v[None].repeat_interleave(n, dim=0),
                             one(scan_kind)),
            "post": [one(kind) for kind in post_kinds]}


def _layer(tree, i: int):
    """Layer `i` of a stacked tree, as views (writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(cfg: ModelConfig, tree):
    """[(kind, layer)] in depth order of a params, cache or adapter tree:
    the "pre" layers, the scanned stack's layers as views, then the
    "post" layers."""
    pre_kinds, scan_kind, n, post_kinds = _plan(cfg)
    return list(zip(pre_kinds, tree["pre"])) + \
        [(scan_kind, _layer(tree["scan"], i)) for i in range(n)] + \
        list(zip(post_kinds, tree["post"]))


# ============================================================ layer apply
def apply_layer(lp: Params, x, positions, cfg: ModelConfig, kind: str, *,
                mode: str,               # "full" | "prefill" | "decode"
                cache=None, lora=None, scale: float = 0.0,
                enc_out=None, use_kernels: bool = False):
    """One layer of kind "attn" (dense decoder), "moe" (attention and a
    Mixture-of-Experts FFN), "ssm" (Mamba2 mixer), "rglru" (the Griffin
    recurrent block with its parallel `rg_io` adapter, then the GLU MLP),
    "hybrid_block" (the hybrid's superblock: one sub-layer per letter
    of `hybrid_pattern`, params, cache and adapters under "sub{i}"), "enc"
    (the encoder's: bidirectional, soft-capped attention, no cache) or
    "dec" (self-attention, cross-attention over `enc_out` or, at decode,
    over the cached xk/xv, then the MLP).
    Returns (x, cache, aux): a given cache is updated in place; aux is
    the MoE layer's load-balance loss (an f32 scalar), 0.0 for the other
    kinds.

    lora: pairs form {name: (A, B)} of this layer's adapters. use_kernels
    routes GQA decode attention through the paged decode kernel (windowed
    caches too; MLA's decode has no kernel, in the reference either), the
    adapted projections through the LoRA matmul kernel,
    and the SSM prefill's scan through the SSD scan kernel. The SSM's
    "full" mode (training) keeps the plain, differentiable scan: the
    kernel has no backward."""
    if kind == "hybrid_block":
        for i, ch in enumerate(cfg.hybrid_pattern):
            x, _, _ = apply_layer(
                lp[f"sub{i}"], x, positions, cfg, _sub_kind(ch), mode=mode,
                cache=None if cache is None else cache[f"sub{i}"],
                lora=None if lora is None else lora.get(f"sub{i}"),
                scale=scale, use_kernels=use_kernels)
        return x, cache, 0.0
    if kind == "rglru":
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if mode == "decode":
            out, new = RG.rglru_decode(lp["rg"], h, cache, cfg)
        else:
            out, new = RG.rglru_forward(lp["rg"], h, cfg, state=cache)
        if cache is not None:
            for name, t in cache.items():
                t.copy_(new[name])
        x = x + _parallel_lora(h, out, lora, "rg_io", scale)
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + L.glu_mlp(h, lp["mlp"]["gate"], lp["mlp"]["up"],
                             lp["mlp"]["down"], act=cfg.act, lora=lora,
                             lora_scale=scale, use_kernels=use_kernels), \
            cache, 0.0
    if kind == "ssm":
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if mode == "decode":
            out, new = SSM.ssm_decode(lp["ssm"], h, cache, cfg)
        else:
            out, new = SSM.ssm_prefill(
                lp["ssm"], h, cfg, state=cache,
                use_kernel=use_kernels and mode == "prefill")
        if cache is not None:
            for name, t in cache.items():
                t.copy_(new[name])
        return x + _parallel_lora(h, out, lora, "ssm_io", scale), cache, 0.0
    window = _layer_window(cfg)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    self_cache = cache["self"] if kind == "dec" and cache is not None \
        else cache
    if kind == "enc":
        q, k, v = A._project_qkv(lp["attn"], h, cfg, None, 0.0)
        o = L.flash_attention(L.apply_rope(q, positions, cfg.rope_theta),
                              L.apply_rope(k, positions, cfg.rope_theta), v,
                              causal=False, soft_cap=cfg.logits_soft_cap)
        attn_out = A._out_proj(lp["attn"], o, cfg, None, 0.0)
    elif cfg.mla:               # no decode kernel: the reference's has none
        if mode == "decode":
            attn_out, cache = A.mla_decode(lp["attn"], h, positions, cache,
                                           cfg, lora=lora, lora_scale=scale)
        else:
            attn_out, cache = A.mla_prefill(
                lp["attn"], h, positions, cfg, cache=cache, lora=lora,
                lora_scale=scale, use_kernels=use_kernels)
    elif mode == "decode":
        attn_out, _ = A.attn_decode(
            lp["attn"], h, positions, self_cache, cfg, window=window,
            lora=lora, lora_scale=scale,
            decode_attn_fn=kops.decode_attention if use_kernels else None)
    else:
        attn_out, _ = A.attn_prefill(
            lp["attn"], h, positions, cfg, window=window, cache=self_cache,
            lora=lora, lora_scale=scale, use_kernels=use_kernels)
    x = x + attn_out
    if kind == "dec":
        x = x + _cross_attention(lp["xattn"],
                                 L.rms_norm(x, lp["lnx"], cfg.norm_eps),
                                 cfg, cache, enc_out)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind == "moe":
        router_type = "sigmoid" if cfg.mla else "softmax"
        out, maux = M.moe_forward(lp["moe"], h, cfg, router_type=router_type,
                                  lora=lora, lora_scale=scale,
                                  use_kernels=use_kernels)
        return x + out, cache, maux["lb_loss"]
    x = x + L.glu_mlp(h, lp["mlp"]["gate"], lp["mlp"]["up"],
                      lp["mlp"]["down"], act=cfg.act, lora=lora,
                      lora_scale=scale, use_kernels=use_kernels)
    return x, cache, 0.0


def _cross_attention(p: Params, h, cfg: ModelConfig, cache, enc_out):
    """Decoder-to-encoder attention (`model.py:312-328`), no adapters and
    no mask. Given `enc_out` (prefill, training), K/V are projected from
    it and, with a cache, written into its xk/xv in place; without
    (decode), they are read from the cache. Nothing is masked: an idle
    slot's cross K/V are the cache's zeros, which give uniform weights
    over zero values, so 0."""
    B = h.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ p["wq"].to(h.dtype)).reshape(B, -1, H, hd)
    if enc_out is None:
        xk, xv = cache["xk"], cache["xv"]
    else:
        xk = (enc_out @ p["wk"].to(h.dtype)).reshape(B, -1, KV, hd)
        xv = (enc_out @ p["wv"].to(h.dtype)).reshape(B, -1, KV, hd)
        if cache is not None:
            if cache["xk"].shape != xk.shape:
                raise ValueError(
                    f"the cache holds the cross K/V of "
                    f"{cache['xk'].shape[1]} encoder frames (init_cache's "
                    f"enc_len), the batch has {xk.shape[1]}")
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    o = L.flash_attention(q, xk, xv, causal=False).reshape(B, -1, H * hd)
    # o is in the cache's dtype at decode; the product takes the wider of
    # it and h's, as the reference's mixed-dtype einsum does
    wo = p["wo"].to(h.dtype)
    dt = torch.promote_types(o.dtype, wo.dtype)
    return o.to(dt) @ wo.to(dt)


def _parallel_lora(h, out, lora, name: str, scale: float):
    """Parallel low-rank adapter on a mixer block's I/O path."""
    if lora and name in lora:
        a, b = lora[name]
        out = out + scale * ((h @ a.to(h.dtype)) @ b.to(h.dtype))
    return out


# ================================================================= drivers
def _head(params, cfg: ModelConfig, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.lm_logits(x, table)[:, 0]


def prefill(params, cfg: ModelConfig, batch: Dict, cache, *,
            use_kernels: bool = False):
    """Prompt processing: forward + cache fill. batch: {"tokens": (B, S),
    optional "positions": (B, S), and "enc_frames" (B, Se, d) for the
    encoder-decoder family}. Returns (last_logits (B, V), cache).
    use_kernels routes the SSM family's scan through the SSD scan kernel
    (`kernels/ops.ssd_scan`); prefill attention is plain torch either way
    (the reference's is jnp, no kernel)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    enc_out = _encode(params, cfg, batch) if cfg.enc_layers else None
    for (kind, lp), (_, lc) in zip(_layers(cfg, params),
                                   _layers(cfg, cache)):
        x, _, _ = apply_layer(lp, x, positions, cfg, kind, mode="prefill",
                              cache=lc, enc_out=enc_out,
                              use_kernels=use_kernels)
    return _head(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens, positions, cache, *,
                use_kernels: bool = False):
    """One decode token. tokens/positions: (B,). Returns (logits (B, V),
    cache). use_kernels routes GQA decode attention through the CUDA
    kernel (`kernels/ops.decode_attention`), a "dec" layer's
    self-attention too; MLA's, the SSM family's, an int8 cache's and the
    cross-attention's decode are plain torch either way (the reference's
    are jnp, no kernel). The encoder does not run: the cross K/V are in
    the cache."""
    x = L.embed(tokens.long()[:, None], params["embed"])     # (B, 1, d)
    x = SH.constrain(x, ("batch", None, None))
    for (kind, lp), (_, lc) in zip(_layers(cfg, params),
                                   _layers(cfg, cache)):
        x, _, _ = apply_layer(lp, x, positions, cfg, kind, mode="decode",
                              cache=lc, use_kernels=use_kernels)
    return _head(params, cfg, x), cache


def _embed_inputs(params, cfg: ModelConfig, batch: Dict):
    """Token (+ frontend) embedding. Returns (x, positions, text_offset):
    a vision stub's (B, F, d) patch embeddings (`batch["frontend"]`, cast
    to the embedding's dtype) come ahead of the tokens, positions run
    over both, and text_offset is F (0 without a frontend)."""
    tokens = batch["tokens"]
    x = L.embed(tokens.long(), params["embed"])
    offset = 0
    if cfg.frontend != "none" and batch.get("frontend") is not None:
        fe = batch["frontend"].to(x.dtype)
        x = torch.cat([fe, x], dim=1)
        offset = fe.shape[1]
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x = SH.constrain(x, ("batch", "seq_sp", None))
    return x, positions, offset


def _encode(params, cfg: ModelConfig, batch: Dict):
    """The bidirectional encoder over the stub frame embeddings
    `batch["enc_frames"]` (B, Se, d), cast to the embedding's dtype, at
    positions 0..Se-1, then its final norm (`model.py:363-376`). Runs
    without autograd: no adapter reaches the encoder, so a backward pass
    keeps none of its layers' activations."""
    x = batch["enc_frames"].to(params["embed"].dtype)
    B, Se = x.shape[:2]
    x = SH.constrain(x, ("batch", "seq_sp", None))
    positions = torch.arange(Se, dtype=torch.int32,
                             device=x.device).expand(B, Se)
    enc = params["enc"]
    with torch.no_grad():
        for i in range(cfg.enc_layers):
            x, _, _ = apply_layer(_layer(enc["scan"], i), x, positions, cfg,
                                  "enc", mode="full")
        return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch: Dict, *, adapters=None,
            use_kernels: bool = False, remat: bool = False,
            return_hidden: bool = False):
    """Full-sequence forward (train / eval). Returns (logits, aux_loss);
    with return_hidden=True the normed final hidden states instead of
    logits (loss_fn fuses the projection into the chunked CE). remat
    recomputes each layer in the backward pass (`torch.utils.checkpoint`,
    the reference's `jax.checkpoint` of the scan body; the port's takes
    the "pre" and "post" layers too, which changes memory, not values)."""
    x, positions, offset = _embed_inputs(params, cfg, batch)
    enc_out = _encode(params, cfg, batch) if cfg.enc_layers else None
    scale = LR.lora_scale(cfg)
    layers = _layers(cfg, params)
    ads = [None] * len(layers) if adapters is None else \
        [LR.as_pairs(ad) for _, ad in _layers(cfg, adapters)]

    def layer(h, j):
        kind, lp = layers[j]
        h, _, a = apply_layer(lp, h, positions, cfg, kind, mode="full",
                              lora=ads[j], scale=scale, enc_out=enc_out,
                              use_kernels=use_kernels)
        return h, a

    aux = 0.0                   # a tensor once an MoE layer adds its loss
    for j in range(len(layers)):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, j, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=SH.checkpoint_contexts)
        else:
            x, a = layer(x, j)
        aux = aux + a
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x[:, offset:], aux
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.lm_logits(x[:, offset:], table), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict, *, adapters=None,
            use_kernels: bool = False, remat: bool = True):
    """Cross-entropy (+ MoE aux + MTP) loss for (PEFT) training; the final
    projection is fused into the chunked CE, which never holds the (B, S,
    V) logits. The MTP term reads frozen weights only (`_mtp_loss`), so
    it adds to the loss and to no adapter's gradient, as in the
    reference."""
    hidden, aux = forward(params, cfg, batch, adapters=adapters,
                          use_kernels=use_kernels, remat=remat,
                          return_hidden=True)
    labels = batch["labels"]
    mask = batch.get("mask")
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    ce = L.chunked_softmax_xent(hidden[:, :-1], table, labels[:, 1:],
                                None if mask is None else mask[:, 1:])
    total = ce + MOE_AUX_COEF * aux / max(cfg.num_layers, 1)
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp and "mtp" in params:
        mtp_ce = _mtp_loss(params, cfg, batch)
        total = total + MTP_COEF * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return total, metrics


def _mtp_loss(params, cfg: ModelConfig, batch: Dict):
    """DeepSeek-V3 multi-token prediction as the reference approximates
    it (`model.py:464-482`): predict token t+2 from the normed embeddings
    of tokens t and t+1, projected and run through one dense "attn" layer
    (no cache, no adapters) over positions 0..S-2. Its cross-entropy is
    the chunked one (never (B, S, V) logits), unmasked as in the
    reference."""
    mp = params["mtp"]
    tokens, labels = batch["tokens"].long(), batch["labels"]
    B, S = tokens.shape
    h = torch.cat([L.rms_norm(L.embed(tokens[:, :-1], params["embed"]),
                              mp["norm_h"], cfg.norm_eps),
                   L.rms_norm(L.embed(tokens[:, 1:], params["embed"]),
                              mp["norm_e"], cfg.norm_eps)], dim=-1)
    h = h @ mp["proj"].to(h.dtype)
    positions = torch.arange(S - 1, dtype=torch.int32,
                             device=h.device).expand(B, S - 1)
    h, _, _ = apply_layer(mp["layer"], h, positions, cfg, "attn",
                          mode="full")
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.chunked_softmax_xent(h[:, :-1], table, labels[:, 2:])
