"""Model assembly: the dense decoder (full or sliding-window attention),
the Mixture-of-Experts decoder and the SSM family, serving and training
paths.

Port of the dense, MoE and SSM halves of `repro/models/model.py`. Params
are a dict of tensors under the JAX pytree's names:
  {"embed": (V, d), "final_norm": (d,), ["unembed": (V, d)],
   "pre": [], "post": [],
   "scan": {"ln1", "attn": {"wq", "wk", "wv", "wo", ["q_norm", "k_norm"]},
            "ln2", "mlp": {"gate", "up", "down"}}}   # leading axis = layer
or, for an MoE stack (`mixtral-8x7b`), "moe": {"router", "gate", "up",
"down", ["shared"]} in place of "mlp" (`models/moe.py`), or, for the SSM
family (`mamba2-780m`),
   "scan": {"ln1", "ssm": {"in_proj", "conv_w", "conv_b", "A_log",
                           "dt_bias", "D", "gate_norm", "out_proj"}},
and caches mirror it: {"pre": [], "scan": {"k", "v", "kv_pos"}, "post": []}
with k/v (n_layers, B, S, KV, hd), S = s_max or, for sliding-window
attention, a ring of min(s_max, window) slots (`attention.make_cache`);
or {"h": (n_layers, B, nh, hd, ds) f32, "conv": (n_layers, B, w-1, dinner
+ 2 ds) bf16} for the SSM family.
LoRA adapters mirror it too: {"pre": [], "scan": {name: {"a": (n_layers,
d_in, r), "b": ...}}, "post": []} with f32 leaves (`models/lora.py`).

The reference's `jax.lax.scan` over the stacked params becomes a Python loop
that indexes layer `i` and writes that layer's cache in place: the caller's
cache tensors are updated, and the returned cache is the same dict.
Families the port does not run yet raise `NotImplementedError` naming the
ROADMAP item that ports them. An MoE layer's load-balance loss is
`apply_layer`'s third result; `forward` sums it over the layers and
`loss_fn` adds MOE_AUX_COEF times its mean, as the reference does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lora as LR
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

MOE_AUX_COEF = 0.01

# (predicate, what, ROADMAP item) for configurations not ported yet
_UNPORTED = (
    (lambda c: c.mla, "MLA attention", "5.3"),
    (lambda c: c.first_dense_layers,
     "leading dense layers of an MoE stack", "5.3"),
    (lambda c: c.family == "hybrid", "the hybrid RG-LRU family", "5.4"),
    (lambda c: c.enc_layers or c.cross_attention or
     c.family in ("encdec", "audio"), "the encoder-decoder family", "5.5"),
    (lambda c: c.frontend != "none" or c.family == "vlm",
     "the vision-stub frontend", "5.6"),
    (lambda c: c.kv_quant, "int8 KV caches (kv_quant)", "5.7"),
)


def _require_ported(cfg: ModelConfig) -> None:
    for pred, what, item in _UNPORTED:
        if pred(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported to PyTorch yet "
                f"(ROADMAP.md §1, modules still to port, item {item})")


def _plan(cfg: ModelConfig):
    """(pre_kinds, scan_kind, n_scan, post_kinds) — how depth is laid out."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return [], "ssm", cfg.num_layers, []
    if cfg.moe:
        return [], "moe", cfg.scanned_layers, []
    return [], "attn", cfg.num_layers, []


def _layer_window(cfg: ModelConfig) -> int:
    """The attention window of the attention layers (0: full attention;
    the hybrid family's local window comes with its port, item 5.4)."""
    return cfg.window if cfg.attn_type == "swa" else 0


# ===================================================================== init
def init_params(cfg: ModelConfig, seed: int = 0, *, dtype=torch.bfloat16,
                device=None) -> Params:
    """Random weights at the reference's scales (`model.py:40-133`), from a
    torch generator on the device (not the reference's numbers)."""
    _, scan_kind, n, _ = _plan(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, V, ff = cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, std):
        out = torch.empty(shape, dtype=dtype, device=dev)
        # one layer at a time: the f32 draw never exceeds one layer's size
        for sub in (out if len(shape) == 3 else [out]):
            sub.copy_(torch.randn(sub.shape, generator=gen, device=dev) * std)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    if scan_kind == "ssm":
        p: Params = {"embed": normal((V, d), d ** -0.5), "final_norm": ones(d),
                     "pre": [],
                     "scan": {"ln1": ones(n, d),
                              "ssm": SSM.ssm_init(gen, cfg, n, dtype=dtype)},
                     "post": []}
    else:
        attn = {"wq": normal((n, d, H * hd), d ** -0.5),
                "wk": normal((n, d, KV * hd), d ** -0.5),
                "wv": normal((n, d, KV * hd), d ** -0.5),
                "wo": normal((n, H * hd, d), (H * hd) ** -0.5)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(n, hd)
            attn["k_norm"] = ones(n, hd)
        scan = {"ln1": ones(n, d), "attn": attn, "ln2": ones(n, d)}
        if scan_kind == "moe":
            scan["moe"] = M.moe_init(gen, cfg, n, dtype=dtype)
        else:
            scan["mlp"] = {"gate": normal((n, d, ff), d ** -0.5),
                           "up": normal((n, d, ff), d ** -0.5),
                           "down": normal((n, ff, d), ff ** -0.5)}
        p = {"embed": normal((V, d), d ** -0.5), "final_norm": ones(d),
             "pre": [], "scan": scan, "post": []}
    if not cfg.tie_embeddings:
        p["unembed"] = normal((V, d), d ** -0.5)
    return p


def init_adapters(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """LoRA adapters mirroring pre/scan/post (f32 leaves, B = 0), A drawn
    from a torch generator on the device (not the reference's numbers)."""
    _, scan_kind, n, _ = _plan(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {"pre": [],
            "scan": LR.init_layer_adapters(gen, cfg, scan_kind, n,
                                           device=dev),
            "post": []}


# ==================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Per-layer caches stacked over the layers. The SSM family's state is
    f32 `h` and bf16 `conv` whatever `dtype` says (`make_ssm_state`)."""
    _, scan_kind, n, _ = _plan(cfg)
    dev = resolve_device(device)
    one = SSM.make_ssm_state(cfg, batch, device=dev) if scan_kind == "ssm" \
        else A.make_cache(cfg, batch, s_max, dtype, dev,
                          window=_layer_window(cfg))
    return {"pre": [],
            "scan": {k: v[None].repeat_interleave(n, dim=0)
                     for k, v in one.items()},
            "post": []}


def _layer(tree, i: int):
    """Layer `i` of a stacked tree, as views (writes reach the stack)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ============================================================ layer apply
def apply_layer(lp: Params, x, positions, cfg: ModelConfig, kind: str, *,
                mode: str,               # "full" | "prefill" | "decode"
                cache=None, lora=None, scale: float = 0.0,
                use_kernels: bool = False):
    """One layer of kind "attn" (dense decoder), "moe" (attention and a
    Mixture-of-Experts FFN) or "ssm" (Mamba2 mixer). Returns (x, cache,
    aux): a given cache is updated in place; aux is the MoE layer's
    load-balance loss (an f32 scalar), 0.0 for the other kinds.

    lora: pairs form {name: (A, B)} of this layer's adapters. use_kernels
    routes decode attention through the paged decode kernel (windowed
    caches too), the adapted projections through the LoRA matmul kernel,
    and the SSM prefill's scan through the SSD scan kernel. The SSM's
    "full" mode (training) keeps the plain, differentiable scan: the
    kernel has no backward."""
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
    if kind not in ("attn", "moe"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  "(ROADMAP.md §1, modules still to port, "
                                  "item 5)")
    window = _layer_window(cfg)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mode == "decode":
        attn_out, cache = A.attn_decode(
            lp["attn"], h, positions, cache, cfg, window=window, lora=lora,
            lora_scale=scale,
            decode_attn_fn=kops.decode_attention if use_kernels else None)
    else:
        attn_out, cache = A.attn_prefill(
            lp["attn"], h, positions, cfg, window=window, cache=cache,
            lora=lora, lora_scale=scale, use_kernels=use_kernels)
    x = x + attn_out
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
    optional "positions": (B, S)}. Returns (last_logits (B, V), cache).
    use_kernels routes the SSM family's scan through the SSD scan kernel
    (`kernels/ops.ssd_scan`); prefill attention is plain torch either way
    (the reference's is jnp, no kernel)."""
    _, scan_kind, n, _ = _plan(cfg)
    x, positions, _ = _embed_inputs(params, cfg, batch)
    for i in range(n):
        x, _, _ = apply_layer(_layer(params["scan"], i), x, positions, cfg,
                              scan_kind, mode="prefill",
                              cache=_layer(cache["scan"], i),
                              use_kernels=use_kernels)
    return _head(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens, positions, cache, *,
                use_kernels: bool = False):
    """One decode token. tokens/positions: (B,). Returns (logits (B, V),
    cache). use_kernels routes decode attention through the CUDA kernel
    (`kernels/ops.decode_attention`); the SSM family's decode is plain
    torch either way (the reference's is jnp, no kernel)."""
    _, scan_kind, n, _ = _plan(cfg)
    x = L.embed(tokens.long()[:, None], params["embed"])     # (B, 1, d)
    for i in range(n):
        x, _, _ = apply_layer(_layer(params["scan"], i), x, positions, cfg,
                              scan_kind, mode="decode",
                              cache=_layer(cache["scan"], i),
                              use_kernels=use_kernels)
    return _head(params, cfg, x), cache


def _embed_inputs(params, cfg: ModelConfig, batch: Dict):
    """Token embedding. Returns (x, positions, text_offset); the port runs
    no frontend yet (`_plan` raises for one), so the offset is 0."""
    tokens = batch["tokens"]
    x = L.embed(tokens.long(), params["embed"])
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    return x, positions, 0


def forward(params, cfg: ModelConfig, batch: Dict, *, adapters=None,
            use_kernels: bool = False, remat: bool = False,
            return_hidden: bool = False):
    """Full-sequence forward (train / eval). Returns (logits, aux_loss);
    with return_hidden=True the normed final hidden states instead of
    logits (loss_fn fuses the projection into the chunked CE). remat
    recomputes each layer in the backward pass (`torch.utils.checkpoint`,
    the reference's `jax.checkpoint` of the scan body)."""
    _, scan_kind, n, _ = _plan(cfg)
    x, positions, offset = _embed_inputs(params, cfg, batch)
    scale = LR.lora_scale(cfg)
    scan_ad = None if adapters is None else adapters["scan"]

    def layer(h, i):
        ad = None if scan_ad is None else LR.slice_adapters(scan_ad, i)
        h, _, a = apply_layer(_layer(params["scan"], i), h, positions, cfg,
                              scan_kind, mode="full", lora=ad, scale=scale,
                              use_kernels=use_kernels)
        return h, a

    aux = 0.0                   # a tensor once an MoE layer adds its loss
    for i in range(n):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, i, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = layer(x, i)
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
    """Cross-entropy (+ MoE aux) loss for (PEFT) training; the final
    projection is fused into the chunked CE, which never holds the (B, S,
    V) logits."""
    hidden, aux = forward(params, cfg, batch, adapters=adapters,
                          use_kernels=use_kernels, remat=remat,
                          return_hidden=True)
    labels = batch["labels"]
    mask = batch.get("mask")
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    ce = L.chunked_softmax_xent(hidden[:, :-1], table, labels[:, 1:],
                                None if mask is None else mask[:, 1:])
    # no MTP head (deepseek-v3, ROADMAP.md §1 item 5.3)
    total = ce + MOE_AUX_COEF * aux / max(cfg.num_layers, 1)
    return total, {"ce": ce, "aux": aux}
