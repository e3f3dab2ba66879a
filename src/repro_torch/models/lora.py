"""LoRA adapters (the PEFT workload Harli co-locates with decode).

Port of `repro/models/lora.py`. Adapters are a tree parallel to the
model's layer stack (a leading layer axis on every stacked leaf): for each
adapted projection `{"a": (d_in, r), "b": (r, d_out)}`. Trainable leaves
are f32 (cast to the activation dtype on use); base weights stay frozen
bf16. B starts at 0, so a fresh adapter is a no-op. The random A comes
from an explicit `torch.Generator`, so it is not the reference's numbers:
tests carry the reference's adapters across with `interop.to_torch`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


def _target_dims(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[int, int]]:
    """name -> (d_in, d_out) of the adapted projection for a layer kind."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    t = cfg.lora.targets if cfg.lora else ()
    out: Dict[str, Tuple[int, int]] = {}
    if kind in ("attn", "moe", "xattn"):
        if cfg.mla:
            if "q" in t:
                out["q"] = (cfg.mla_q_rank,
                            H * (cfg.mla_nope_dim + cfg.mla_rope_dim))
            if "o" in t:
                out["o"] = (H * cfg.mla_v_dim, d)
        else:
            if "q" in t:
                out["q"] = (d, H * hd)
            if "k" in t:
                out["k"] = (d, KV * hd)
            if "v" in t:
                out["v"] = (d, KV * hd)
            if "o" in t:
                out["o"] = (H * hd, d)
    if kind in ("attn", "rglru"):
        ff = cfg.d_ff
        if "gate" in t:
            out["gate"] = (d, ff)
        if "up" in t:
            out["up"] = (d, ff)
        if "down" in t:
            out["down"] = (ff, d)
    if kind == "moe" and cfg.num_shared_experts:
        sf = cfg.num_shared_experts * cfg.moe_d_ff
        if "gate" in t:
            out["gate"] = (d, sf)
        if "up" in t:
            out["up"] = (d, sf)
        if "down" in t:
            out["down"] = (sf, d)
    if kind == "ssm":
        out["ssm_io"] = (d, d)
    if kind == "rglru":
        out["rg_io"] = (d, d)
    return out


def init_layer_adapters(gen: torch.Generator, cfg: ModelConfig, kind: str,
                        n_layers: int = 0, dtype=torch.float32,
                        device=None) -> Dict:
    """Adapters for one layer kind; n_layers > 0 adds a leading stack axis.
    A ~ N(0, 1/d_in) drawn from `gen` (on `gen`'s device), B = 0."""
    r = cfg.lora.rank
    out = {}
    for name, (din, dout) in _target_dims(cfg, kind).items():
        shape_a = (n_layers, din, r) if n_layers else (din, r)
        shape_b = (n_layers, r, dout) if n_layers else (r, dout)
        a = torch.randn(shape_a, generator=gen, device=gen.device)
        out[name] = {"a": (a * din ** -0.5).to(device=device, dtype=dtype),
                     "b": torch.zeros(shape_b, dtype=dtype, device=device)}
    return out


def lora_scale(cfg: ModelConfig) -> float:
    return cfg.lora.alpha / cfg.lora.rank if cfg.lora else 0.0


def _is_leaf(v) -> bool:
    return isinstance(v, dict) and set(v) == {"a", "b"} and not isinstance(
        v["a"], dict)


def slice_adapters(adapters: Optional[Dict], i) -> Optional[Dict]:
    """Take layer i from a stacked adapter tree -> nested {name: (A, B)}."""
    if adapters is None:
        return None
    return {k: (v["a"][i], v["b"][i]) if _is_leaf(v) else slice_adapters(v, i)
            for k, v in adapters.items()}


def as_pairs(adapters: Optional[Dict]) -> Optional[Dict]:
    """Unstacked adapter dict -> nested {name: (A, B)}."""
    if adapters is None:
        return None
    return {k: (v["a"], v["b"]) if _is_leaf(v) else as_pairs(v)
            for k, v in adapters.items()}


def adapter_count(adapters) -> int:
    if isinstance(adapters, dict):
        return sum(adapter_count(v) for v in adapters.values())
    if isinstance(adapters, (list, tuple)):
        return sum(adapter_count(v) for v in adapters)
    return adapters.numel()
