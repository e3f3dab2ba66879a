"""Unified model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / multimodal-stub
LMs; family-specific fields are ignored by families that don't use them.
Configs are pure data — model code lives in `models/model.py` and friends.

The port's own copy of `repro.models.config` (the port imports nothing of
the JAX package); keep the two in step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # Projections that receive adapters. SSM blocks map these onto their
    # in/out projections; MoE layers adapt attention + shared expert only
    # (routed experts stay frozen — standard practice, keeps adapters tiny).
    targets: Tuple[str, ...] = ("q", "k", "v", "o", "gate", "up", "down")
    dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # --- attention variants ---
    attn_type: str = "full"       # full | swa
    window: int = 0               # SWA window (attn_type == "swa")
    qk_norm: bool = False         # qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    logits_soft_cap: float = 0.0

    # --- MLA (deepseek-v3) ---
    mla: bool = False
    mla_q_rank: int = 1536
    mla_kv_rank: int = 512
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128       # per-head non-rope q/k dim
    mla_v_dim: int = 128          # per-head value dim

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0             # per-expert FFN hidden
    first_dense_layers: int = 0   # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma: RG-LRU + local attention) ---
    # block pattern repeated over depth; "r" = RG-LRU, "a" = local attention
    hybrid_pattern: str = ""      # e.g. "rra"
    local_window: int = 2048
    rglru_width: int = 0          # 0 -> d_model * ssm_expand is not used; RG uses its own

    # --- enc-dec (seamless) ---
    enc_layers: int = 0
    cross_attention: bool = False

    # --- multimodal stub frontend ---
    frontend: str = "none"        # none | vision | audio
    frontend_tokens: int = 0      # patches / frames supplied by input_specs()

    # --- extras ---
    kv_quant: bool = False        # int8 KV cache (per-token scales)
    mtp: bool = False             # deepseek-v3 multi-token prediction head
    mtp_depth: int = 1
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu

    # --- PEFT ---
    lora: Optional[LoRAConfig] = dataclasses.field(default_factory=LoRAConfig)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name

    # How many trailing layers are scanned homogeneously (model.py unrolls the
    # leading `first_dense_layers` for deepseek-style mixed stacks).
    @property
    def scanned_layers(self) -> int:
        return self.num_layers - self.first_dense_layers

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    # --- KV/state cache bytes per token (per layer type), used by the
    # allocator, the cost model and the roofline analysis. bf16 = 2 bytes. ---
    def kv_bytes_per_token_layer(self) -> int:
        if self.mla:
            return 2 * (self.mla_kv_rank + self.mla_rope_dim)  # latent + rope key
        return 2 * 2 * self.num_kv_heads * self.head_dim        # K and V

    def attn_layer_indices(self) -> Tuple[int, ...]:
        """Indices of layers that own a growing KV cache."""
        if self.family in ("ssm",):
            return ()
        if self.family == "hybrid" and self.hybrid_pattern:
            p = self.hybrid_pattern
            return tuple(i for i in range(self.num_layers) if p[i % len(p)] == "a")
        return tuple(range(self.num_layers))

    def effective_cache_len(self, seq_len: int) -> int:
        """Physical KV length per attention layer at context `seq_len`."""
        if self.attn_type == "swa" and self.window:
            return min(seq_len, self.window)
        if self.family == "hybrid":
            return min(seq_len, self.local_window)
        return seq_len

    def cache_bytes_per_token(self, seq_len: int = 1) -> int:
        """Marginal KV bytes per *new* token across layers (caches that grow)."""
        n_attn = len(self.attn_layer_indices())
        return n_attn * self.kv_bytes_per_token_layer()

    def state_bytes(self) -> int:
        """Fixed-size recurrent state bytes per sequence (SSM / RG-LRU)."""
        total = 0
        if self.family == "ssm":
            per_layer = 2 * self.ssm_nheads * self.ssm_headdim * self.ssm_state
            per_layer += 2 * self.ssm_dinner * (self.ssm_conv_width - 1)
            total += self.num_layers * per_layer
        if self.family == "hybrid" and self.hybrid_pattern:
            n_rec = self.num_layers - len(self.attn_layer_indices())
            total += n_rec * 2 * self.d_model * self.ssm_expand
        return total

    # --- parameter counts (analytic; cross-checked against init in tests) ---
    def param_count(self) -> int:
        d, ff, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.mla:
            per_attn = (
                d * self.mla_q_rank
                + self.mla_q_rank * H * (self.mla_nope_dim + self.mla_rope_dim)
                + d * (self.mla_kv_rank + self.mla_rope_dim)
                + self.mla_kv_rank * H * (self.mla_nope_dim + self.mla_v_dim)
                + H * self.mla_v_dim * d
            )
        per_ffn = 3 * d * ff
        total = emb
        if self.family == "ssm":
            dinner = self.ssm_dinner
            nh = self.ssm_nheads
            per_layer = (
                d * (2 * dinner + 2 * self.ssm_state + nh)   # in_proj (x,z,B,C,dt)
                + self.ssm_conv_width * (dinner + 2 * self.ssm_state)
                + 3 * nh                                      # A, dt_bias, D
                + dinner * d                                  # out_proj
                + 2 * d                                       # norms
            )
            return emb + L * per_layer
        for i in range(self.num_layers):
            is_moe = self.moe and i >= self.first_dense_layers
            kind = self.layer_kind(i)
            if kind == "rglru":
                w = self.rglru_width or d
                nb = 16 if w % 16 == 0 else 1
                total += (d * 2 * w          # in_y, in_x
                          + 5 * w            # conv w(4) + bias
                          + 2 * w * (w // nb)  # block-diag gates
                          + w                # Lambda
                          + w * d            # out_proj
                          + 3 * d * ff       # Griffin block MLP
                          + 2 * d)           # norms
                continue
            total += per_attn + 2 * d
            if is_moe:
                total += d * self.num_experts                        # router
                total += self.num_experts * 3 * d * self.moe_d_ff    # routed
                total += self.num_shared_experts * 3 * d * self.moe_d_ff
            else:
                total += per_ffn
        if self.enc_layers:
            total += self.enc_layers * (per_attn + per_ffn + 2 * d)
        if self.cross_attention:
            total += self.num_layers * (per_attn + d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts count)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        routed_inactive = (
            (self.num_layers - self.first_dense_layers)
            * (self.num_experts - self.top_k)
            * 3 * self.d_model * self.moe_d_ff
        )
        return full - routed_inactive

    def layer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.hybrid_pattern:
            p = self.hybrid_pattern
            return "rglru" if p[i % len(p)] == "r" else "attn"
        if self.moe and i >= self.first_dense_layers:
            return "moe"
        return "attn"

    def lora_param_count(self) -> int:
        if self.lora is None:
            return 0
        r = self.lora.rank
        d, ff = self.d_model, self.d_ff
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        n = 0
        t = self.lora.targets
        per_layer = 0
        if "q" in t:
            per_layer += r * (d + H * hd)
        if "k" in t:
            per_layer += r * (d + KV * hd)
        if "v" in t:
            per_layer += r * (d + KV * hd)
        if "o" in t:
            per_layer += r * (H * hd + d)
        ffh = self.moe_d_ff if self.moe else self.d_ff
        if "gate" in t:
            per_layer += r * (d + ffh)
        if "up" in t:
            per_layer += r * (d + ffh)
        if "down" in t:
            per_layer += r * (ffh + d)
        return self.num_layers * per_layer


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the reduced smoke-test sibling of a full config (same family/
    feature flags, tiny dims)."""
    base = dict(
        num_layers=min(cfg.num_layers, 2 + cfg.first_dense_layers),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        window=min(cfg.window, 64) if cfg.window else 0,
        local_window=64,
        mla_q_rank=64,
        mla_kv_rank=32,
        mla_rope_dim=16,
        mla_nope_dim=32,
        mla_v_dim=32,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe else 0,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_headdim=16,
        ssm_chunk=8,
        enc_layers=min(cfg.enc_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        lora=LoRAConfig(rank=4, targets=cfg.lora.targets if cfg.lora else ()),
        name=cfg.name + "-smoke",
    )
    if cfg.family == "hybrid":
        base["num_layers"] = 3
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
