"""Operations and bytes the benchmark's work needs, from the shapes and
lengths the window fed (bf16 operands: 2 bytes an element).

K1 (paged decode attention), one call per attention layer per decode
round: it reads q (B, H, hd), the K and V of every slot's valid
positions (its length, `lengths[b]`), and writes the output (B, H, hd);
each once.

K2 (the LoRA matmul, y = x @ W + s (x @ A) @ B), one call per adapted
projection: FLOPs 2 M K N + 2 M K r + 2 M r N; bytes x (M, K), W (K, N),
A (K, r), B (r, N) and y (M, N), each once. A FWD unit calls it once per
adapted projection (M = micro-batch x sequence), a BWD unit twice (the
recomputed forward and dx = dy @ W^T, whose K and N swap); EMBED, HEAD,
EMBED_BWD and OPT do not call it (these models have no layers ahead of
or after the stack).

Model FLOPs (the whole step's work, no recompute counted): a decode
token at context c costs 2 x the layer's matrix parameters it uses (an
MoE layer: the router and top-k experts) plus 4 H hd c per layer for
attention, plus 2 d V for the head; a prefill of P tokens costs P x the
matrix FLOPs, 2 H hd P (P + 1) per layer of causal attention, and one
head row. A finetune FWD unit costs the forward of its layer over the
micro-batch (with the LoRA products), a BWD unit the layer's dx
(2 x its matrix parameters per token, attention twice its forward) and
the LoRA's dx, dA and dB, HEAD the logits and their dx (4 d V per
row), the other units nothing.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

from perfbench.reference.model import Arch, lora_dims

BYTES = 2   # bf16


def k1_bytes(arch: Arch, lengths: Iterable[int]) -> float:
    lengths = list(lengths)
    B, H, KV, hd = len(lengths), arch.n_heads, arch.n_kv, arch.head_dim
    return BYTES * (2 * B * H * hd + 2 * sum(lengths) * KV * hd)


def k2_calls(arch: Arch, kind: str, M: int) -> List[Tuple[int, int, int, int]]:
    """(M, K, N, r) of each K2 call a unit of `kind` makes."""
    r = arch.lora_rank
    fwd = [(M, din, dout, r) for din, dout in lora_dims(arch).values()]
    if kind == "FWD":
        return fwd
    if kind == "BWD":
        return fwd + [(M, dout, din, r)
                      for din, dout in lora_dims(arch).values()]
    return []


def k2_flops_bytes(M: int, K: int, N: int, r: int) -> Tuple[float, float]:
    return (2.0 * M * K * N + 2.0 * M * K * r + 2.0 * M * r * N,
            float(BYTES * (M * K + K * N + K * r + r * N + M * N)))


def layer_matrix_params(arch: Arch) -> int:
    """Matrix parameters one token uses in one layer."""
    d, hd = arch.d, arch.head_dim
    attn = d * hd * (2 * arch.n_heads + 2 * arch.n_kv)
    if arch.moe:
        return attn + d * arch.n_experts + arch.top_k * 3 * d * arch.moe_ff
    return attn + 3 * d * arch.ff


def decode_token_flops(arch: Arch, ctx: int) -> float:
    L, H, hd = arch.n_layers, arch.n_heads, arch.head_dim
    return L * (2.0 * layer_matrix_params(arch) + 4.0 * H * hd * ctx) + \
        2.0 * arch.d * arch.vocab


def prefill_flops(arch: Arch, P: int) -> float:
    L, H, hd = arch.n_layers, arch.n_heads, arch.head_dim
    return L * (2.0 * layer_matrix_params(arch) * P
                + 2.0 * H * hd * P * (P + 1)) + 2.0 * arch.d * arch.vocab


def lora_token_flops(arch: Arch) -> float:
    """Forward LoRA products per token and layer."""
    return sum(2.0 * arch.lora_rank * (din + dout)
               for din, dout in lora_dims(arch).values())


def unit_flops(arch: Arch, kind: str, batch: int, seq: int) -> float:
    M = batch * seq
    H, hd = arch.n_heads, arch.head_dim
    attn_fwd = batch * 2.0 * H * hd * seq * (seq + 1)
    if kind == "FWD":
        return M * (2.0 * layer_matrix_params(arch) + lora_token_flops(arch)) \
            + attn_fwd
    if kind == "BWD":
        # dx through the base products and the LoRA, plus dA and dB
        return M * (2.0 * layer_matrix_params(arch)
                    + 2.0 * lora_token_flops(arch)) + 2.0 * attn_fwd
    if kind == "HEAD":
        return 4.0 * batch * (seq - 1) * arch.d * arch.vocab
    return 0.0
