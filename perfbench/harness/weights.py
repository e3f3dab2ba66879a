"""The benchmark's inputs, made from the seed: the weights, the LoRA
adapters' starting values and the finetune rows.

The weights and adapters are drawn on the run's device by a
`torch.Generator` there, one call per stacked leaf (a few large calls),
in the type they are served in, and laid out as the program takes them
(`{"embed", "final_norm", "unembed", "pre", "scan", "post"}`, the
layers stacked on a leading axis). Each leaf has its own generator,
seeded from the run's seed and the leaf's name, so the reference makes
the same tensors again after the program's copy is freed. The scales
are the usual ones (std d_in^-0.5, norm weights 1, LoRA A ~ N(0,
1/d_in) and B = 0).
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from perfbench.reference.model import Arch, lora_dims


def substream(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of the run's `seed`."""
    ss = np.random.SeedSequence([seed % 2 ** 64, zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _normal(seed: int, tag: str, shape, std: float, dtype, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(substream(seed, tag))
    out = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(std)


def make_params(arch: Arch, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The model's weights in the program's layout."""
    d, L, V = arch.d, arch.n_layers, arch.vocab
    H, KV, hd = arch.n_heads, arch.n_kv, arch.head_dim

    def w(tag, shape, std, dt=dtype):
        return _normal(seed, tag, shape, std, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    scan = {"ln1": ones(L, d), "ln2": ones(L, d),
            "attn": {"wq": w("wq", (L, d, H * hd), d ** -0.5),
                     "wk": w("wk", (L, d, KV * hd), d ** -0.5),
                     "wv": w("wv", (L, d, KV * hd), d ** -0.5),
                     "wo": w("wo", (L, H * hd, d), (H * hd) ** -0.5)}}
    if arch.moe:
        E, ff = arch.n_experts, arch.moe_ff
        scan["moe"] = {"router": w("router", (L, d, E), d ** -0.5,
                                   torch.float32),
                       "gate": w("gate", (L, E, d, ff), d ** -0.5),
                       "up": w("up", (L, E, d, ff), d ** -0.5),
                       "down": w("down", (L, E, ff, d), ff ** -0.5)}
    else:
        ff = arch.ff
        scan["mlp"] = {"gate": w("gate", (L, d, ff), d ** -0.5),
                       "up": w("up", (L, d, ff), d ** -0.5),
                       "down": w("down", (L, ff, d), ff ** -0.5)}
    return {"embed": w("embed", (V, d), d ** -0.5),
            "unembed": w("unembed", (V, d), d ** -0.5),
            "final_norm": ones(d), "pre": [], "scan": scan, "post": []}


def make_adapters(arch: Arch, seed: int, device) -> Dict:
    """{name: {"a": (L, d_in, r), "b": (L, r, d_out)}} f32, B = 0."""
    L, r = arch.n_layers, arch.lora_rank
    return {n: {"a": _normal(seed, f"lora.{n}", (L, din, r), din ** -0.5,
                             torch.float32, device),
                "b": torch.zeros((L, r, dout), dtype=torch.float32,
                                 device=device)}
            for n, (din, dout) in lora_dims(arch).items()}


def make_rows(vocab: int, n: int, batch: int, seq: int, seed: int,
              zipf_a: float = 1.2) -> Dict[str, np.ndarray]:
    """n finetune batches (n, batch, seq) of Zipf-distributed token ids,
    labels equal to the tokens (the loss shifts them), mask 1."""
    rng = np.random.default_rng(substream(seed, "rows"))
    toks = np.minimum(rng.zipf(zipf_a, size=(n, batch, seq)), vocab - 1)
    toks = toks.astype(np.int32)
    return {"tokens": toks, "labels": toks.copy(),
            "mask": np.ones((n, batch, seq), np.float32)}
