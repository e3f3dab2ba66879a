"""Layout adapters between the model and the kernels.

`decode_attention` matches `attention.decode_attn_ref`'s signature so that
`model.decode_step` can swap the paged decode kernel in. `lora_matmul`
flattens leading dimensions for the differentiable LoRA matmul kernel, as
`repro/kernels/ops.py::lora_matmul` does; it pads nothing, since the
kernel predicates ragged edges itself. Unlike the reference's decode
adapter (`repro/kernels/ops.py`), `decode_attention` never falls back to
the dense oracle: a cache whose length 64 does not divide is read as one
page per slot, a windowed (SWA) ring goes through the kernel too (the
reference's adapter sends every windowed cache to the oracle), and what
the kernel cannot compute raises: an int8 cache (`scales`), which K1
cannot read and `attention.attn_decode` sends to the oracle before this
adapter is reached (the reference's adapter takes the scales and ignores
them). `ssd_scan` is the
forward-only SSD scan kernel's wrapper with the contract of
`models/ssm.py::ssd_chunked`; unlike
`repro/kernels/ops.py::ssd_scan` it pads no ragged tail (the kernel reads
those rows as zeros) and has no head-block loop (TPU blocking).

The kernels take local tensors: a DTensor (the sharded path,
`distributed/sharding.py`, which runs with the kernels off, as the
reference's sharded cells do) raises here.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import lora_matmul as _lm
from repro_torch.kernels import ssd_scan as _ssd


def _local_only(*tensors) -> None:
    """Raise if a DTensor reaches a kernel (none exists unless
    `torch.distributed.tensor` was imported)."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and any(isinstance(t, dt.DTensor) for t in tensors):
        raise TypeError("a DTensor reached a CUDA kernel's wrapper: the "
                        "sharded path runs with use_kernels=False")


def decode_attention(q, kc, vc, kv_pos, positions, window: int = 0,
                     scale=None, page_tokens: int = 64, scales=None):
    """Dense-cache adapter: treats each slot's contiguous cache as pages.

    q: (B, H, hd); kc/vc: (B, S, KV, hd); kv_pos: (B, S); positions: (B,).
    Slot b holds positions 0..positions[b] at indices 0..positions[b] (the
    engine's prefill + decode writes), so its length is positions[b] + 1
    and kv_pos is not read. A windowed cache is a ring of S <= window
    slots (`attention.make_cache`) holding positions max(0, p - S + 1)..p,
    which are exactly those `decode_attn_ref` accepts (kv_pos > p -
    window), in some order: softmax over a set does not depend on its
    order, and RoPE was applied before the write, so the kernel reads the
    first min(p + 1, S) slots. q is read in the cache's dtype and the
    output is in the cache's dtype, as `decode_attn_ref`'s is."""
    _local_only(q, kc, vc, kv_pos, positions)
    if scales is not None and scales[0] is not None:
        raise ValueError(
            "K1 has no int8 path (the reference's kernel has none either): "
            "attention.attn_decode routes int8 caches to decode_attn_ref")
    B, S, KV, hd = kc.shape
    if window > 0 and S > window:
        raise ValueError(f"a windowed cache holds at most window = {window} "
                         f"slots, got {S}")
    ptok = page_tokens if S % page_tokens == 0 else S
    n_pages = S // ptok
    k_pages = kc.reshape(B * n_pages, ptok, KV, hd)
    v_pages = vc.reshape(B * n_pages, ptok, KV, hd)
    # a new table each call (one small launch); inside a CUDA graph it
    # comes from the graph's pool, like K1's workspace
    page_table = torch.arange(B * n_pages, dtype=torch.int32,
                              device=kc.device).reshape(B, n_pages)
    lengths = positions + 1
    if window > 0:
        lengths = lengths.clamp(max=S)
    lengths = lengths.to(torch.int32)
    return _da.paged_decode_attention(q.to(kc.dtype).contiguous(), k_pages,
                                      v_pages, page_table, lengths,
                                      scale=scale)


def lora_matmul(x, w, a, b, scale: float):
    """x: (..., K); w: (K, N); a: (K, r); b: (r, N) -> (..., N), through
    `lora_matmul.LoRAMatmul` (gradients for x, a and b)."""
    _local_only(x, w, a, b)
    lead = x.shape[:-1]
    y = _lm.LoRAMatmul.apply(x.reshape(-1, x.shape[-1]).contiguous(), w, a,
                             b, float(scale))
    return y.reshape(*lead, w.shape[1])


def ssd_scan(*args, **kwargs):
    """`ssd_scan.ssd_scan`, which keeps `ssd_chunked`'s contract and checks
    dtypes and strides itself."""
    _local_only(*args, *kwargs.values())
    return _ssd.ssd_scan(*args, **kwargs)
