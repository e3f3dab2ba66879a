"""Arithmetic shared by the readers of one quantity in several cells."""

from __future__ import annotations

from perfbench.roofline import counts as C
from perfbench.roofline.peaks import BF16_FLOPS, HBM_BYTES


def k1_roofline(rec):
    """% of the HBM bound K1's calls in the window reach: their bytes over
    3.35e12 B/s, over K1's device time (its split and combine kernels)."""
    if rec.trace is None or not rec.rounds:
        return None
    secs, _ = rec.trace.device_s("paged_decode")
    if secs <= 0:
        return None
    need = sum(rec.arch.n_layers * C.k1_bytes(rec.arch, r.lengths)
               for r in rec.rounds)
    return 100.0 * need / HBM_BYTES / secs


def k2_roofline(rec):
    """% of its roofline K2 reaches: the larger of FLOPs / 989e12 and bytes
    / 3.35e12, summed over the calls of the window's units, over K2's
    device time."""
    if rec.trace is None:
        return None
    secs, _ = rec.trace.device_s("lora_matmul")
    if secs <= 0:
        return None
    M = rec.micro_batch * rec.seq_len
    bound = 0.0
    for r in rec.rounds:
        for u in r.units:
            for call in C.k2_calls(rec.arch, rec.unit_kinds[u], M):
                f, b = C.k2_flops_bytes(*call)
                bound += max(f / BF16_FLOPS, b / HBM_BYTES)
    return 100.0 * bound / secs


def device_idle(rec):
    """% of the traced window in which no operation ran on the device."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def model_flops(rec) -> float:
    """The window's model FLOPs: decode tokens at their contexts, the
    admissions' prefills, and the finetune units (`roofline/counts.py`)."""
    a = rec.arch
    f = sum(C.decode_token_flops(a, c) for r in rec.rounds
            for c in r.contexts)
    f += sum(C.prefill_flops(a, x.prompt_len) for x in rec.admissions)
    f += sum(C.unit_flops(a, rec.unit_kinds[u], rec.micro_batch, rec.seq_len)
             for r in rec.rounds for u in r.units)
    return f


def mfu(rec):
    """% of the bf16 peak: the window's model FLOPs over its length x
    989e12."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * model_flops(rec) / (rec.trace.window_s * BF16_FLOPS)
