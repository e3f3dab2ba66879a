#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`src/repro_torch`).

  python3 chip_smoke.py          # from the repository root, on a machine with one card

Phases, in order; any failure ends the run with a nonzero exit:
  1. environment: torch, the card, its power limit; build the CUDA kernels
     from `src/repro_torch/kernels/csrc` and print the build time;
  2. the paged decode kernel (K1) against its plain torch version on the
     card at serving shapes (llama3-8b and qwen2.5-7b heads, bf16 and f32,
     B in {1, 8}, 16 pages of 64 tokens), timed beside its HBM bound, the
     plain version and one SDPA call over the same cache (a yardstick the
     port never calls);
  3. the main path: `ServingEngine(use_kernels=True)` serves 16 requests on
     full-width llama3-8b (random seeded bf16 weights, 8 slots, s_max 1024),
     with the kernel's launch count read just before and after; then one
     decode step with and without the kernel on the same cache, and K1 timed
     on that cache;
  4. a profiler window over decode steps: device time by kernel, the
     device's busy share, and the host's CUDA launch/copy/sync calls.
The second line from the end lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the repository
around it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain: bf16 rounds the output once (2^-8 relative); f32 sums in
# another order than the plain einsum
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the same, as max error over the RMS of the plain output: a dropped page or
# a wrong tile moves outputs by about their own size; one bf16 rounding of
# an element a few times the RMS stays under 2e-2
K1_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# decode step with the kernel vs the dense oracle, full width: the oracle
# rounds its softmax weights to bf16 before PV and the kernel keeps them in
# f32; 32 bf16 layers carry that difference to logits of size ~4
LOGIT_TOL = 0.25
K1_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
K1_REPLACES = "src/repro/kernels/decode_attention.py:76"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


_FLUSH = None


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call, by CUDA events; the 50 MB L2 is
    overwritten before each call, as a decode round's weight reads do."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def k1_bound_ms(q, k_pages, page_table, lengths):
    """Least time for the same work: each input byte read once (q, the K/V
    rows that are valid in this run's data, table, lengths), the output
    written once; flops 4 * valid tokens * H * hd over the type's peak."""
    B, H, hd = q.shape
    ptok, KV = k_pages.shape[1], k_pages.shape[2]
    pt = page_table.cpu().numpy()
    ln = lengths.cpu().numpy()
    per_page = np.clip(ln[:, None] - ptok * np.arange(pt.shape[1])[None],
                       0, ptok)
    tokens = int((per_page * (pt >= 0)).sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * tokens * KV * hd * item
              + page_table.numel() * 4 + lengths.numel() * 4)
    flops = 4 * tokens * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_call(q, k_pages, v_pages, page_table, lengths):
    """One scaled_dot_product_attention over the dense gather of the same
    pages (gathered outside the timed call)."""
    B, n = page_table.shape
    _, ptok, KV, hd = k_pages.shape
    idx = page_table.long().clamp(min=0)
    k = k_pages[idx].reshape(B, n * ptok, KV, hd).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(B, n * ptok, KV, hd).transpose(1, 2).contiguous()
    pos = torch.arange(n * ptok, device=q.device)
    valid = (pos[None] < lengths[:, None]) & \
        (page_table >= 0).repeat_interleave(ptok, dim=1)
    mask = valid[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def check_k1(K, q, kp, vp, pt, lengths, label):
    """Kernel vs plain on one input; returns the kernels-line numbers."""
    got = K.paged_decode_attention(q, kp, vp, pt, lengths)
    expect = K.paged_decode_attention_plain(q, kp, vp, pt, lengths)
    torch.cuda.synchronize()
    err = (got.float() - expect.float()).abs().max().item()
    tol, rel_tol = K1_TOL[q.dtype], K1_REL_TOL[q.dtype]
    rel = err / expect.float().square().mean().sqrt().item()
    ok = torch.allclose(got.float(), expect.float(), atol=tol, rtol=tol) \
        and rel <= rel_tol
    lib = sdpa_call(q, kp, vp, pt, lengths)
    lib_err = (lib().float() - expect.float()).abs().max().item()
    ms = time_ms(lambda: K.paged_decode_attention(q, kp, vp, pt, lengths))
    plain_ms = time_ms(
        lambda: K.paged_decode_attention_plain(q, kp, vp, pt, lengths))
    library_ms = time_ms(lib)
    bound_ms, bound_by = k1_bound_ms(q, kp, pt, lengths)
    log(f"K1 {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"max_err_over_rms={rel:.3e} (tol {rel_tol}) ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(sdpa err {lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"bound_share={bound_ms / ms:.3f}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def k1_inputs(B, H, KV, hd, ptok, npg, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = B * npg + 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, kp, vp = randn(B, H, hd), randn(P, ptok, KV, hd), randn(P, ptok, KV, hd)
    pt = torch.randperm(P, generator=g, device="cuda")[:B * npg]
    pt = pt.reshape(B, npg).to(torch.int32)
    pt[0, -1] = -1                                  # a skipped page
    lengths = torch.randint(1, npg * ptok + 1, (B,), generator=g,
                            device="cuda").to(torch.int32)
    if B > 1:
        lengths[-1] = 1
    return q, kp, vp, pt, lengths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------- 1. environment --
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{sorted(str(p.relative_to(ROOT)) for p in libs.values())}")
    for name, lib in libs.items():
        report = (lib.parent / f"{name}.log").read_text().strip()
        log(f"nvcc {name}:\n{report}")

    # ------------------------------------------- 2. K1 vs plain, on card --
    for dtype in (torch.bfloat16, torch.float32):
        for H, KV in ((32, 8), (28, 4)):           # llama3-8b, qwen2.5-7b
            for B in (1, 8):
                args = k1_inputs(B, H, KV, 128, 64, 16, dtype, seed=B + H)
                check_k1(K, *args, label=f"{str(dtype)[6:]} H={H} KV={KV} "
                         f"g={H // KV} B={B} ptok=64 pages=16 lengths="
                         f"{args[4].tolist()}")

    # ------------------------------------ 3. main path: full-width serve --
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"llama3-8b weights: {weight_bytes / 1e9:.3f} GB bf16, random "
        f"(seed 0), init {time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    K.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    m = eng.run_trace(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = K.LAUNCHES, K.PLAIN_CALLS
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, 32 new tokens each")
    log(f"serve: rounds={m.decode_rounds} tokens_out={m.tokens_out} "
        f"prefills={m.prefills} wall_s={wall:.3f} "
        f"tokens_per_s={m.tokens_out / wall:.1f} "
        f"round_ms_median={1e3 * statistics.median(m.round_s):.3f} "
        f"round_ms_p90={1e3 * float(np.percentile(m.round_s, 90)):.3f} "
        f"prefill_ms_median={1e3 * statistics.median(m.prefill_s):.3f} "
        f"prefill_ms_mean={1e3 * statistics.mean(m.prefill_s):.3f} "
        f"max_memory_allocated_gb={peak / 1e9:.3f}")
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    log(f"serve: decode-round bound from weight reads alone "
        f"{(weight_bytes - embed_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    log(f"serve: K1 launches={launches} (32 x {m.decode_rounds} rounds = "
        f"{32 * m.decode_rounds}), plain calls={plain_calls}")
    if not all(r.phase.value == "done" and r.generated == 32 for r in reqs):
        raise AssertionError("not every request finished")
    if launches != cfg.num_layers * m.decode_rounds or plain_calls:
        raise AssertionError("decode attention did not run through K1")

    pos = (eng.cache["scan"]["kv_pos"][0] >= 0).sum(dim=-1).to(torch.int32)
    tok = torch.tensor(eng.last_token, device=dev)
    logits_k, _ = MD.decode_step(params, cfg, tok, pos, eng.cache,
                                 use_kernels=True)
    logits_r, _ = MD.decode_step(params, cfg, tok, pos, eng.cache)
    diff = (logits_k.float() - logits_r.float()).abs().max().item()
    agree = (logits_k.argmax(-1) == logits_r.argmax(-1)).float().mean().item()
    log(f"decode step, kernel vs dense oracle at positions {pos.tolist()}: "
        f"max_abs_logit_diff={diff:.4f} (tol {LOGIT_TOL}, max |logit| "
        f"{logits_r.float().abs().max().item():.3f}) greedy_agreement={agree}")
    if logits_k.shape != (8, cfg.vocab_size) or \
            not torch.isfinite(logits_k).all() or diff > LOGIT_TOL:
        raise AssertionError("decode step through K1 disagrees with oracle")

    kc = eng.cache["scan"]["k"][0]
    n_pages = kc.shape[1] // 64
    main_args = (torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                             generator=torch.Generator(dev).manual_seed(7)
                             ).to(torch.bfloat16),
                 kc.reshape(8 * n_pages, 64, cfg.num_kv_heads, cfg.head_dim),
                 eng.cache["scan"]["v"][0].reshape(
                     8 * n_pages, 64, cfg.num_kv_heads, cfg.head_dim),
                 torch.arange(8 * n_pages, dtype=torch.int32,
                              device=dev).reshape(8, n_pages),
                 pos + 1)
    main_k1 = check_k1(K, *main_args, label="main path (llama3-8b layer-0 "
                       f"cache after serving, lengths {(pos + 1).tolist()})")

    # ---------------------------------------------- 4. profiler window --
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            MD.decode_step(params, cfg, tok, pos, eng.cache, use_kernels=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # device-side events only: a host op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(r[1] for r in rows)
    log(f"profile: 5 decode steps, wall {window * 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, busy share {busy_us / 1e6 / window:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"profile:   {us / 1e3 / 5:9.4f} ms/step  x{count // 5:<4d} "
            f"{key[:90]}")
    # host side: CUDA runtime/driver calls (launches, copies, synchronizations)
    api = [(e.key, e.self_cpu_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and
           (e.key.startswith("cuda") or e.key.startswith("cuLaunch"))]
    log(f"profile: device events per step "
        f"{sum(r[2] for r in rows) / 5:.1f}; host API calls per step:")
    for key, us, count in sorted(api, key=lambda r: -r[2])[:8]:
        log(f"profile:   x{count / 5:<7.1f} {us / 1e3 / 5:9.4f} ms/step  "
            f"{key[:60]}")

    # small width, f32: the same decode step against the oracle at 2e-4
    small = smoke_config("llama3-8b")
    sp = MD.init_params(small, 1, dtype=torch.float32, device=dev)
    sc = MD.init_cache(small, 2, 128, dtype=torch.float32, device=dev)
    stoks = torch.randint(0, small.vocab_size, (2, 20), device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    MD.prefill(sp, small, {"tokens": stoks}, sc)
    spos = torch.full((2,), 20, dtype=torch.int32, device=dev)
    a, _ = MD.decode_step(sp, small, stoks[:, -1], spos, sc, use_kernels=True)
    b, _ = MD.decode_step(sp, small, stoks[:, -1], spos, sc)
    small_diff = (a - b).abs().max().item()
    log(f"smoke-width f32 decode step, kernel vs oracle: max_abs_diff="
        f"{small_diff:.3e} (tol 2e-4)")
    if not torch.allclose(a, b, atol=2e-4, rtol=2e-4):
        raise AssertionError("smoke-width decode step disagrees")

    log(f"card: {card_line()}")
    log(json.dumps({"kernels": [dict(
        name="decode_attention", route="cuda", source=K1_SOURCE,
        replaces=K1_REPLACES, launches=launches, **main_k1)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
