"""Card-only tests of the port: the CUDA paged decode kernel (K1, split
across CTAs: lengths of 0 and 1, on a page boundary, a -1 page inside a
table, one sequence with every page full), the LoRA matmul kernels (K2:
the wgmma kernel at tile edges, ranks 8-64, more tiles than SMs and
scales that are not a power of two, or 0; the WMMA kernel at ragged
shapes, the f32 kernel; forward, the transposed-W dx form, and the
autograd Function's backward; which kernel each shape took, by the
counters) and the SSD scan kernels (K3: the chunk-parallel tensor-core
kernel and the FMA kernel, which one each case took by the counters; ragged chunks, an initial state, bf16 inputs read
through the strides of the conv output) against their plain torch
versions, a decode step through K1 against the dense oracle, mamba2's
512-token prefill through K3 against an f64 recurrence, and an SSM
prefill through K3 against the plain scan; and the CUDA graphs of the
decode step and the co-located round (on llama3 and mamba2 smoke widths,
kernels on) against eager rounds, bit for bit, with `precompile` leaving
the cache and the finetune state as they were and each replay counting
its captured launches; K1 over a wrapped sliding-window ring at hd 80
(h2o-danube-1.8b) and 128 against its plain version and the windowed
oracle, the MoE layer at decode and prefill size run with host
synchronisation forbidden, and the graphed decode step, rounds and engine
on the sliding-window and MoE smoke configs too; deepseek-v3's smoke config
(MLA, a dense layer in "pre"): the absorbed MLA decode against its
unabsorbed form, graphed decode steps, engine tokens and co-located rounds
against eager ones, its units' K2 launches by kind, and its MoE routing
(256 experts, top-8, sigmoid) run with host synchronisation forbidden; a
checkpoint of card tensors saved asynchronously and then written in
place, and two steps of `launch/train.py` with K2 in each mode; K1 at
recurrentgemma-2b's hd 256 with one KV head for 10 query heads (on a
wrapped ring too) and phi-3-vision's hd 96, K2 at both models'
projections on inputs at their init scales, the hybrid's unit graphs'
K2 launches by kind, and the graphed decode step, rounds and engine on
both smoke configs (the hybrid at 5 layers, so with "post" layers; the
vision stub with its patches); K1 at seamless-m4t-large-v2's hd 64 (16
heads, g 1), K2 at its 1024 <-> 8192 projections, and the graphed decode
step, rounds and engine on its smoke config (cross K/V in the cache,
EMBED running the encoder) and on llama3's with an int8 KV cache (every
decode through the counted oracle, no K1), and two steps of
`launch/train.py` on the encoder-decoder; the recompute-backward flash
attention against plain autograd at llama3-8b's and deepseek-v3's dense
MLA training shapes, gradients and memory, and a checkpoint restored
onto a 1x1 CUDA mesh bit for bit; a split round's device marks
against its host time, and the events and captures rounds make. Each skips
with a reason where no CUDA device is present. This file
imports no JAX (the machine with the card has none), so run it there with
  PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serving.engine import DecodeGraph, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.training.data import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# B, H, KV, hd, ptok, n_pages, dtype
CASES = [
    (2, 8, 2, 64, 32, 4, torch.float32),
    (3, 4, 4, 32, 16, 3, torch.float32),
    (1, 16, 1, 128, 64, 2, torch.float32),      # MQA, g = 16
    (2, 8, 2, 64, 32, 4, torch.bfloat16),
    (2, 14, 2, 32, 16, 3, torch.float32),       # g = 7
    (3, 4, 2, 16, 160, 1, torch.bfloat16),      # one page per slot, hd 16
    (8, 32, 8, 128, 64, 16, torch.bfloat16),    # llama3-8b serving shape
    (8, 28, 4, 128, 64, 16, torch.bfloat16),    # qwen2.5-7b, g = 7
    (8, 32, 8, 128, 64, 16, torch.float32),
    # recurrentgemma-2b: MQA, g 10 x hd 256 = 2560, rings of 2048
    (8, 10, 1, 256, 64, 32, torch.bfloat16),
    (8, 10, 1, 256, 64, 32, torch.float32),
    (8, 32, 32, 96, 64, 18, torch.bfloat16),    # phi-3-vision, hd 96, g 1
    (8, 16, 16, 64, 64, 16, torch.bfloat16),    # seamless, hd 64, g 1
    (8, 16, 16, 64, 64, 16, torch.float32),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, H, KV, hd, ptok, npg, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    P = npg * B + 2

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device=device, dtype=dtype)
    q, kp, vp = t((B, H, hd)), t((P, ptok, KV, hd)), t((P, ptok, KV, hd))
    pt = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    if npg > 1:
        pt[0, -1] = -1
    lengths = rng.integers(1, npg * ptok, size=(B,)).astype(np.int32)
    lengths[-1] = 1
    return (q, kp, vp, torch.from_numpy(pt).to(device),
            torch.from_numpy(lengths).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,hd,ptok,npg,dtype", CASES)
def test_cuda_kernel_matches_plain(B, H, KV, hd, ptok, npg, dtype):
    args = _inputs(B, H, KV, hd, ptok, npg, dtype, _card())
    expect = K.paged_decode_attention_plain(*args)
    before = K.LAUNCHES
    got = K.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == expect.shape
    # bf16: one rounding of the output; f32: another summation order
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), expect.float(), atol=tol, rtol=tol)


# B, H, KV, hd, ptok, n_pages, lengths, -1 pages (b, p): the split-KV
# edges. Splits are 64 positions, so a length of 64 or 128 ends a split
# exactly; length 0 leaves every split empty.
K1_SPLIT_CASES = {
    "length 1": (2, 32, 8, 128, 64, 16, [1, 1], []),
    "page boundary": (3, 32, 8, 128, 64, 16, [64, 128, 1024], []),
    "-1 page inside": (2, 32, 8, 128, 64, 16, [1024, 700], [(0, 5), (1, 3)]),
    "length 0": (3, 32, 8, 128, 64, 16, [0, 100, 0], []),
    "B 1, all pages full": (1, 32, 8, 128, 64, 16, [1024], []),
    "one page per slot": (3, 4, 2, 16, 160, 1, [160, 7, 64], []),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K1_SPLIT_CASES))
def test_k1_splits_match_plain(case, dtype):
    B, H, KV, hd, ptok, npg, lengths, holes = K1_SPLIT_CASES[case]
    q, kp, vp, pt, _ = _inputs(B, H, KV, hd, ptok, npg, dtype, _card(),
                               seed=len(case))
    pt[0, -1] = kp.shape[0] - 1      # a real page (the pool has 2 spare) ...
    for b, p in holes:               # ... and the holes asked for
        pt[b, p] = -1
    lengths = torch.tensor(lengths, dtype=torch.int32, device=q.device)
    expect = K.paged_decode_attention_plain(q, kp, vp, pt, lengths)
    got = K.paged_decode_attention(q, kp, vp, pt, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    # bf16: one rounding of the output; f32: another summation order, and
    # the partials rescaled by exp(m_split - m) before they are summed
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), expect.float(), atol=tol, rtol=tol)
    for b, n in enumerate(lengths.tolist()):
        if n == 0:                   # nothing valid: exactly 0, not NaN
            assert not got[b].any()


@pytest.mark.gpu
def test_decode_step_through_kernel_matches_oracle():
    dev = _card()
    cfg = smoke_config("llama3-8b")
    params = MD.init_params(cfg, 0, dtype=torch.float32, device=dev)
    cache = MD.init_cache(cfg, 2, 128, dtype=torch.float32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    _, cache = MD.prefill(params, cfg, {"tokens": toks}, cache)
    tok = toks[:, -1]
    pos = torch.full((2,), 20, dtype=torch.int32, device=dev)
    before = K.LAUNCHES
    with_kernel, _ = MD.decode_step(params, cfg, tok, pos, cache,
                                    use_kernels=True)
    assert K.LAUNCHES == before + cfg.num_layers
    oracle, _ = MD.decode_step(params, cfg, tok, pos, cache)
    torch.testing.assert_close(with_kernel, oracle, atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------------ K2 ----
# M, K, N, r, dtype, transposed W
K2_CASES = [
    (64, 128, 96, 8, torch.float32, False),
    (128, 512, 256, 16, torch.float32, False),
    (37, 200, 130, 4, torch.float32, False),       # ragged M/N/K and r
    (128, 256, 128, 16, torch.bfloat16, False),
    (37, 200, 130, 4, torch.bfloat16, False),      # ragged, scalar loads
    (256, 4096, 1024, 16, torch.bfloat16, False),  # k/v projection
    (300, 1024, 200, 40, torch.bfloat16, False),   # rank 40 -> 64-wide tiles
    (256, 1024, 4096, 16, torch.bfloat16, True),   # dx form of k/v
    (37, 200, 130, 4, torch.bfloat16, True),
    (64, 96, 72, 8, torch.float32, True),
]


def _k2_inputs(M, K, N, r, dtype, trans, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.1).astype(
            np.float32)).to(device=device, dtype=dtype)
    w = t(N, K).t() if trans else t(K, N)
    return t(M, K), w, t(K, r), t(r, N)


def _rel(got, expect):
    err = (got.float() - expect.float()).abs().max().item()
    return err / expect.float().square().mean().sqrt().item()


# the wgmma kernel's edges: M, N and K one past a tile or a K step (M 200
# = 128 + 72, N 1032 = 4 x 256 + 8, K 4104 = 64 x 64 + 8), every rank size
# (A and B padded to 16, 32 or 64 by TMA's zero fill), both W forms; and
# 16 x 56 tiles of 128 x 256 on 132 SMs (gate/up and the dx form of down)
K2_CASES += [(200, 4104, 1032, r, torch.bfloat16, trans)
             for r in (8, 16, 32, 64) for trans in (False, True)]
K2_CASES += [(2048, 4096, 14336, 16, torch.bfloat16, False),
             (2048, 4096, 14336, 16, torch.bfloat16, True)]

_COUNTERS = {"wgmma": "LAUNCHES_WGMMA", "wmma": "LAUNCHES_WMMA",
             "f32": "LAUNCHES_F32"}


def _k2_counts():
    return {name: getattr(K2, name) for name in
            ("LAUNCHES", "LAUNCHES_WGMMA", "LAUNCHES_WMMA", "LAUNCHES_F32")}


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,r,dtype,trans", K2_CASES)
def test_k2_kernel_matches_plain(M, K, N, r, dtype, trans):
    x, w, a, b = _k2_inputs(M, K, N, r, dtype, trans, _card())
    expect = K2.lora_matmul_plain(x, w, a, b, 2.0)
    path = K2._k2_path(M, N, K, r, dtype)
    # ragged bf16 shapes (rows not a multiple of 16 bytes) take the WMMA
    # kernel, every other bf16 shape the wgmma kernel
    if dtype == torch.float32:
        assert path == "f32"
    elif (K, N, r) == (200, 130, 4):
        assert path == "wmma"
    else:
        assert path == "wgmma"
    before = _k2_counts()
    got = K2.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    after = _k2_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("LAUNCHES", _COUNTERS[path])) for k in after}
    assert got.dtype == dtype and got.shape == (M, N)
    # test_kernels.py's tolerances: bf16 rounds the output once, f32 sums
    # in another order
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), expect.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:          # against the unrounded plain output
        assert _rel(got, K2.lora_matmul_plain(x.float(), w, a, b, 2.0)) \
            <= 2e-2


# the wgmma epilogue forms acc + s * xa @ B as (acc / s + xa @ B) * s: exact
# at the training path's s = 2, one f32 rounding per scaling (relative 6e-8)
# at a scale that is not a power of two, far below the output's bf16
# rounding; s = 0 skips xa @ B. Both W forms, the tolerances above.
# recurrentgemma-2b's q/o, k/v, gate/up, down, phi-3-vision's q/k/v/o,
# gate/up, down and seamless-m4t-large-v2's q/k/v/o, gate/up, down at M
# 2048 (a 2 x 1024 microbatch), forward and dx form
K2_MODEL_CASES = [(2048, K, N, trans)
                  for K, N in ((2560, 2560), (2560, 256), (2560, 7680),
                               (7680, 2560), (3072, 3072), (3072, 8192),
                               (8192, 3072), (1024, 1024), (1024, 8192),
                               (8192, 1024))
                  for trans in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,trans", K2_MODEL_CASES)
def test_k2_kernel_at_model_shapes_matches_plain(M, K, N, trans):
    """The wgmma kernel at the hybrid's and phi-3-vision's projections, r
    16, on inputs at the model's scales, as chip_smoke.py's phase 5 draws
    them (x ~ N(0, 1); W and A ~ N(0, 1/K), the init's; B ~ N(0, 0.05^2)),
    at the tolerances of the test above. The 0.1-scaled inputs of that
    test make x a ~ 0.1^2 sqrt(K) and the rank-16 term as large as x W:
    past K ~ 3000 a bf16 rounding of x a that falls the other way in
    another f32 summation order then moves an output by more than half
    an ulp of the output (measured 2.03e-2 of the RMS at 3072 -> 8192 on
    the H100), which is that test's premise."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(K + N + trans)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(torch.bfloat16)
    x = randn(M, K)
    w = randn(N, K, scale=K ** -0.5).t() if trans else \
        randn(K, N, scale=K ** -0.5)
    a, b = randn(K, 16, scale=K ** -0.5), randn(16, N, scale=0.05)
    assert K2._k2_path(M, N, K, 16, torch.bfloat16) == "wgmma"
    before = _k2_counts()
    got = K2.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    after = _k2_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("LAUNCHES", "LAUNCHES_WGMMA")) for k in after}
    expect = K2.lora_matmul_plain(x, w, a, b, 2.0)
    torch.testing.assert_close(got.float(), expect.float(), atol=3e-2,
                               rtol=3e-2)
    assert _rel(got, K2.lora_matmul_plain(x.float(), w, a, b, 2.0)) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.75, 1 / 3, 0.0])
@pytest.mark.parametrize("trans", [False, True])
def test_k2_wgmma_scale_not_a_power_of_two(scale, trans):
    x, w, a, b = _k2_inputs(200, 4104, 1032, 16, torch.bfloat16, trans,
                            _card(), seed=5)
    before = K2.LAUNCHES_WGMMA
    got = K2.lora_matmul(x, w, a, b, scale)
    torch.cuda.synchronize()
    assert K2.LAUNCHES_WGMMA == before + 1
    expect = K2.lora_matmul_plain(x, w, a, b, scale)
    torch.testing.assert_close(got.float(), expect.float(), atol=3e-2,
                               rtol=3e-2)
    assert _rel(got, K2.lora_matmul_plain(x.float(), w, a, b, scale)) <= 2e-2
    if scale == 0.0:     # x @ W alone, rounded once
        assert _rel(got, (x.float() @ w.float())) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_backward_matches_autograd_of_plain(dtype):
    dev = _card()
    x, w, a, b = _k2_inputs(96, 256, 160, 16, dtype, False, dev, seed=3)
    dy = _k2_inputs(96, 160, 1, 1, dtype, False, dev, seed=4)[0]
    grads = {}
    before = _k2_counts()
    for name, fn in (("kernel", kops.lora_matmul),
                     ("plain", K2.lora_matmul_plain)):
        xs, as_, bs = (t.detach().clone().requires_grad_()
                       for t in (x, a, b))
        y = fn(xs, w, as_, bs, 2.0)
        y.backward(dy)
        grads[name] = (y, xs.grad, as_.grad, bs.grad)
    # the forward and dx both launched the kernel this dtype takes (bf16:
    # wgmma, W read MN-major and then K-major)
    counter = "LAUNCHES_WGMMA" if dtype == torch.bfloat16 else "LAUNCHES_F32"
    assert getattr(K2, counter) - before[counter] == 2
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    for got, expect in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                                   rtol=tol)
        assert _rel(got, expect) <= (5e-2 if dtype == torch.bfloat16
                                     else 2e-4)


# ------------------------------------------------------------------ K3 ----
# B, S, nh, hd, ds, chunk, h0, dtype, the kernel `_k3_path` picks
K3_CASES = [
    (2, 32, 8, 16, 32, 8, False, torch.float32, "f32"),  # test_kernels.py
    (1, 50, 4, 8, 16, 16, False, torch.float32, "f32"),  # ragged tail chunk
    (2, 64, 16, 32, 64, 32, True, torch.float32, "f32"),
    (2, 71, 4, 16, 16, 256, True, torch.float32, "f32"),  # c = S = 71
    (1, 300, 3, 64, 128, 256, True, torch.bfloat16, "tc"),  # 2 chunks
    # hd/ds below the tile; Ct starts 360 bytes into the conv row, which
    # 16-byte copies cannot read: the FMA kernel
    (2, 200, 2, 40, 100, 130, False, torch.bfloat16, "f32"),
    (1, 129, 2, 64, 128, 129, True, torch.float32, "f32"),  # 3 row tiles
    # the tensor-core kernel: one chunk; four chunks; chunks of 64 and 128;
    # B 2 with random h0; below the tile with a ragged 130-row chunk; 3 row
    # tiles, one ragged; 3 heads of 16
    (1, 64, 48, 64, 128, 256, False, torch.bfloat16, "tc"),
    (1, 1024, 48, 64, 128, 256, True, torch.bfloat16, "tc"),
    (2, 300, 8, 64, 128, 64, True, torch.bfloat16, "tc"),
    (1, 300, 8, 64, 128, 128, False, torch.bfloat16, "tc"),
    (2, 512, 48, 64, 128, 256, True, torch.bfloat16, "tc"),
    (2, 200, 4, 32, 64, 130, True, torch.bfloat16, "tc"),
    (1, 129, 2, 64, 128, 129, True, torch.bfloat16, "tc"),
    (2, 50, 3, 16, 32, 16, True, torch.bfloat16, "tc"),
]


def _k3_inputs(B, S, nh, hd, ds, h0, dtype, device, seed=0):
    """As `ssm_prefill` feeds the scan: xs, Bt and Ct are slices of one
    (B, S, nh*hd + 2*ds) buffer (strided views), dt and A f32."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)
    conv = t(B, S, nh * hd + 2 * ds, scale=0.5).to(dtype)
    xs = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bt, Ct = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(t(B, S, nh))
    A = -torch.exp(t(nh, scale=0.3))
    return xs, dt, A, Bt, Ct, (t(B, nh, hd, ds, scale=0.2) if h0 else None)


def _k3_counts():
    return {name: getattr(K3, name) for name in
            ("LAUNCHES", "LAUNCHES_TC", "LAUNCHES_F32")}


def _k3_call(xs, dt, A, Bt, Ct, chunk, h, path):
    """One K3 call on the card, asserting by the counters that it ran the
    kernel `path` names, once."""
    assert K3._k3_path(xs, Bt, Ct) == path
    before = _k3_counts()
    y, hT = K3.ssd_scan(xs, dt, A, Bt, Ct, chunk, h0=h)
    torch.cuda.synchronize()
    after = _k3_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "LAUNCHES": 1, "LAUNCHES_TC": int(path == "tc"),
        "LAUNCHES_F32": int(path == "f32")}
    assert y.dtype == hT.dtype == torch.float32
    return y, hT


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,h0,dtype,path", K3_CASES)
def test_k3_kernel_matches_plain(B, S, nh, hd, ds, chunk, h0, dtype, path):
    xs, dt, A, Bt, Ct, h = _k3_inputs(B, S, nh, hd, ds, h0, dtype, _card())
    assert not xs.is_contiguous()
    y, hT = _k3_call(xs, dt, A, Bt, Ct, chunk, h, path)
    yr, hr = K3.ssd_scan_plain(xs, dt, A, Bt, Ct, chunk, h0=h)
    # test_kernels.py's 2e-3: another order of the same f32 sums (and, on
    # the tensor-core kernel, f32 operands as bf16 hi + lo, ~2^-17)
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(hT, hr, atol=2e-3, rtol=2e-3)


def _f64_witness(xs, dt, A, Bt, Ct, h0=None):
    """The SSD recurrence token by token in float64: no cumsum, no chunks."""
    B, S, nh, hd = xs.shape
    x, d, b, c = xs.double(), dt.double(), Bt.double(), Ct.double()
    a = torch.exp(d * A.double())
    h = torch.zeros((B, nh, hd, Bt.shape[-1]), dtype=torch.float64,
                    device=xs.device) if h0 is None else h0.double()
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + \
            (d[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bs,bhps->bhp", c[:, t], h))
    return torch.stack(ys, dim=1), h


@pytest.mark.gpu
def test_k3_full_width_matches_f64_witness():
    """mamba2-780m's prefill of 512 tokens (nh 48, hd 64, ds 128, c 256),
    bf16 slices of silu outputs and the model's A, on the tensor-core
    kernel, within K3's 2e-3 of the f64 recurrence."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    conv = torch.nn.functional.silu(torch.randn(
        (1, 512, 48 * 64 + 256), generator=g, device=dev)).to(torch.bfloat16)
    xs = conv[..., :3072].reshape(1, 512, 48, 64)
    Bt, Ct = conv[..., 3072:3200], conv[..., 3200:]
    dt = torch.nn.functional.softplus(torch.randn((1, 512, 48), generator=g,
                                                  device=dev))
    A = -torch.linspace(1.0, 16.0, 48, device=dev)
    y, hT = _k3_call(xs, dt, A, Bt, Ct, 256, None, "tc")
    yw, hw = _f64_witness(xs, dt, A, Bt, Ct)
    torch.testing.assert_close(y.double(), yw, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(hT.double(), hw, atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
def test_k3_refuses_a_gradient_on_the_card():
    xs, dt, A, Bt, Ct, _ = _k3_inputs(1, 16, 2, 8, 16, False, torch.float32,
                                      _card())
    with pytest.raises(RuntimeError, match="forward-only"):
        kops.ssd_scan(xs.requires_grad_(), dt, A, Bt, Ct, 8)


@pytest.mark.gpu
def test_ssm_prefill_through_k3_matches_plain():
    dev = _card()
    cfg = smoke_config("mamba2-780m")
    params = MD.init_params(cfg, 0, dtype=torch.float32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    out = {}
    for use_kernels in (False, True):
        cache = MD.init_cache(cfg, 2, 64, device=dev)
        before = _k3_counts()
        logits, cache = MD.prefill(params, cfg, {"tokens": toks}, cache,
                                   use_kernels=use_kernels)
        # f32 weights give f32 conv outputs: every layer on the FMA kernel
        n = cfg.num_layers if use_kernels else 0
        assert {k: v - before[k] for k, v in _k3_counts().items()} == {
            "LAUNCHES": n, "LAUNCHES_TC": 0, "LAUNCHES_F32": n}
        out[use_kernels] = (logits, cache["scan"]["h"])
    torch.testing.assert_close(out[True][0], out[False][0], atol=2e-3,
                               rtol=2e-3)
    torch.testing.assert_close(out[True][1], out[False][1], atol=2e-3,
                               rtol=2e-3)


# ------------------------------------------------------- CUDA graphs ----
ENC_LEN = 6         # the encoder-decoder's stub frames per request


def _graph_cfg(arch):
    """The smoke width, LoRA rank 8 so that the units' adapted projections
    take K2's wgmma kernel (the main path's); the hybrid at 5 layers, so
    that 2 RG-LRU layers follow its superblock in "post"; "<arch> int8"
    with an int8 KV cache (kv_quant)."""
    arch, _, cache = arch.partition(" ")
    cfg = dataclasses.replace(smoke_config(arch), kv_quant=cache == "int8")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=5)
    return dataclasses.replace(cfg, lora=dataclasses.replace(cfg.lora,
                                                             rank=8))


def _staged(cfg, seed=1):
    """The finetune ring of 2 x 32-token microbatches (with the vision
    stub's patches or 16 encoder frames where the model has them)."""
    return Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 32, 2, seed=seed,
        frontend_tokens=TP.front_tokens(cfg),
        enc_frames=16 if cfg.enc_layers else 0, d_model=cfg.d_model)
    ).batches(), 2).stacked()


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def _assert_same(a, b):
    """Two trees of tensors and host ints, bit for bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y)


def _served_cache(cfg, params, dev, lengths=(5, 17, 64, 1)):
    """A 4-slot bf16 cache with each slot prefilled (through the kernels)
    as the engine's admissions fill it, and the next round's inputs. A
    sliding-window or hybrid model (smoke window 64) gets prompts past
    its window, so its rings have wrapped; a vision-stub model's prompts
    follow their patches; an encoder-decoder's come with ENC_LEN
    frames."""
    if cfg.window or cfg.family == "hybrid":
        lengths = (5, 17, 70, 100)
    front = TP.front_tokens(cfg)
    enc_len = ENC_LEN if cfg.enc_layers else 0
    cache = MD.init_cache(cfg, len(lengths), 128, enc_len, device=dev)
    gen = torch.Generator(dev).manual_seed(4)
    last = []
    for b, n in enumerate(lengths):
        one = MD.init_cache(cfg, 1, 128, enc_len, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, n),
                                         device=dev, generator=gen)}
        if front:
            batch["frontend"] = torch.randn((1, front, cfg.d_model),
                                            device=dev, generator=gen)
        if enc_len:
            batch["enc_frames"] = torch.randn((1, enc_len, cfg.d_model),
                                              device=dev, generator=gen)
        logits, one = MD.prefill(params, cfg, batch, one, use_kernels=True)
        for part in ("pre", "post"):
            for dst, src in zip(tree_leaves(cache[part]),
                                tree_leaves(one[part])):
                dst[b] = src[0]
        for dst, src in zip(tree_leaves(cache["scan"]),
                            tree_leaves(one["scan"])):
            dst[:, b] = src[:, 0]
        last.append(logits.argmax(-1).to(torch.int32))
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev) + front
    return cache, torch.cat(last), pos


GRAPH_ARCHS = ["llama3-8b", "mamba2-780m", "mixtral-8x7b", "h2o-danube-1.8b",
               "deepseek-v3-671b", "recurrentgemma-2b", "phi-3-vision-4.2b",
               "seamless-m4t-large-v2", "llama3-8b int8"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_decode_step_equals_eager(arch):
    """The decode step captured as a CUDA graph (kernels on) gives the
    eager step's logits, greedy tokens and cache bit for bit over three
    rounds; capturing leaves the cache as it was; each replay counts its
    K1 launches (one per layer on llama3, none on mamba2 or an int8
    cache) and its int8 oracle decodes; a cache other than the captured
    one is refused."""
    dev = _card()
    cfg = _graph_cfg(arch)
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    saved = _clone(cache)
    graph = DecodeGraph(params, cfg, cache, use_kernels=True)
    torch.cuda.synchronize()
    _assert_same(cache, saved)
    cache_e = _clone(cache)
    n_attn = 0 if cfg.mla else len(cfg.attn_layer_indices())
    per_round = 0 if cfg.kv_quant else n_attn
    for _ in range(3):
        logits_e, _ = MD.decode_step(params, cfg, tok, pos, cache_e,
                                     use_kernels=True)
        before = (K.LAUNCHES, A.INT8_ORACLE_CALLS)
        logits_g = graph(tok, pos, cache)
        torch.cuda.synchronize()
        assert (K.LAUNCHES - before[0], A.INT8_ORACLE_CALLS - before[1]) \
            == (per_round, n_attn - per_round)
        assert torch.equal(logits_g, logits_e)
        assert torch.equal(graph.next_tokens,
                           logits_e.argmax(-1).to(torch.int32))
        _assert_same(cache, cache_e)
        tok, pos = graph.next_tokens.clone(), pos + 1
    with pytest.raises(ValueError, match="another cache"):
        graph(tok, pos, cache_e)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "mixtral-8x7b",
                                  "recurrentgemma-2b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2", "llama3-8b int8"])
def test_graphed_rounds_equal_eager_rounds(arch):
    """Co-located rounds replayed from CUDA graphs (decode, then k unit
    graphs) equal eager rounds (decode_step, then k unit_step calls) bit
    for bit, for k in {0, 1, 3, k_max} over three iterations with their
    OPT units; `precompile` leaves the cache and the finetune state (its
    tensors and its host counters) as they were; a graphed ft-only burst
    equals an eager one; a state other than the captured one is refused."""
    dev = _card()
    cfg = _graph_cfg(arch)
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1,
                       opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    ft = TP.init_ft_state(cfg, pc, params, 0, _staged(cfg))
    k_max = 4
    graphed = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=k_max,
                                use_kernels=True)
    eager = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=k_max,
                              use_kernels=True, graphs=False)
    assert graphed.graphs and not eager.graphs
    cache_e, ft_e = _clone(cache), _clone(ft)
    graphed.precompile(cache, ft)
    torch.cuda.synchronize()
    _assert_same(cache, cache_e)
    _assert_same(ft, ft_e)
    # rounds of 0, 1, 3 and k_max units in turn, the last cut short, so
    # that they run three whole iterations
    upi = TP.units_per_iteration(cfg, pc.accum)
    ks, cycle = [], itertools.cycle([0, 1, 3, k_max])
    while sum(ks) < 3 * upi:
        ks.append(min(next(cycle), 3 * upi - sum(ks)))
    for k in ks:
        lg_g, _, _ = graphed.run_round(k, tok, pos, cache, ft)
        lg_e, _, _ = eager.run_round(k, tok, pos, cache_e, ft_e)
        torch.cuda.synchronize()
        assert torch.equal(lg_g, lg_e)
        _assert_same(cache, cache_e)
        _assert_same(ft, ft_e)
        tok, pos = lg_e.argmax(-1).to(torch.int32), pos + 1
    assert ft["iter"] == 3 and ft["unit_idx"] == 0
    assert np.isfinite(float(ft["last_loss"]))
    with pytest.raises(ValueError, match="another finetune state"):
        graphed.run_round(1, tok, pos, cache, ft_e)
    burst_g = C.make_ft_only_step(cfg, params, pc, units=5)
    burst_e = C.make_ft_only_step(cfg, params, pc, units=5, graphs=False)
    for _ in range(2):
        _assert_same(burst_g(ft), burst_e(ft_e))


@pytest.mark.gpu
def test_replays_count_their_captured_launches():
    """Capture launches nothing and moves no counter; each replay adds its
    captured launches: K1 once per layer in the decode graph (and in the
    whole card's decode graph a split captures for k = 0), K2 7 times
    in a FWD unit's graph and 14 in a BWD unit's (all wgmma), nothing in
    EMBED, HEAD and OPT."""
    dev = _card()
    cfg = _graph_cfg("llama3-8b")
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 32, 2, seed=1)).batches(), pc.n_stage).stacked()
    ft = TP.init_ft_state(cfg, pc, params, 0, staged)
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=8,
                               use_kernels=True)
    k1, k2 = K.LAUNCHES, K2.LAUNCHES_WGMMA
    runner.precompile(cache, ft)
    # the warm-up launches for real: one decode step per decode graph (two
    # on the split: its partition's and the whole card's) and one iteration
    n = cfg.num_layers
    assert runner.split is not None
    assert K.LAUNCHES - k1 == 2 * n and K2.LAUNCHES_WGMMA - k2 == 21 * n
    assert runner._decode.graph.launches == {(K, "LAUNCHES"): n}
    assert runner._solo.graph.launches == {(K, "LAUNCHES"): n}
    unit = runner.unit_step
    for key, graph in runner._units.graphs.items():
        kind = unit.kind(pc.accum * unit.upm if key == "opt" else key)
        per = {"FWD": 7, "BWD": 14}.get(kind, 0)
        assert graph.launches == ({(K2, "LAUNCHES"): per,
                                   (K2, "LAUNCHES_WGMMA"): per}
                                  if per else {})
    before = (K.LAUNCHES, K2.LAUNCHES, K2.LAUNCHES_WGMMA, K2.PLAIN_CALLS)
    runner.run_round(2 * n + 2, tok, pos, cache, ft)  # EMBED .. last BWD
    assert (K.LAUNCHES, K2.LAUNCHES, K2.LAUNCHES_WGMMA, K2.PLAIN_CALLS) == (
        before[0] + n, before[1] + 21 * n, before[2] + 21 * n, before[3])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_engine_tokens_equal_eager_engine(arch):
    """An engine replaying its decode graph (the default on the card) and
    one running eager rounds give the same greedy tokens round by round
    for the same admitted prompts."""
    dev = _card()
    cfg = _graph_cfg(arch)
    params = MD.init_params(cfg, 0, device=dev)
    engines = [ServingEngine(cfg, params, max_slots=4, s_max=128,
                             enc_len=ENC_LEN if cfg.enc_layers else 0,
                             use_kernels=True, device=dev, graphs=g)
               for g in (None, False)]
    assert engines[0].graphs and not engines[1].graphs
    rng = np.random.default_rng(5)
    for i, n in enumerate((9, 40, 3, 70)):
        prompt = rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
        reqs = [Request(rid=i, arrival=0.0, prompt_len=n, max_new_tokens=12)
                for _ in engines]
        extras = engines[0]._stub_extras(reqs[0])   # the same patches/frames
        for eng, req in zip(engines, reqs):
            assert eng.try_admit(req, prompt, extras)
    rounds = 0
    while engines[1].active_requests():
        assert engines[0].decode_round() == engines[1].decode_round()
        rounds += 1
    assert rounds == 11 and not engines[0].active_requests()
    _assert_same(engines[0].cache, engines[1].cache)


# ------------------------------------------ sliding window and MoE ----
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_on_a_wrapped_ring_matches_plain_and_oracle(hd, dtype):
    """Rings of 256 slots (window 256) holding positions up to 700, 300,
    255 and 9 (three wrapped, one not): K1 through the model's adapter
    (one launch) against its plain version on the same pages and lengths
    and against the windowed dense oracle, at tests/test_kernels.py's
    tolerances (bf16 2e-2: the oracle rounds its softmax weights to the
    cache's type and the kernel does not; f32 1e-4)."""
    dev = _card()
    W, B, H, KV = 256, 4, 32, 8
    gen = torch.Generator(dev).manual_seed(hd)
    cache = {"k": torch.randn((B, W, KV, hd), generator=gen, device=dev
                              ).to(dtype),
             "v": torch.randn((B, W, KV, hd), generator=gen, device=dev
                              ).to(dtype),
             "kv_pos": torch.full((B, W), -1, dtype=torch.int32, device=dev)}
    last = torch.tensor([700, 300, 255, 9], dtype=torch.int32, device=dev)
    for b, p in enumerate(last.tolist()):
        pos = torch.arange(max(p - W + 1, 0), p + 1, dtype=torch.int32,
                           device=dev)
        cache["kv_pos"][b, pos % W] = pos
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    before = K.LAUNCHES
    got = kops.decode_attention(q, cache["k"], cache["v"], cache["kv_pos"],
                                last, W)
    torch.cuda.synchronize()
    assert K.LAUNCHES - before == 1
    lengths = torch.clamp(last + 1, max=W)
    table = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    plain = K.paged_decode_attention_plain(q, cache["k"], cache["v"], table,
                                           lengths)
    oracle = A.decode_attn_ref(q, cache["k"], cache["v"], cache["kv_pos"],
                               last, W)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for expect in (plain, oracle):
        torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 1), (1, 300), (2, 1024)])
def test_moe_layer_runs_without_host_synchronisation(B, S):
    """The MoE layer at mixtral's expert count and top-k (narrow widths)
    at a decode-size group (one group of 8 tokens), a prefill's and the
    finetune units' (a group per row, capacity drops possible): with
    `torch.cuda.set_sync_debug_mode("error")` any host synchronisation in
    the routing, the sort-ranked slot plan, the dispatch, the expert
    products or the combine raises; the result is finite, and equal to a
    second call's bit for bit."""
    dev = _card()
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), d_model=256,
                              num_experts=8, top_k=2, moe_d_ff=512)
    p = MOE.moe_init(torch.Generator(dev).manual_seed(0), cfg, 1)
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((B, S, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(1)
                    ).to(torch.bfloat16)
    MOE.moe_forward(p, x, cfg)                     # warm up, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = MOE.moe_forward(p, x, cfg)
        y2, aux2 = MOE.moe_forward(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert y.shape == x.shape and torch.isfinite(y.float()).all()
    assert torch.equal(y, y2)
    assert torch.equal(aux["dropped_frac"], aux2["dropped_frac"])
    if S == 1:
        assert float(aux["dropped_frac"]) == 0.0


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """A tree of card tensors (bf16, f32, int32) and a host int saved
    asynchronously, then written in place on the card before the save's
    write can have begun: the checkpoint holds the values of the moment
    `save` was called, and restores onto the card (and onto the CPU) bit
    for bit."""
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    dev = _card()
    gen = torch.Generator(dev).manual_seed(0)
    tree = {"w": torch.randn((64, 33), device=dev,
                             generator=gen).to(torch.bfloat16),
            "m": torch.randn((5, 7), device=dev, generator=gen),
            "i": torch.arange(12, dtype=torch.int32, device=dev),
            "t": 3}
    before = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                      else t, tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree, blocking=False)
    for name in ("w", "m", "i"):
        tree[name].add_(1)
    mgr.wait()
    out = mgr.restore(tree)
    assert out["t"] == 3 and out["w"].is_cuda
    assert out["w"].dtype == torch.bfloat16
    for name in ("w", "m", "i"):
        assert torch.equal(out[name], before[name])
    cpu = mgr.restore(tree_map(lambda t: t.cpu() if isinstance(
        t, torch.Tensor) else t, tree))
    assert torch.equal(cpu["w"], before["w"].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("units", [False, True])
def test_train_entry_point_runs_k2_on_the_card(units, arch, tmp_path):
    """Two steps of `launch/train.py --use-kernels` at smoke width on the
    card: every adapted projection through K2 (the forward, the remat
    recompute and the backward's dx in one-shot mode, less layer 0's
    q/k/v; 7 per FWD and 14 per BWD unit with --layer-units, replayed from
    CUDA graphs after the capture's warm-up has run one iteration for
    real), no plain call, and a finite loss; the encoder-decoder's
    encoder and cross-attention take no adapter, so no K2 launch."""
    from repro_torch.launch import train
    _card()
    cfg = smoke_config(arch)
    n = cfg.num_layers * len(cfg.lora.targets)
    before = (K2.LAUNCHES, K2.PLAIN_CALLS)
    out = train.main(["--arch", arch, "--smoke", "--device", "cuda",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--use-kernels", "--ckpt-dir", str(tmp_path)]
                     + (["--layer-units"] if units else []))
    torch.cuda.synchronize()
    per_step = 3 * n if units else 3 * n - 3
    assert K2.LAUNCHES - before[0] == (3 if units else 2) * per_step
    assert K2.PLAIN_CALLS == before[1]
    assert out["opt"]["t"] == 2
    assert all(torch.isfinite(t).all() for t in tree_leaves(out["adapters"]))


# -------------------------------------------------- MLA (deepseek-v3) ----
@pytest.mark.gpu
def test_absorbed_mla_decode_matches_the_unabsorbed_form_on_the_card():
    """bf16 on the card: the absorbed latent decode against K/V expanded
    from the same latent cache through W_kv_b (f32), within 2e-2 of the
    output's largest entry, over slots prefilled to 5-64 tokens; an empty
    slot (position -1) gives 0 on both."""
    dev = _card()
    cfg = smoke_config("deepseek-v3-671b")
    gen = torch.Generator(dev).manual_seed(0)
    p = MD.init_params(cfg, 0, device=dev)["pre"][0]["attn"]
    lengths = (5, 17, 64)
    cache = A.make_cache(cfg, 4, 96, device=dev)
    for b, n in enumerate(lengths):
        x = torch.randn((1, n, cfg.d_model), device=dev, generator=gen
                        ).to(torch.bfloat16)
        one = A.make_cache(cfg, 1, 96, device=dev)
        A.mla_prefill(p, x, torch.arange(n, device=dev)[None], cfg,
                      cache=one)
        for name, t in cache.items():
            t[b] = one[name][0]
    x = torch.randn((4, 1, cfg.d_model), device=dev, generator=gen
                    ).to(torch.bfloat16)
    pos = torch.tensor(lengths + (-1,), dtype=torch.int32, device=dev)
    expect = A.mla_decode_expanded(p, x, pos, _clone(cache), cfg)
    got, _ = A.mla_decode(p, x, pos, cache, cfg)
    torch.cuda.synchronize()
    scale = expect.float().abs().max()
    assert (got.float() - expect.float()).abs().max() <= 2e-2 * scale
    assert not got[3].any() and not expect[3].any()


@pytest.mark.gpu
def test_deepseek_graphed_rounds_equal_eager_rounds():
    """Co-located rounds on deepseek-v3's smoke config replayed from CUDA
    graphs equal eager rounds bit for bit over three iterations (EMBED and
    EMBED_BWD carry the "pre" layer's adapters, EMBED_BWD has a graph);
    each unit graph's K2 launches are those its kind makes on the plan's
    layers, all wgmma: EMBED 5, FWD 5, BWD 10, EMBED_BWD 9 (forward and
    dx; the pre layer's q needs no dx);
    the decode graph launches no K1."""
    dev = _card()
    cfg = _graph_cfg("deepseek-v3-671b")
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1,
                       opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 32, 2, seed=1)).batches(), pc.n_stage).stacked()
    ft = TP.init_ft_state(cfg, pc, params, 0, staged)
    graphed = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                                use_kernels=True)
    eager = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                              use_kernels=True, graphs=False)
    cache_e, ft_e = _clone(cache), _clone(ft)
    graphed.precompile(cache, ft)
    torch.cuda.synchronize()
    _assert_same(cache, cache_e)
    _assert_same(ft, ft_e)
    assert graphed._decode.graph.launches == {}
    unit = graphed.unit_step
    per = {"EMBED": 5, "FWD": 5, "BWD": 10, "EMBED_BWD": 9}
    kinds = set()
    for key, graph in graphed._units.graphs.items():
        kind = unit.kind(pc.accum * unit.upm if key == "opt" else key)
        kinds.add(kind)
        n = per.get(kind, 0)
        assert graph.launches == ({(K2, "LAUNCHES"): n,
                                   (K2, "LAUNCHES_WGMMA"): n} if n else {})
    assert "EMBED_BWD" in kinds
    ks = [0, 1, 5, 6] * 3
    assert sum(ks) == 3 * TP.units_per_iteration(cfg, pc.accum)
    for k in ks:
        lg_g, _, _ = graphed.run_round(k, tok, pos, cache, ft)
        lg_e, _, _ = eager.run_round(k, tok, pos, cache_e, ft_e)
        torch.cuda.synchronize()
        assert torch.equal(lg_g, lg_e)
        _assert_same(cache, cache_e)
        _assert_same(ft, ft_e)
        tok, pos = lg_e.argmax(-1).to(torch.int32), pos + 1
    assert ft["iter"] == 3 and np.isfinite(float(ft["last_loss"]))
    assert any(t.any() for t in tree_leaves(ft["adapters"]["pre"][0]["q"]))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(8, 1), (2, 512)])
def test_deepseek_routing_runs_without_host_synchronisation(B, S):
    """The MoE layer with deepseek-v3's routing (256 experts, top-8,
    sigmoid, one shared expert; narrow widths) at a decode-size group and
    a training micro-batch, with host synchronisation forbidden: finite,
    equal to a second call bit for bit, and no drop at decode (C = 8)."""
    dev = _card()
    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"), d_model=128,
                              num_experts=256, top_k=8, moe_d_ff=64)
    p = MOE.moe_init(torch.Generator(dev).manual_seed(0), cfg, 1)
    p = tree_map(lambda t: t[0], p)
    x = torch.randn((B, S, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(1)
                    ).to(torch.bfloat16)
    MOE.moe_forward(p, x, cfg, router_type="sigmoid")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = MOE.moe_forward(p, x, cfg, router_type="sigmoid")
        y2, _ = MOE.moe_forward(p, x, cfg, router_type="sigmoid")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.equal(y, y2)
    if S == 1:
        assert float(aux["dropped_frac"]) == 0.0


@pytest.mark.gpu
def test_deepseek_routing_backward_is_bit_reproducible():
    """The MoE layer's backward at top-8 of 256 (2 x 512 tokens, bf16)
    twice on the same inputs: the input's and the router's gradients bit
    for bit (the dispatch's backward gathers a token's slot gradients in
    a fixed order; a scatter-add's atomics would add its 8 in any
    order)."""
    dev = _card()
    cfg = dataclasses.replace(smoke_config("deepseek-v3-671b"), d_model=128,
                              num_experts=256, top_k=8, moe_d_ff=64)
    p = tree_map(lambda t: t[0], MOE.moe_init(
        torch.Generator(dev).manual_seed(0), cfg, 1))
    x0 = torch.randn((2, 512, cfg.d_model), device=dev,
                     generator=torch.Generator(dev).manual_seed(1)
                     ).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        x = x0.clone().requires_grad_()
        router = p["router"].clone().requires_grad_()
        y, aux = MOE.moe_forward(dict(p, router=router), x, cfg,
                                 router_type="sigmoid")
        ((y.float() ** 2).sum() + aux["lb_loss"]).backward()
        grads.append((x.grad, router.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert grads[0][0].abs().amax() > 0


# ------------------------------------ the hybrid and the vision stub ----
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_on_a_wrapped_mqa_ring_at_hd_256(dtype):
    """recurrentgemma-2b's local attention: one KV head for 10 query heads
    of hd 256 (g x hd = 2560), rings of 512 slots (window 512) holding
    positions up to 1500, 600, 511 and 40: K1 through the model's adapter
    against its plain version and the windowed dense oracle, at the
    tolerances of the test above."""
    dev = _card()
    W, B, H, KV, hd = 512, 4, 10, 1, 256
    gen = torch.Generator(dev).manual_seed(256)
    cache = {"k": torch.randn((B, W, KV, hd), generator=gen, device=dev
                              ).to(dtype),
             "v": torch.randn((B, W, KV, hd), generator=gen, device=dev
                              ).to(dtype),
             "kv_pos": torch.full((B, W), -1, dtype=torch.int32, device=dev)}
    last = torch.tensor([1500, 600, 511, 40], dtype=torch.int32, device=dev)
    for b, p in enumerate(last.tolist()):
        pos = torch.arange(max(p - W + 1, 0), p + 1, dtype=torch.int32,
                           device=dev)
        cache["kv_pos"][b, pos % W] = pos
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    before = K.LAUNCHES
    got = kops.decode_attention(q, cache["k"], cache["v"], cache["kv_pos"],
                                last, W)
    torch.cuda.synchronize()
    assert K.LAUNCHES - before == 1
    n = W // 64
    table = torch.arange(B * n, dtype=torch.int32, device=dev).reshape(B, n)
    plain = K.paged_decode_attention_plain(
        q, cache["k"].reshape(B * n, 64, KV, hd),
        cache["v"].reshape(B * n, 64, KV, hd), table,
        torch.clamp(last + 1, max=W))
    oracle = A.decode_attn_ref(q, cache["k"], cache["v"], cache["kv_pos"],
                               last, W)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for expect in (plain, oracle):
        torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.gpu
def test_hybrid_unit_graphs_count_k2_by_kind():
    """The hybrid at 5 layers (one "rra" superblock, 2 RG-LRU layers in
    "post"), LoRA r 8 on gate/up/down and q/k/v/o: a FWD unit's graph
    launches K2 13 times (6 for the two RG-LRU layers' MLPs, 7 for the
    attention layer), a BWD unit's 26, HEAD's 12 (the post layers'
    gate/up/down forward and dx), all on the wgmma kernel; the parallel
    `rg_io` adapter takes none."""
    dev = _card()
    cfg = _graph_cfg("recurrentgemma-2b")
    params = MD.init_params(cfg, 0, device=dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    ft = TP.init_ft_state(cfg, pc, params, 0, _staged(cfg))
    unit = TP.make_unit_step(cfg, pc, params, use_kernels=True)
    units = C.GraphedUnits(unit, ft)
    expect = {"FWD": 13, "BWD": 26, "HEAD": 12}
    for key, graph in units.graphs.items():
        kind = unit.kind(pc.accum * unit.upm if key == "opt" else key)
        per = expect.get(kind, 0)
        assert graph.launches == ({(K2, "LAUNCHES"): per,
                                   (K2, "LAUNCHES_WGMMA"): per}
                                  if per else {})
    before = K2.LAUNCHES_WGMMA
    units.run(ft, TP.units_per_iteration(cfg, 1))
    torch.cuda.synchronize()
    assert K2.LAUNCHES_WGMMA - before == 13 + 26 + 12
    assert ft["iter"] == 1 and np.isfinite(float(ft["last_loss"]))


# ------------------------------- the recompute-backward flash attention --
def _flash_grads(fn, q, k, v, do, scale):
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(qq, kk, vv, causal=True, scale=scale)
    o.backward(do)
    return o.detach(), qq.grad, kk.grad, vv.grad


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1024, 32, 8, 128, 128),
                                   (2, 1024, 128, 128, 192, 128)],
                         ids=["llama3_8b", "deepseek_v3_dense_mla"])
def test_flash_function_matches_plain_autograd_and_holds_less(shape):
    """The Function's output and (dq, dk, dv) against autograd through the
    same forward (`flash_attention_plain`) at llama3-8b's and deepseek-v3's
    dense MLA training shapes in bf16, at 3e-2 of each tensor's largest
    |value|; and the memory a forward + backward allocates above its
    inputs: the Function's below the plain version's, which keeps every
    block's f32 scores."""
    from repro_torch.models import layers as L
    dev = _card()
    B, S, H, KV, hd, vd = shape
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    args = (rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, vd),
            rnd(B, S, H, vd), hd ** -0.5)
    got = _flash_grads(L.flash_attention, *args)
    ref = _flash_grads(L.flash_attention_plain, *args)
    for a, b in zip(got, ref):
        assert (a.float() - b.float()).abs().max() <= \
            3e-2 * b.float().abs().max()
    del got, ref
    peak = {}
    for name, fn in (("function", L.flash_attention),
                     ("plain", L.flash_attention_plain)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _flash_grads(fn, *args)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base
    assert peak["function"] < peak["plain"], peak


@pytest.mark.gpu
def test_checkpoint_restores_onto_a_cuda_mesh_bit_equal(tmp_path):
    """A checkpoint of card tensors restored onto a 1x1 ("data", "model")
    mesh on cuda (NCCL, world size 1) by `param_specs` equals the
    single-card restore leaf by leaf, bit for bit; `reshard` of the live
    tree too."""
    import socket

    import torch.distributed as dist

    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed.fault_tolerance import (CheckpointManager,
                                                         reshard)
    from repro_torch.launch.mesh import make_debug_mesh
    dev = _card()
    cfg = smoke_config("qwen3-8b")
    params = MD.init_params(cfg, 0, device=dev)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, params)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        specs = PT.param_specs(cfg, params, mesh)
        single = mgr.restore(params)
        for tree in (mgr.restore(params, mesh=mesh, specs=specs),
                     reshard(params, mesh, specs)):
            for a, b in zip(tree_leaves(single), tree_leaves(tree)):
                assert b.device_mesh == mesh and b.is_cuda
                assert torch.equal(a, b.full_tensor())
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the SM split --
def _split():
    from repro_torch.core import partition as SP
    _card()
    return SP, SP.split_for("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b"])
def test_overlapped_rounds_equal_sequential_rounds(arch):
    """Rounds with decode and its units at once on the split (the
    default on the card) equal sequential rounds bit for bit, graphed and
    eager, over two whole iterations of units (every kind, host staging
    and OPT's pinned copy included), k in {0, 1, 3, 6}; the overlapped
    runner's unit graphs keep K2's launches by kind."""
    dev = _card()
    cfg = _graph_cfg(arch)
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1,
                       opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    ft = TP.init_ft_state(cfg, pc, params, 0, _staged(cfg))
    runs = {}
    for name, graphs, split in (("graphed split", None, None),
                                ("graphed sequential", None, False),
                                ("eager split", False, None),
                                ("eager sequential", False, False)):
        runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                                   use_kernels=True, graphs=graphs,
                                   split=split)
        assert (runner.split is not None) == (split is None)
        assert runner.graphs == (graphs is None)
        c, f = _clone(cache), _clone(ft)
        runner.precompile(c, f)
        runs[name] = (runner, c, f)
    upi = TP.units_per_iteration(cfg, pc.accum)
    ks, cycle = [], itertools.cycle([0, 1, 3, 6])
    while sum(ks) < 2 * upi:
        ks.append(min(next(cycle), 2 * upi - sum(ks)))
    kinds = set()
    unit = runs["graphed split"][0].unit_step
    for k in ks:
        f0 = runs["graphed split"][2]
        kinds.update(unit.kind((f0["unit_idx"] + j) % upi) for j in range(k))
        logits = {name: r.run_round(k, tok, pos, c, f)[0].clone()
                  for name, (r, c, f) in runs.items()}
        torch.cuda.synchronize()
        ref = runs["graphed sequential"]
        for name, (r, c, f) in runs.items():
            assert torch.equal(logits[name], logits["graphed sequential"]), \
                (name, k)
            _assert_same(c, ref[1])
            _assert_same(f, ref[2])
        tok, pos = logits["graphed sequential"].argmax(-1).to(
            torch.int32), pos + 1
    assert kinds >= {"EMBED", "FWD", "HEAD", "BWD", "OPT"}
    assert runs["graphed split"][2]["iter"] == 2
    assert np.isfinite(float(runs["graphed split"][2]["last_loss"]))


@pytest.mark.gpu
def test_probe_partitions_are_disjoint_and_confined():
    """The probe launched eagerly on each partition's stream runs on as
    many SMs as the partition has, and the two sets are disjoint; a graph
    captured on a partition's stream keeps to that partition's SMs,
    whatever stream it is replayed on."""
    from repro_torch.core import graphs as G
    SP, sp = _split()
    ctas = 3 * torch.cuda.get_device_properties(0).multi_processor_count
    sets = {}
    for name, part in (("decode", sp.decode), ("units", sp.units)):
        sets[name] = set(SP.smids(part.stream, ctas))
        assert len(sets[name]) == part.sms
    assert not sets["decode"] & sets["units"]
    sms, _ = SP.device_sms(torch.cuda.current_device())
    assert sp.decode.sms + sp.units.sms == sms
    for name, part in (("decode", sp.decode), ("units", sp.units)):
        out = torch.full((ctas,), -1, dtype=torch.int32, device="cuda")
        G.on_side_stream(lambda: SP.smid_probe(out), part.stream)
        graph = G.capture(lambda: SP.smid_probe(out),
                          torch.cuda.graph_pool_handle(), part.stream)
        for stream in (sp.decode.stream, sp.units.stream,
                       torch.cuda.current_stream()):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                out.fill_(-1)
                graph.replay()
            torch.cuda.current_stream().wait_stream(stream)
            assert set(out.tolist()) <= sets[name]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,trans", [
    (2048, 4096, 14336, False),          # llama3 gate/up: 896 wide tiles
    (2048, 4096, 14336, True),
    (2048, 7168, 2048, False),           # 128 wide tiles
    (200, 4104, 1032, True),             # ragged edges
    (64, 256, 160, False)])
def test_k2_on_a_partition_matches_plain(M, K, N, trans):
    """K2 on the unit partition's stream, its grid of one CTA per SM of the
    card confined to the partition's SMs, against its plain version at
    test_kernels.py's bf16 tolerance, and bit-equal to the launch on the
    whole card."""
    SP, sp = _split()
    x, w, a, b = _k2_inputs(M, K, N, 16, torch.bfloat16, trans, "cuda")
    expect = K2.lora_matmul_plain(x, w, a, b, 2.0)
    whole = K2.lora_matmul(x, w, a, b, 2.0)
    part = sp.units
    part.stream.wait_stream(torch.cuda.current_stream())
    before = K2.LAUNCHES_WGMMA
    with torch.cuda.stream(part.stream):
        got = K2.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.current_stream().wait_stream(part.stream)
    torch.cuda.synchronize()
    assert K2.LAUNCHES_WGMMA - before == 1
    torch.testing.assert_close(got.float(), expect.float(), atol=3e-2,
                               rtol=3e-2)
    assert torch.equal(got, whole)


@pytest.mark.gpu
def test_decode_and_unit_graphs_hold_different_pools():
    """The decode graph and the unit graphs of a runner take separate
    pools, split or not; on a split the unit graphs were captured for the
    unit partition, and the whole card's decode graph (k = 0) has a third
    pool."""
    dev = _card()
    cfg = _graph_cfg("llama3-8b")
    params = MD.init_params(cfg, 0, device=dev)
    cache, _, _ = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    ft = TP.init_ft_state(cfg, pc, params, 0, _staged(cfg))
    for split in (None, False):
        runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=4,
                                   use_kernels=True, split=split)
        runner.precompile(cache, ft)
        assert runner._decode.pool != runner._units.pool
        assert runner._units.part is (None if split is False
                                      else runner.split.units)
        if split is False:
            assert runner._solo is None
        else:
            assert len({runner._decode.pool, runner._units.pool,
                        runner._solo.pool}) == 3


@pytest.mark.gpu
def test_a_split_the_driver_refuses_raises():
    """A split that leaves the units no SM is refused by the driver, and
    the refusal raises."""
    SP, _ = _split()
    sms, granule = SP.device_sms(torch.cuda.current_device())
    assert granule >= 1 and sms >= 2 * granule
    with pytest.raises(RuntimeError, match="splitting off"):
        SP.Split("cuda", sms)



@pytest.mark.gpu
def test_split_rounds_device_marks_and_captures(monkeypatch):
    """Recording, a graphed split round at k = 2 marks both sides on the
    device: each side's ms > 0 and under the round's host time, a mark per
    unit of the unit step's kinds. Not recording, the round makes the
    parent's events only (the fork and the two joins) and no mark. The
    capture counter moves by the graphs `precompile` captures, and not in
    the rounds."""
    from repro_torch import spans
    from repro_torch.core import graphs as G
    dev = _card()
    _split()
    cfg = _graph_cfg("llama3-8b")
    params = MD.init_params(cfg, 0, device=dev)
    cache, tok, pos = _served_cache(cfg, params, dev)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    ft = TP.init_ft_state(cfg, pc, params, 0, _staged(cfg))
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                               use_kernels=True)
    assert runner.split is not None and runner.graphs
    captures = G.CAPTURES
    runner.precompile(cache, ft)
    captured = G.CAPTURES - captures
    assert captured == 2 + len(runner._units.graphs)
    made = []

    class Counted(torch.cuda.Event):
        def __new__(cls, *a, **kw):
            made.append(cls)
            return super().__new__(cls, *a, **kw)
    for name in ("torch.cuda.Event", "torch.cuda.streams.Event"):
        monkeypatch.setattr(name, Counted)
    try:
        spans.disable()
        runner.run_round(2, tok, pos, cache, ft)
        torch.cuda.synchronize()
        assert len(made) == 3 and spans.marks() == []
        spans.enable()
        idx = ft["unit_idx"]
        t0 = time.perf_counter()
        logits, _, ft = runner.run_round(2, tok, pos, cache, ft)
        logits.argmax(-1).cpu()
        host_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        spans.disable()
    (marks,) = spans.marks()
    replays = [s for s in spans.records() if s.name == "graph.replay"]
    assert len(replays) == 1 + sum(runner.unit_step.has_work(idx + j)
                                   for j in range(2))
    decode_ms, units_ms, per = marks.read()
    assert 0 < decode_ms < host_ms and 0 < units_ms < host_ms
    assert [k for k, _ in per] == [runner.unit_step.kind(idx + j)
                                   for j in range(2)]
    assert all(ms > 0 for _, ms in per)
    assert G.CAPTURES - captures == captured


@pytest.mark.gpu
def test_spans_sit_on_the_cuda_profilers_clock():
    """With CUDA activities, a program span around a `record_function`
    region that launches a kernel and waits for it holds the region's
    kineto event and the kernel, with 1 ms of slack on each side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import spans
    dev = _card()
    x = torch.randn(2048, 2048, device=dev)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with spans.top("outer"):
                time.sleep(0.002)
                with record_function("inner_region"):
                    (x @ x).sum().item()
                time.sleep(0.002)
    finally:
        spans.disable()
    outer = next(s for s in spans.records() if s.name == "outer")
    events = prof.profiler.kineto_results.events()
    inner = next(e for e in events if e.name() == "inner_region"
                 and e.device_type() == DeviceType.CPU)
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.name().startswith("inner_region")]
    assert kernels
    slack = 1_000_000
    for e in [inner] + kernels:
        assert outer.t0 - slack <= e.start_ns() <= e.end_ns() <= \
            outer.t1 + slack, e.name()
