"""Card-only tests of the port: the CUDA paged decode kernel (K1) and the
LoRA matmul kernel (K2: forward, the transposed-W dx form, and the autograd
Function's backward) against their plain torch versions, and a decode step
through K1 against the dense oracle. Each skips with a reason where no CUDA device is present. This file
imports no JAX (the machine with the card has none), so run it there with
  PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402

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


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,r,dtype,trans", K2_CASES)
def test_k2_kernel_matches_plain(M, K, N, r, dtype, trans):
    x, w, a, b = _k2_inputs(M, K, N, r, dtype, trans, _card())
    expect = K2.lora_matmul_plain(x, w, a, b, 2.0)
    before = K2.LAUNCHES
    got = K2.lora_matmul(x, w, a, b, 2.0)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    # test_kernels.py's tolerances: bf16 rounds the output once, f32 sums
    # in another order
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), expect.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:          # against the unrounded plain output
        assert _rel(got, K2.lora_matmul_plain(x.float(), w, a, b, 2.0)) \
            <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_backward_matches_autograd_of_plain(dtype):
    dev = _card()
    x, w, a, b = _k2_inputs(96, 256, 160, 16, dtype, False, dev, seed=3)
    dy = _k2_inputs(96, 160, 1, 1, dtype, False, dev, seed=4)[0]
    grads = {}
    for name, fn in (("kernel", kops.lora_matmul),
                     ("plain", K2.lora_matmul_plain)):
        xs, as_, bs = (t.detach().clone().requires_grad_()
                       for t in (x, a, b))
        y = fn(xs, w, as_, bs, 2.0)
        y.backward(dy)
        grads[name] = (y, xs.grad, as_.grad, bs.grad)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-4
    for got, expect in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(got.float(), expect.float(), atol=tol,
                                   rtol=tol)
        assert _rel(got, expect) <= (5e-2 if dtype == torch.bfloat16
                                     else 2e-4)
