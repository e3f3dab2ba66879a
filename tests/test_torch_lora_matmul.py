"""PyTorch port vs JAX reference: the LoRA matmul (K2) wrapper, its plain
version and its autograd Function, on the CPU (where the wrapper takes the
plain version). Inputs are made from numpy seeds and handed to both sides;
the JAX side is the Pallas kernel in interpret mode and `ref.py`'s oracle,
as `tests/test_kernels.py` runs them."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import lora_matmul_ref  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# test_kernels.py's tolerances: f32 sums in another order; bf16 rounds the
# output (and xa) once
TOL = {jnp.float32: 2e-4, jnp.bfloat16: 3e-2}


def _inputs(shape_x, K, N, r, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return jnp.asarray((rng.normal(size=shape) * 0.1).astype(np.float32)
                           ).astype(dtype)
    return arr(*shape_x), arr(K, N), arr(K, r), arr(r, N)


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


@pytest.mark.parametrize("M,K,N,r,dtype", [
    (64, 128, 96, 8, jnp.float32),
    (128, 512, 256, 16, jnp.float32),
    (37, 200, 130, 4, jnp.float32),          # ragged: the kernel predicates
    (128, 256, 128, 16, jnp.bfloat16),
])
def test_lora_matmul_matches_reference(M, K, N, r, dtype):
    x, w, a, b = _inputs((M, K), K, N, r, dtype)
    expect_kernel = jops.lora_matmul(x, w, a, b, 2.0)   # Pallas, interpret
    expect_ref = lora_matmul_ref(x, w, a, b, 2.0)
    before = K2.PLAIN_CALLS, K2.LAUNCHES
    got = tops.lora_matmul(*to_torch((x, w, a, b)), 2.0)
    assert (K2.PLAIN_CALLS, K2.LAUNCHES) == (before[0] + 1, before[1])
    assert got.shape == (M, N) and got.dtype == to_torch(x).dtype
    tol = TOL[dtype]
    for expect in (expect_kernel, expect_ref):
        np.testing.assert_allclose(_f32(got), np.asarray(expect, np.float32),
                                   atol=tol, rtol=tol)


def test_lora_matmul_batched_input():
    x, w, a, b = _inputs((2, 5, 64), 64, 48, 4, jnp.float32, seed=1)
    expect = lora_matmul_ref(x.reshape(10, 64), w, a, b, 1.5
                             ).reshape(2, 5, 48)
    np.testing.assert_allclose(np.asarray(jops.lora_matmul(x, w, a, b, 1.5)),
                               expect, atol=2e-4, rtol=2e-4)
    got = tops.lora_matmul(*to_torch((x, w, a, b)), 1.5)
    assert got.shape == (2, 5, 48)
    np.testing.assert_allclose(_f32(got), expect, atol=2e-4, rtol=2e-4)


def test_plain_version_rounds_xa_to_b_dtype():
    """bf16: xa is rounded to B's dtype before xa @ B, and the sum is
    rounded once, as the Pallas kernel does (`lora_matmul.py:46-48`)."""
    x, w, a, b = to_torch(_inputs((16, 32), 32, 24, 4, jnp.bfloat16, seed=2))
    f = torch.float32
    xa = (x.to(f) @ a.to(f)).to(torch.bfloat16).to(f)
    expect = (x.to(f) @ w.to(f) + 2.0 * (xa @ b.to(f))).to(torch.bfloat16)
    got = K2.lora_matmul_plain(x, w, a, b, 2.0)
    assert torch.equal(got, expect)


def test_function_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 12, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(12, 9, dtype=torch.float64, generator=g)
    a = torch.randn(12, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    b = torch.randn(3, 9, dtype=torch.float64, generator=g,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, a, b: tops.lora_matmul(x, w, a, b, 1.5), (x, a, b))
    # and with W given as the transpose of a contiguous buffer (the dx form)
    wt = torch.randn(9, 12, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(
        lambda x, a, b: tops.lora_matmul(x, wt.t(), a, b, 0.5), (x, a, b))


def test_function_grads_match_jax_grad_of_reference():
    x, w, a, b = _inputs((24, 40), 40, 32, 8, jnp.float32, seed=3)
    dy = _inputs((24, 32), 1, 1, 1, jnp.float32, seed=4)[0]

    def loss(x, a, b):
        return jnp.sum(lora_matmul_ref(x, w, a, b, 2.0) * dy)
    gx, ga, gb = jax.grad(loss, argnums=(0, 1, 2))(x, a, b)

    xt, at, bt = (t.requires_grad_() for t in to_torch((x, a, b)))
    y = tops.lora_matmul(xt, to_torch(w), at, bt, 2.0)
    y.backward(to_torch(dy))
    for got, expect in ((xt.grad, gx), (at.grad, ga), (bt.grad, gb)):
        np.testing.assert_allclose(_f32(got), np.asarray(expect),
                                   atol=1e-5, rtol=1e-4)


def test_function_backward_launch_count_and_frozen_w():
    """The backward's dx is one more wrapper call; W gets no gradient."""
    x, w, a, b = to_torch(_inputs((8, 16), 16, 12, 4, jnp.float32, seed=5))
    x.requires_grad_()
    a.requires_grad_()
    before = K2.PLAIN_CALLS
    tops.lora_matmul(x, w, a, b, 1.0).sum().backward()
    assert K2.PLAIN_CALLS == before + 2
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="frozen"):
        tops.lora_matmul(x, w, a, b, 1.0).sum().backward()


def test_wrapper_checks_and_devices():
    x, w, a, b = to_torch(_inputs((8, 16), 16, 12, 4, jnp.float32, seed=6))
    with pytest.raises(ValueError, match="shape mismatch"):
        K2.lora_matmul(x, w, a.t(), b, 1.0)
    with pytest.raises(TypeError, match="one dtype"):
        K2.lora_matmul(x, w.double(), a, b, 1.0)
    meta = [t.to("meta") for t in (x, w, a, b)]
    with pytest.raises(ValueError, match="unsupported device"):
        K2.lora_matmul(*meta, 1.0)


# The kernel each CUDA call takes, decided on the host from the shape alone
# (M, N, K, r, dtype -> kernel). The training path's bf16 shapes at
# llama3-8b (M = 2 x 1024 tokens) all take the wgmma kernel, which picks its
# tile width itself (128 x 256, or 128 x 128 at N = 1024).
@pytest.mark.parametrize("M,N,K,r,dtype,path", [
    (2048, 14336, 4096, 16, torch.bfloat16, "wgmma"),   # gate/up
    (2048, 1024, 4096, 16, torch.bfloat16, "wgmma"),    # k/v
    (2048, 4096, 4096, 16, torch.bfloat16, "wgmma"),    # q/o
    (2048, 4096, 14336, 16, torch.bfloat16, "wgmma"),   # down, dx gate
    (2048, 14336, 4096, 16, torch.bfloat16, "wgmma"),   # dx of down
    (2048, 4096, 1024, 16, torch.bfloat16, "wgmma"),    # dx of k/v
    (1, 8, 8, 8, torch.bfloat16, "wgmma"),              # one short row
    (200, 1032, 4104, 8, torch.bfloat16, "wgmma"),      # tile edges
    (300, 200, 1024, 40, torch.bfloat16, "wgmma"),      # r 40 -> 64
    (37, 130, 200, 4, torch.bfloat16, "wmma"),          # 8-byte rows
    (64, 128, 100, 16, torch.bfloat16, "wmma"),         # K % 8
    (64, 100, 128, 16, torch.bfloat16, "wmma"),         # N % 8
    (64, 128, 128, 12, torch.bfloat16, "wmma"),         # r % 8
    (2048, 14336, 4096, 16, torch.float32, "f32"),
])
def test_kernel_dispatch_by_shape(M, N, K, r, dtype, path):
    assert K2._k2_path(M, N, K, r, dtype) == path
    assert path in K2._KERNELS


def test_cpu_calls_count_no_kernel_launch():
    x, w, a, b = to_torch(_inputs((8, 16), 16, 24, 8, jnp.bfloat16, seed=7))
    counts = (K2.LAUNCHES, K2.LAUNCHES_WGMMA, K2.LAUNCHES_WMMA,
              K2.LAUNCHES_F32, K2.PLAIN_CALLS)
    K2.lora_matmul(x, w, a, b, 2.0)
    assert (K2.LAUNCHES, K2.LAUNCHES_WGMMA, K2.LAUNCHES_WMMA,
            K2.LAUNCHES_F32, K2.PLAIN_CALLS) == counts[:4] + (counts[4] + 1,)
