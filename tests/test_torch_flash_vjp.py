"""The port's recompute-backward flash attention against the reference's
custom VJP (`repro/models/layers.py::flash_attention` under `jax.vjp`):
output and (dq, dk, dv) on the same numpy inputs, f32 at 2e-4 and bf16 at
2e-2; what the autograd Function saves (no (q-chunk, kv-chunk) block,
where `flash_attention_plain` keeps one); and the no-grad path, which
saves nothing and equals the Function's forward bit for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

F32_TOL = 2e-4
BF16_TOL = 2e-2

# name -> (B, Sq, Sk, H, hd, vd, keyword arguments, q_offset); the
# tests take KV = H // g
CASES = {
    "causal": (2, 9, 9, 4, 16, 16, {}, None),
    "window": (2, 13, 13, 4, 16, 16, dict(window=4, q_chunk=4, kv_chunk=4),
               None),
    "soft_cap": (2, 9, 9, 4, 16, 16, dict(causal=False, soft_cap=2.0), None),
    "mla_vd": (2, 9, 9, 4, 24, 16, dict(scale=24 ** -0.5), None),
    "cross": (2, 5, 11, 4, 16, 16, dict(causal=False, kv_chunk=4), None),
    "q_offset": (2, 4, 9, 4, 16, 16, {}, [3, 5]),
    "ragged": (2, 11, 19, 4, 16, 16, dict(q_chunk=4, kv_chunk=8), None),
    "masked_rows": (2, 4, 9, 4, 16, 16, dict(q_chunk=4, kv_chunk=8),
                    [-2, 1]),
}


def _inputs(case, g, dtype, seed):
    B, Sq, Sk, H, hd, vd, kw, off = CASES[case]
    KV = H // g
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                         (B, Sk, KV, vd), (B, Sq, H, vd))]
    js = [jnp.asarray(a).astype(dtype) for a in arrs]
    ts = [to_torch(np.asarray(j)) for j in js]
    offset = None if off is None else np.asarray(off, np.int32)
    return js, ts, kw, offset


def _reference(js, kw, offset):
    q, k, v, do = js
    extra = {} if offset is None else dict(q_offset=jnp.asarray(offset))

    def f(q, k, v):
        return JL.flash_attention(q, k, v, **kw, **extra)
    out, vjp = jax.vjp(f, q, k, v)
    return (out,) + vjp(do)


def _port(ts, kw, offset, fn=TL.flash_attention):
    q, k, v, do = (t.clone() for t in ts)
    for t in (q, k, v):
        t.requires_grad_()
    extra = {} if offset is None else dict(q_offset=torch.from_numpy(offset))
    out = fn(q, k, v, **kw, **extra)
    out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(t_out), np.float32),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL),
                                       (jnp.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_value_and_grads_match_reference_vjp(case, dtype, tol, g):
    js, ts, kw, offset = _inputs(case, g, dtype, seed=7)
    expect = _reference(js, kw, offset)
    got = _port(ts, kw, offset)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, expect):
        assert a.dtype == ts[0].dtype, name
        _close(a, b, tol)


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_plain_autograd(case):
    """The recompute backward against autograd through the same forward
    (f32): the two differ only in the order of their sums."""
    _, ts, kw, offset = _inputs(case, 4, jnp.float32, seed=8)
    got = _port(ts, kw, offset)
    plain = _port(ts, kw, offset, fn=TL.flash_attention_plain)
    assert torch.equal(got[0], plain[0])
    for a, b in zip(got[1:], plain[1:]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_fully_masked_rows_give_zero_and_zero_grads():
    """Rows at q_pos < 0 see no key: their output and their dq are 0, and
    they add nothing to dk and dv (the same keys' grads with those rows'
    do set to anything)."""
    _, ts, kw, offset = _inputs("masked_rows", 4, jnp.float32, seed=9)
    out, dq, dk, dv = _port(ts, kw, offset)
    assert torch.all(out[0, :2] == 0) and torch.all(dq[0, :2] == 0)
    assert all(torch.isfinite(t).all() for t in (out, dq, dk, dv))
    ts2 = list(ts)
    ts2[3] = ts[3].clone()
    ts2[3][0, :2] = 1e3
    _, _, dk2, dv2 = _port(ts2, kw, offset)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def _saved_shapes(fn, ts, kw):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    q, k, v, _ = (t.clone().requires_grad_() for t in ts)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(q, k, v, **kw)
    return shapes


def test_function_saves_no_block():
    """What the Function keeps for its backward: q, k, v, q_offset, o and
    the f32 lse (B, KV, g, Sq), nothing of (q-chunk, kv-chunk); the plain
    version keeps blocks of (qc, kc)."""
    B, Sq, Sk, H, KV, hd, vd = 2, 12, 16, 4, 2, 16, 16
    qc, kc = 4, 8
    rng = np.random.default_rng(10)
    ts = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, vd),
                    (B, Sq, H, vd))]
    kw = dict(q_chunk=qc, kv_chunk=kc, q_offset=torch.full((B,), Sk - Sq))
    saved = _saved_shapes(TL.flash_attention, ts, kw)
    allowed = {(B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, vd), (B,),
               (B, Sq, H, vd), (B, KV, H // KV, Sq)}
    assert set(saved) <= allowed and (B, KV, H // KV, Sq) in saved
    plain = _saved_shapes(TL.flash_attention_plain, ts, kw)
    assert any(s[-2:] == (qc, kc) for s in plain)


@pytest.mark.parametrize("case", ["causal", "cross", "ragged"])
def test_no_grad_path_saves_nothing_and_equals_function(case):
    _, ts, kw, offset = _inputs(case, 4, jnp.bfloat16, seed=11)
    extra = {} if offset is None else dict(q_offset=torch.from_numpy(offset))
    q, k, v, _ = ts
    with torch.no_grad():
        out = TL.flash_attention(q, k, v, **kw, **extra)
    assert out.grad_fn is None
    got = _port(ts, kw, offset)[0]
    assert torch.equal(out, got)
