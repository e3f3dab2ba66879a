"""PyTorch port vs JAX reference: norms, RoPE, MLP (+LoRA), chunked flash
attention, embedding and logits. Inputs are made with numpy from a seed and
handed to both sides; f32 at 2e-5, bf16 at 2e-2 (bf16 rounds at other
places in the two frameworks)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(t_out), np.float32),
                               np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(dtype)
    return j, to_torch(np.asarray(j))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL),
                                       (jnp.bfloat16, BF16_TOL)])
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 5, 64)), dtype)
    wj, wt = _pair(1 + 0.1 * rng.normal(size=(64,)), dtype)
    _close(TL.rms_norm(xt, wt, 1e-6), JL.rms_norm(xj, wj, 1e-6), tol)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(2, 7, 4, 16)), jnp.float32)
    pos = rng.integers(0, 64, size=(2, 7)).astype(np.int32)
    _close(TL.apply_rope(xt, torch.from_numpy(pos), theta),
           JL.apply_rope(xj, jnp.asarray(pos), theta), F32_TOL)
    _close(TL.rope_freqs(16, theta), JL.rope_freqs(16, theta), F32_TOL)


@pytest.mark.parametrize("dtype,tol,act", [(jnp.float32, F32_TOL, "silu"),
                                           (jnp.float32, F32_TOL, "gelu"),
                                           (jnp.bfloat16, BF16_TOL, "silu")])
def test_glu_mlp_with_lora(dtype, tol, act):
    rng = np.random.default_rng(2)
    d, ff, r = 32, 48, 4
    xj, xt = _pair(rng.normal(size=(2, 3, d)), dtype)
    ws = [_pair(rng.normal(size=s) * s[0] ** -0.5, dtype)
          for s in ((d, ff), (d, ff), (ff, d))]
    lora_np = {"gate": (rng.normal(size=(d, r)) * 0.1,
                        rng.normal(size=(r, ff)) * 0.1),
               "down": (rng.normal(size=(ff, r)) * 0.1,
                        rng.normal(size=(r, d)) * 0.1)}
    lora_j = {k: tuple(jnp.asarray(m, jnp.float32) for m in v)
              for k, v in lora_np.items()}
    lora_t = to_torch({k: tuple(np.float32(m) for m in v)
                       for k, v in lora_np.items()})
    out_j = JL.glu_mlp(xj, *(w[0] for w in ws), act=act, lora=lora_j,
                       lora_scale=2.0)
    out_t = TL.glu_mlp(xt, *(w[1] for w in ws), act=act, lora=lora_t,
                       lora_scale=2.0)
    _close(out_t, out_j, tol)


@pytest.mark.parametrize("case", ["causal", "q_offset", "chunked", "window",
                                  "masked_rows", "bf16"])
def test_flash_attention(case):
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, KV, hd = 2, 9, 9, 4, 2, 16
    kw = {}
    if case in ("q_offset", "masked_rows"):
        Sq = 4
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    qj, qt = _pair(rng.normal(size=(B, Sq, H, hd)), dtype)
    kj, kt = _pair(rng.normal(size=(B, Sk, KV, hd)), dtype)
    vj, vt = _pair(rng.normal(size=(B, Sk, KV, hd)), dtype)
    if case == "q_offset":
        off = np.array([3, 5], np.int32)
    elif case == "masked_rows":
        off = np.array([-2, 1], np.int32)      # rows at q_pos < 0 see no key
    else:
        off = None
    if off is not None:
        kw_j = dict(q_offset=jnp.asarray(off))
        kw_t = dict(q_offset=torch.from_numpy(off))
    else:
        kw_j, kw_t = {}, {}
    if case == "chunked":
        kw = dict(q_chunk=4, kv_chunk=3)
    if case == "window":
        kw = dict(window=3, q_chunk=4, kv_chunk=4)
    out_j = JL.flash_attention(qj, kj, vj, causal=True, **kw_j, **kw)
    out_t = TL.flash_attention(qt, kt, vt, causal=True, **kw_t, **kw)
    _close(out_t, out_j, BF16_TOL if case == "bf16" else F32_TOL)
    if case == "masked_rows":
        assert torch.all(out_t[0, :2] == 0)
        assert torch.isfinite(out_t).all()


def test_embed_and_logits():
    rng = np.random.default_rng(4)
    tj, tt = _pair(rng.normal(size=(50, 16)), jnp.float32)
    toks = rng.integers(0, 50, size=(2, 5)).astype(np.int32)
    ej = JL.embed(jnp.asarray(toks), tj)
    et = TL.embed(torch.from_numpy(toks).long(), tt)
    _close(et, ej, 0.0)
    _close(TL.lm_logits(et, tt), JL.lm_logits(ej, tj), F32_TOL)
