"""PyTorch port vs JAX reference: the dense GQA attention layer — QKV
projection (+LoRA, qk_norm), prefill with its cache write, one-token decode
with its cache write, and the dense decode oracle. f32 at 2e-5; the bf16
decode oracle at 2e-2."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

TOL = 2e-5
CFG = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
           num_kv_heads=2, d_ff=48, vocab_size=64, head_dim=16,
           rope_theta=5e5)


def _cfgs(**over):
    kw = dict(CFG, **over)
    return JConfig(**kw), TConfig(**kw)


def _params(rng, cfg, qk_norm=False):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, H * hd)) * d ** -0.5,
         "wk": rng.normal(size=(d, KV * hd)) * d ** -0.5,
         "wv": rng.normal(size=(d, KV * hd)) * d ** -0.5,
         "wo": rng.normal(size=(H * hd, d)) * (H * hd) ** -0.5}
    if qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.normal(size=(hd,))
        p["k_norm"] = 1 + 0.1 * rng.normal(size=(hd,))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, to_torch(p)


def _lora(rng, cfg, r=4):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    outs = {"q": H * hd, "k": KV * hd, "v": KV * hd}
    ad = {k: ((rng.normal(size=(d, r)) * 0.1).astype(np.float32),
              (rng.normal(size=(r, n)) * 0.1).astype(np.float32))
          for k, n in outs.items()}
    ad["o"] = ((rng.normal(size=(H * hd, r)) * 0.1).astype(np.float32),
               (rng.normal(size=(r, d)) * 0.1).astype(np.float32))
    return ({k: tuple(jnp.asarray(m) for m in v) for k, v in ad.items()},
            to_torch(ad))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_with_lora(qk_norm):
    rng = np.random.default_rng(0)
    jc, tc = _cfgs(qk_norm=qk_norm)
    pj, pt = _params(rng, jc, qk_norm)
    lj, lt = _lora(rng, jc)
    x = rng.normal(size=(2, 5, jc.d_model)).astype(np.float32)
    outs_j = JA._project_qkv(pj, jnp.asarray(x), jc, lj, 2.0)
    outs_t = TA._project_qkv(pt, torch.from_numpy(x), tc, lt, 2.0)
    for t, j in zip(outs_t, outs_j):
        _close(t, j)
    o = rng.normal(size=(2, 5, jc.num_heads, jc.head_dim)).astype(np.float32)
    _close(TA._out_proj(pt, torch.from_numpy(o), tc, lt, 2.0),
           JA._out_proj(pj, jnp.asarray(o), jc, lj, 2.0))


def _prefilled(rng, jc, tc, pj, pt, B=2, S=7, s_max=16):
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    cj = JA.make_cache(jc, B, s_max, jnp.float32)
    ct = TA.make_cache(tc, B, s_max, torch.float32, "cpu")
    out_j, cj = JA.attn_prefill(pj, jnp.asarray(x), jnp.asarray(pos), jc,
                                cache=cj)
    out_t, ct = TA.attn_prefill(pt, torch.from_numpy(x),
                                torch.from_numpy(pos), tc, cache=ct)
    return out_j, cj, out_t, ct


def test_attn_prefill_with_cache_write():
    rng = np.random.default_rng(1)
    jc, tc = _cfgs()
    pj, pt = _params(rng, jc)
    out_j, cj, out_t, ct = _prefilled(rng, jc, tc, pj, pt)
    _close(out_t, out_j)
    for name in ("k", "v", "kv_pos"):
        _close(ct[name], cj[name])


def test_attn_decode_with_cache_write():
    rng = np.random.default_rng(2)
    jc, tc = _cfgs()
    pj, pt = _params(rng, jc)
    _, cj, _, ct = _prefilled(rng, jc, tc, pj, pt)
    for pos in ([7, 7], [8, 3]):          # second round: slot 1 rewinds
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        pos = np.asarray(pos, np.int32)
        out_j, cj = JA.attn_decode(pj, jnp.asarray(x), jnp.asarray(pos), cj,
                                   jc)
        out_t, ct = TA.attn_decode(pt, torch.from_numpy(x),
                                   torch.from_numpy(pos), ct, tc)
        _close(out_t, out_j)
        for name in ("k", "v", "kv_pos"):
            _close(ct[name], cj[name])


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, TOL),
                                       (jnp.bfloat16, 2e-2)])
def test_decode_attn_ref(dtype, tol):
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 3, 20, 8, 2, 16
    q = jnp.asarray(rng.normal(size=(B, H, hd))).astype(dtype)
    kc = jnp.asarray(rng.normal(size=(B, S, KV, hd))).astype(dtype)
    vc = jnp.asarray(rng.normal(size=(B, S, KV, hd))).astype(dtype)
    kv_pos = np.full((B, S), -1, np.int32)
    lens = [5, 20, 1]
    for b, n in enumerate(lens):
        kv_pos[b, :n] = np.arange(n)
    positions = np.asarray([4, 12, 0], np.int32)    # slot 1 masks its tail
    out_j = JA.decode_attn_ref(q, kc, vc, jnp.asarray(kv_pos),
                               jnp.asarray(positions))
    out_t = TA.decode_attn_ref(
        *to_torch([np.asarray(q), np.asarray(kc), np.asarray(vc)]),
        torch.from_numpy(kv_pos), torch.from_numpy(positions))
    assert out_t.dtype == to_torch(np.asarray(vc)).dtype
    _close(out_t, out_j, tol)


def test_make_cache_matches_reference_layout():
    jc, tc = _cfgs()
    cj = JA.make_cache(jc, 2, 16)
    ct = TA.make_cache(tc, 2, 16, device="cpu")
    assert set(cj) == set(ct)
    for name in cj:
        assert tuple(ct[name].shape) == cj[name].shape
        np.testing.assert_array_equal(
            np.asarray(to_numpy(ct[name]), np.float32),
            np.asarray(cj[name], np.float32))
