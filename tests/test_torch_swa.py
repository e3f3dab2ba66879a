"""PyTorch port vs JAX reference, sliding-window attention: the ring-buffered
cache (its size, the prefill's bulk and split writes, decode across the
wrap), compared exactly; and the port's K1 wrapper over a wrapped ring
(its plain version on the CPU) against the reference's dense oracle with
the window, in f32. The reference's own `ops.decode_attention` sends every
windowed cache to that oracle; the port's runs K1, which reads the ring's
first min(p + 1, S) slots: the positions the window accepts, in ring
order."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

W = 16                       # the window of these tests
KV, HD = 2, 80               # h2o-danube-1.8b's head_dim


def _cfgs():
    """danube's smoke config at head_dim 80 and window W, both sides."""
    j = jconfigs.smoke_config("h2o-danube-1.8b")
    t = tconfigs.smoke_config("h2o-danube-1.8b")
    kw = dict(head_dim=HD, num_kv_heads=KV, window=W)
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _kv(rng, B, S):
    return (rng.normal(size=(B, S, KV, HD)).astype(np.float32),
            rng.normal(size=(B, S, KV, HD)).astype(np.float32))


def _equal(cache_t, cache_j):
    assert cache_t.keys() == {"k", "v", "kv_pos"}
    for name, t in cache_t.items():
        np.testing.assert_array_equal(to_numpy(t), np.asarray(cache_j[name]))


@pytest.mark.parametrize("s_max,window,eff", [(64, 16, 16), (12, 16, 12),
                                              (64, 0, 64)])
def test_make_cache_is_a_ring_of_min_s_max_window(s_max, window, eff):
    jcfg, tcfg = _cfgs()
    cj = JA.make_cache(jcfg, 2, s_max, jnp.float32, window=window)
    ct = TA.make_cache(tcfg, 2, s_max, torch.float32, "cpu", window=window)
    assert ct["k"].shape == (2, eff, KV, HD) == cj["k"].shape
    _equal(ct, cj)


# S < W, S = W, S > W with S % W != 0, S > W with S % W == 0
@pytest.mark.parametrize("S", [W - 5, W, W + 7, 2 * W, 3 * W + 1])
def test_ring_writes_match_reference(S):
    """A prompt of S tokens written as the prefill writes it, then decode
    tokens written one at a time across (another) wrap: k, v and kv_pos
    equal the reference's exactly after every write."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(S)
    B = 2
    k, v = _kv(rng, B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    cj = JA.make_cache(jcfg, B, 64, jnp.float32, window=W)
    ct = TA.make_cache(tcfg, B, 64, torch.float32, "cpu", window=W)
    cj = JA._cache_write_prefill(cj, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), W)
    out = TA._cache_write_prefill(ct, *to_torch((k, v, pos)), W)
    assert out is ct                                   # written in place
    _equal(ct, cj)
    for step in range(W + 3):
        k1, v1 = _kv(rng, B, 1)
        p1 = np.full((B, 1), S + step, np.int32)
        cj = JA._cache_write_bulk(cj, jnp.asarray(k1), jnp.asarray(v1),
                                  jnp.asarray(p1), W)
        TA._cache_write_bulk(ct, *to_torch((k1, v1, p1)), W)
        _equal(ct, cj)
    # the ring holds exactly the last W positions
    last = S + W + 2
    assert sorted(ct["kv_pos"][0].tolist()) == list(range(last - W + 1,
                                                          last + 1))


@pytest.mark.parametrize("p", [0, 5, W - 1, W, W + 3, 2 * W + 9, 5 * W - 1])
def test_k1_wrapper_on_a_wrapped_ring_matches_oracle(p):
    """Ring caches filled up to position p (per slot: p, p - 3, 2): the
    port's `decode_attention` (K1's wrapper, plain version on the CPU, one
    call counted) against the reference's `decode_attn_ref` with the
    window, f32 at 2e-5; and the port's own oracle agrees."""
    _, tcfg = _cfgs()
    rng = np.random.default_rng(p)
    B, H = 3, 8
    positions = np.array([p, max(p - 3, 0), 2], np.int32)
    ct = TA.make_cache(tcfg, B, 128, torch.float32, "cpu", window=W)
    for b, last in enumerate(positions):
        k, v = _kv(rng, 1, last + 1)
        pos = np.arange(last + 1, dtype=np.int32)[None]
        one = TA.make_cache(tcfg, 1, 128, torch.float32, "cpu", window=W)
        TA._cache_write_prefill(one, *to_torch((k, v, pos)), W)
        for name, t in ct.items():
            t[b] = one[name][0]
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kc, vc, kv_pos = ct["k"], ct["v"], ct["kv_pos"]
    expect = JA.decode_attn_ref(jnp.asarray(q), *(jnp.asarray(to_numpy(t))
                                                  for t in (kc, vc, kv_pos)),
                                jnp.asarray(positions), W)
    before = K.PLAIN_CALLS
    got = kops.decode_attention(torch.from_numpy(q), kc, vc, kv_pos,
                                torch.from_numpy(positions), W)
    assert K.PLAIN_CALLS - before == 1
    np.testing.assert_allclose(to_numpy(got), np.asarray(expect),
                               atol=2e-5, rtol=2e-5)
    own = TA.decode_attn_ref(torch.from_numpy(q), kc, vc, kv_pos,
                             torch.from_numpy(positions), W)
    np.testing.assert_allclose(to_numpy(own), np.asarray(expect),
                               atol=2e-5, rtol=2e-5)


def test_k1_wrapper_refuses_a_ring_longer_than_the_window():
    q = torch.zeros((1, 4, 16))
    kc = torch.zeros((1, 32, 2, 16))
    pos = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        kops.decode_attention(q, kc, kc, pos, torch.tensor([40],
                                                           dtype=torch.int32),
                              window=16)
