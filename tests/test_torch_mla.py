"""PyTorch port vs JAX reference, MLA attention and deepseek-v3's model
assembly on its smoke config (1 dense + 4 MoE layers, MLA ranks 64/32,
rope 16, 4 experts of 64, top-2, one shared expert, MTP): `mla_prefill`
(output and latent cache, f32 2e-5) and `mla_decode` (f32 2e-5; bf16 at
2e-2, since the decode rounds its softmax weights to the cache's dtype
before the latent PV product, as `decode_attn_ref` does), a slot with no
valid position returning 0 (not NaN), the absorbed decode against its
unabsorbed form, the init trees, interop of params and caches with their
"pre" lists and "mtp" head, and prefill / greedy decode logits of the
whole model (f32 2e-4, as `tests/test_torch_model.py`). Weights carried
over from the JAX init by interop."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
MODEL_TOL = 2e-4


def _cfgs():
    return jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


def _mla_inputs(dtype, seed=0, B=3, S=10):
    """The reference's MLA weights of one layer, an input and q/o adapters
    with B drawn (so both adapters change the output)."""
    jcfg, _ = _cfgs()
    p = JA.mla_init(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
                    ).astype(dtype)
    H = jcfg.num_heads
    dims = {"q": (jcfg.mla_q_rank,
                  H * (jcfg.mla_nope_dim + jcfg.mla_rope_dim)),
            "o": (H * jcfg.mla_v_dim, jcfg.d_model)}
    lora = {n: (jnp.asarray(rng.normal(size=(i, 4)).astype(np.float32)
                            * i ** -0.5),
                jnp.asarray(rng.normal(size=(4, o)).astype(np.float32) * 0.1))
            for n, (i, o) in dims.items()}
    return p, x, lora


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_lora", [False, True])
def test_mla_prefill_matches_reference(dtype, with_lora):
    jcfg, tcfg = _cfgs()
    p, x, lora = _mla_inputs(dtype)
    lora = lora if with_lora else None
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    cache = JA.make_cache(jcfg, B, 16, dtype=dtype)
    out_j, cache_j = JA.mla_prefill(p, x, pos, jcfg, cache=cache, lora=lora,
                                    lora_scale=2.0)
    cache_t = TA.make_cache(tcfg, B, 16, dtype=to_torch(x).dtype)
    out_t, cache_t2 = TA.mla_prefill(to_torch(p), to_torch(x), to_torch(pos),
                                     tcfg, cache=cache_t, lora=to_torch(lora),
                                     lora_scale=2.0)
    assert cache_t2 is cache_t                   # written in place
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out_t), np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)
    assert cache_t.keys() == cache_j.keys() == {"c_kv", "k_rope", "kv_pos"}
    for name in cache_j:
        np.testing.assert_allclose(_f32(cache_t[name]),
                                   np.asarray(cache_j[name], np.float32),
                                   atol=tol, rtol=tol)


def _prefilled(dtype, S=10):
    """Three slots of a 16-slot MLA cache prefilled with S, S - 3 and 0
    tokens (slot 2 empty), both sides, from the reference's prefill."""
    jcfg, _ = _cfgs()
    p, x, lora = _mla_inputs(dtype, seed=3, S=S)
    B = x.shape[0]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    _, cache = JA.mla_prefill(p, x, pos, jcfg,
                              cache=JA.make_cache(jcfg, B, 16, dtype=dtype))
    kv_pos = np.asarray(cache["kv_pos"]).copy()
    kv_pos[1, S - 3:] = -1
    kv_pos[2] = -1
    cache = dict(cache, kv_pos=jnp.asarray(kv_pos))
    return p, lora, cache


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mla_decode_matches_reference_and_an_empty_slot_returns_zero(dtype):
    """Slots 0 and 1 decode at their next position; slot 2 at position -1,
    which writes its token at the last index with kv_pos -1 (both sides),
    so no position is valid: its attention output, and so the layer's,
    is exactly 0, not NaN."""
    jcfg, tcfg = _cfgs()
    p, lora, cache_j = _prefilled(dtype)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
                    ).astype(dtype)
    pos = jnp.asarray([10, 7, -1], jnp.int32)
    cache_t = to_torch(jax.tree.map(np.asarray, cache_j))
    out_j, new_j = JA.mla_decode(p, x, pos, cache_j, jcfg, lora=lora,
                                 lora_scale=2.0)
    out_t, new_t = TA.mla_decode(to_torch(p), to_torch(x), to_torch(pos),
                                 cache_t, tcfg, lora=to_torch(lora),
                                 lora_scale=2.0)
    assert new_t is cache_t
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out_t), np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)
    for name in new_j:
        np.testing.assert_allclose(_f32(new_t[name]),
                                   np.asarray(new_j[name], np.float32),
                                   atol=tol, rtol=tol)
    assert torch.isfinite(out_t).all()
    assert not out_t[2].any() and not np.asarray(out_j[2]).any()
    assert out_t[:2].abs().amax() > 0.1


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_absorbed_decode_matches_the_unabsorbed_form(dtype, tol):
    """The absorbed latent product against K/V expanded from c_kv through
    W_kv_b (`mla_decode_expanded`) on the same cache: f32 at 2e-5, bf16 at
    2e-2 (the absorbed form rounds q_lat, the softmax weights and o to
    bf16), relative to the output's largest entry. The empty slot gives 0
    on both."""
    _, tcfg = _cfgs()
    p, _, cache = _prefilled(jnp.float32)
    p_t, cache_t = to_torch((p, jax.tree.map(np.asarray, cache)))
    p_t = {k: v.to(dtype) for k, v in p_t.items()}
    cache_t = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in cache_t.items()}
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 1, tcfg.d_model)).astype(np.float32)).to(dtype)
    pos = torch.tensor([10, 7, -1], dtype=torch.int32)
    expect = TA.mla_decode_expanded(p_t, x, pos, {k: v.clone() for k, v in
                                                 cache_t.items()}, tcfg)
    got, _ = TA.mla_decode(p_t, x, pos, cache_t, tcfg)
    scale = expect.float().abs().max().item()
    assert (got.float() - expect.float()).abs().max().item() <= tol * scale
    assert not got[2].any() and not expect[2].any()


def test_init_trees_match_reference():
    """Params (with the "pre" dense layer and the "mtp" head), adapters
    and caches have the reference's tree, shapes and dtypes; the pre
    layer's adapters are the "attn" kind's MLA targets."""
    jcfg, tcfg = _cfgs()
    def shapes(tree):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)
    pj = jax.eval_shape(lambda: JMD.init_params(jcfg, jax.random.PRNGKey(0)))
    pt = TMD.init_params(tcfg, 0, device="cpu")
    assert shapes(pj) == shapes(to_numpy(pt))
    assert len(pt["pre"]) == 1 and pt["scan"]["ln1"].shape[0] == 4
    assert set(pt["mtp"]) == {"norm_h", "norm_e", "proj", "layer"}
    aj = JMD.init_adapters(jcfg, jax.random.PRNGKey(1))
    at = TMD.init_adapters(tcfg, 1, device="cpu")
    assert shapes(aj) == shapes(to_numpy(at))
    assert set(at["pre"][0]) == {"q", "o", "gate", "up", "down"}
    cj = JMD.init_cache(jcfg, 2, 16)
    ct = TMD.init_cache(tcfg, 2, 16, device="cpu")
    assert shapes(cj) == shapes(to_numpy(ct))
    assert ct["pre"][0]["c_kv"].shape == (2, 16, tcfg.mla_kv_rank)
    assert ct["scan"]["k_rope"].shape == (4, 2, 16, tcfg.mla_rope_dim)


def test_interop_carries_pre_layers_mla_leaves_and_mtp_exactly():
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, JMD.init_params(
        jcfg, jax.random.PRNGKey(0)))
    t = to_torch(params)
    assert isinstance(t["pre"], list) and t["pre"][0]["attn"]["wkv_b"].dtype \
        == torch.bfloat16
    assert t["mtp"]["layer"]["attn"]["wq_a"].shape == \
        params["mtp"]["layer"]["attn"]["wq_a"].shape
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(to_numpy(t))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


B, S, S_MAX, STEPS = 2, 12, 64, 6


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_prefill_and_greedy_decode_match_reference(use_kernels):
    """f32 weights and cache: prefill logits and every cache (the pre
    layer's and the stacked ones), then 6 greedy decode steps, logits
    within 2e-4 and the same tokens. MLA decode runs no K1 (the reference's
    MLA branch takes no decode kernel), and decode has no adapters, so no
    K2 call either, with the kernels on or off."""
    jcfg, tcfg = _cfgs()
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = to_torch(params_j)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    cache_j = JMD.init_cache(jcfg, B, S_MAX, dtype=jnp.float32)
    logits_j, cache_j = jax.jit(lambda p, b, c: JMD.prefill(p, jcfg, b, c))(
        params_j, {"tokens": jnp.asarray(tokens)}, cache_j)
    cache_t = TMD.init_cache(tcfg, B, S_MAX, dtype=torch.float32,
                             device="cpu")
    k1, k2 = K1.PLAIN_CALLS, K2.PLAIN_CALLS
    logits_t, _ = TMD.prefill(params_t, tcfg,
                              {"tokens": torch.from_numpy(tokens)}, cache_t,
                              use_kernels=use_kernels)
    np.testing.assert_allclose(_f32(logits_t), np.asarray(logits_j),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for got, expect in zip(tree_leaves(cache_t), jax.tree.leaves(cache_j)):
        np.testing.assert_allclose(_f32(got), np.asarray(expect, np.float32),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    decode_j = jax.jit(lambda p, t, q, c: JMD.decode_step(p, jcfg, t, q, c))
    tok = np.array(jnp.argmax(logits_j, axis=-1), np.int32)
    for step in range(STEPS):
        pos = np.full((B,), S + step, np.int32)
        logits_j, cache_j = decode_j(params_j, jnp.asarray(tok),
                                     jnp.asarray(pos), cache_j)
        logits_t, _ = TMD.decode_step(params_t, tcfg, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cache_t,
                                      use_kernels=use_kernels)
        np.testing.assert_allclose(_f32(logits_t), np.asarray(logits_j),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        tok = np.array(jnp.argmax(logits_j, axis=-1), np.int32)
        np.testing.assert_array_equal(logits_t.argmax(dim=-1).numpy(), tok)
    assert (K1.PLAIN_CALLS, K2.PLAIN_CALLS) == (k1, k2)
    for got, expect in zip(tree_leaves(cache_t), jax.tree.leaves(cache_j)):
        np.testing.assert_allclose(_f32(got), np.asarray(expect, np.float32),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_prefill_then_decode_equals_the_full_forward(dtype, tol):
    """Inside the port: the logits of a decode step after a prefill of S
    tokens equal `forward`'s logits at position S over the S + 1 tokens
    (the absorbed decode against the expanded prefill), relative to the
    largest logit: f32 2e-5, bf16 2e-2 (as served). Every token is routed
    to every expert (top-k = E, capacity T), so that no assignment is
    dropped in any of the three dispatches (their groups differ: a row of
    12, of 13, the batch) and no rounding can swap a top-k choice."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, top_k=tcfg.num_experts,
                               capacity_factor=1.0)
    params = TMD.init_params(tcfg, 3, dtype=dtype, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(2, S + 1)).astype(np.int32))
    cache = TMD.init_cache(tcfg, 2, S_MAX, dtype=dtype, device="cpu")
    TMD.prefill(params, tcfg, {"tokens": toks[:, :S]}, cache)
    got, _ = TMD.decode_step(params, tcfg, toks[:, S],
                             torch.full((2,), S, dtype=torch.int32), cache)
    expect, _ = TMD.forward(params, tcfg, {"tokens": toks})
    expect = expect[:, S].float()
    assert (got.float() - expect).abs().max() <= tol * expect.abs().max()
