"""PyTorch port vs JAX reference, the Mixture-of-Experts layer: the
sort-ranked rank within an expert (exactly), and `moe_forward` (y, the
load-balance loss and the dropped share, f32 at 2e-4) with both routers,
with and without a shared expert carrying LoRA, at a decode-size group
(one group for the batch) and a prefill-size one (a group per row), and
with a skewed router that forces capacity drops; the MoE layer's LoRA
targets and init shapes; and the MoE stack the port does not run yet."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lora as JLR  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import lora as TLR  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 2e-4


def _cfgs(**kw):
    """mixtral's smoke config (4 experts of 64, top-2, d 64), both sides."""
    return tuple(dataclasses.replace(c.smoke_config("mixtral-8x7b"), **kw)
                 for c in (jconfigs, tconfigs))


@pytest.mark.parametrize("G,A,E", [(1, 8, 4), (2, 48, 4), (3, 50, 8),
                                   (1, 2, 8), (2, 64, 1)])
def test_rank_in_expert_matches_reference(G, A, E):
    e = np.random.default_rng(A * E).integers(0, E, size=(G, A)
                                              ).astype(np.int32)
    expect = np.asarray(JM._rank_in_expert(jnp.asarray(e), E))
    got = TM._rank_in_expert(torch.from_numpy(e), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)


# (batch, seq): one group of 4 tokens at decode, a group per row at prefill
SIZES = {"decode": (4, 1), "prefill": (2, 24)}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("skew", [False, True])
def test_moe_forward_matches_reference(size, router, shared, skew):
    """With `skew`, every token's router logit for expert 0 is large, so
    expert 0 overflows its capacity in the prefill-size groups."""
    jcfg, tcfg = _cfgs(num_shared_experts=shared)
    B, S = SIZES[size]
    d = jcfg.d_model
    rng = np.random.default_rng(B * S + 7 * shared + 3 * skew)
    p = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(shared),
                                             jcfg, dtype=jnp.float32))
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if skew:
        v = rng.normal(size=(d,)).astype(np.float32)
        x = x * 0.1 + v
        p["router"] = p["router"].copy()
        p["router"][:, 0] = 4.0 * v / np.linalg.norm(v)
    lora = None
    if shared:
        sf = shared * jcfg.moe_d_ff
        lora = {n: (rng.normal(size=(i, 4)).astype(np.float32) * 0.1,
                    rng.normal(size=(4, o)).astype(np.float32) * 0.1)
                for n, (i, o) in (("gate", (d, sf)), ("up", (d, sf)),
                                  ("down", (sf, d)))}
    y_j, aux_j = JM.moe_forward(p, jnp.asarray(x), jcfg, router_type=router,
                                lora=lora, lora_scale=2.0)
    y_t, aux_t = TM.moe_forward(to_torch(p), torch.from_numpy(x), tcfg,
                                router_type=router, lora=to_torch(lora),
                                lora_scale=2.0)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL,
                               rtol=TOL)
    for name in ("lb_loss", "dropped_frac"):
        assert float(aux_t[name]) == pytest.approx(float(aux_j[name]),
                                                   abs=TOL, rel=TOL)
    if skew and size == "prefill":         # expert 0 overflows its capacity
        assert float(aux_t["dropped_frac"]) > 0.1
    if size == "decode":                   # C = T: a decode group never drops
        assert float(aux_t["dropped_frac"]) == 0.0


def test_moe_forward_is_differentiable_through_the_dispatch():
    """The layer's input gets a gradient through the gather dispatch, the
    expert products and the weighted combine, and the router through the
    load-balance loss; both match the reference's `jax.grad`."""
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(2), jcfg,
                                             dtype=jnp.float32))
    x = np.random.default_rng(4).normal(size=(2, 24, 64)).astype(np.float32)

    def loss_j(xx, router):
        y, aux = JM.moe_forward(dict(p, router=router), xx, jcfg)
        return jnp.sum(y * y) + aux["lb_loss"]
    gx_j, gr_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(p["router"]))
    pt = to_torch(p)
    xt = torch.from_numpy(x).requires_grad_()
    pt["router"].requires_grad_()
    y, aux = TM.moe_forward(pt, xt, tcfg)
    ((y * y).sum() + aux["lb_loss"]).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(pt["router"].grad.numpy(), np.asarray(gr_j),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_init_and_lora_targets_match_reference(shared):
    """The port's layer weights have the reference's tree, shapes and
    dtypes (its numbers come from a torch generator), and an MoE layer
    adapts q/k/v/o, plus the shared experts' gate/up/down when there are
    any: the reference's targets (`repro/models/lora.py:25-55`)."""
    jcfg, tcfg = _cfgs(num_shared_experts=shared)
    pj = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    pt = TM.moe_init(gen, tcfg, 3)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) == len(tree_leaves(pt))
    for path, leaf in flat_j:
        t = pt
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == (3,) + leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    assert JLR._target_dims(jcfg, "moe") == TLR._target_dims(tcfg, "moe")
    expect = {"q", "k", "v", "o"} | ({"gate", "up", "down"} if shared
                                     else set())
    assert set(TLR._target_dims(tcfg, "moe")) == expect
    n = tcfg.num_layers
    ad_j = JLR.init_layer_adapters(jax.random.PRNGKey(1), jcfg, "moe", n)
    ad_t = TMD.init_adapters(tcfg, 1, device="cpu")["scan"]
    assert jax.tree.map(np.shape, ad_j) == \
        {name: {k: tuple(t.shape) for k, t in v.items()}
         for name, v in ad_t.items()}


def test_a_leading_dense_stack_still_raises():
    """deepseek-v3's leading dense layers are ported (ROADMAP.md §1 item
    5.3), so this holds them against the reference instead of expecting
    `NotImplementedError`: mixtral's smoke config with one dense GQA layer
    before its MoE stack (window 64; the dense layer's cache is a ring in
    "pre") prefills 70 tokens and decodes a step like the reference, f32
    2e-4."""
    jcfg, tcfg = _cfgs(num_layers=3, first_dense_layers=1)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = to_torch(params_j)
    assert len(params_t["pre"]) == 1 and "mlp" in params_t["pre"][0]
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(2, 70)).astype(np.int32)
    logits_j, cache_j = JMD.prefill(params_j, jcfg,
                                    {"tokens": jnp.asarray(tokens)},
                                    JMD.init_cache(jcfg, 2, 96,
                                                   dtype=jnp.float32))
    cache_t = TMD.init_cache(tcfg, 2, 96, dtype=torch.float32, device="cpu")
    assert cache_t["pre"][0]["k"].shape[1] == 64
    logits_t, _ = TMD.prefill(params_t, tcfg,
                              {"tokens": torch.from_numpy(tokens)}, cache_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=TOL, rtol=TOL)
    tok = np.array(jnp.argmax(logits_j, axis=-1), np.int32)
    pos = np.full((2,), 70, np.int32)
    logits_j, cache_j = JMD.decode_step(params_j, jcfg, jnp.asarray(tok),
                                        jnp.asarray(pos), cache_j)
    logits_t, _ = TMD.decode_step(params_t, tcfg, torch.from_numpy(tok),
                                  torch.from_numpy(pos), cache_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=TOL, rtol=TOL)
    for got, expect in zip(tree_leaves(cache_t), jax.tree.leaves(cache_j)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(expect, np.float32),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,dropped", [(8, 0.0), (9, 1 / 9)])
def test_decode_capacity_at_deepseek_routing(T, dropped):
    """deepseek-v3's routing (256 experts, top-8, sigmoid, one shared
    expert) on a decode-size group of T tokens: the capacity C = min(T,
    max(8, 4 * ceil(T * k / E))) is 8 at 8 slots and at 9. With every
    token routed to the same 8 experts (a skewed router), 8 tokens fill
    each one exactly and nothing drops; 9 drop one of 9 assignments each.
    The skew saturates the sigmoid, so the 8 experts tie at 1.0: the port
    breaks the tie to the lower index as `jax.lax.top_k` does, which sets
    the top-1 expert of the load-balance loss and the order in which
    assignments take capacity. y, the load-balance loss and the dropped
    share as the reference's, f32 2e-4."""
    jcfg, tcfg = _cfgs(num_experts=256, top_k=8, num_shared_experts=1)
    d, E = jcfg.d_model, jcfg.num_experts
    rng = np.random.default_rng(T)
    p = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(4), jcfg,
                                             dtype=jnp.float32))
    v = rng.normal(size=(d,)).astype(np.float32)
    x = (rng.normal(size=(T, 1, d)) * 0.1 + v).astype(np.float32)
    p["router"] = p["router"].copy()
    p["router"][:, :8] = (4.0 * v / np.linalg.norm(v))[:, None] \
        * np.linspace(1.0, 1.5, 8)[None]
    y_j, aux_j = JM.moe_forward(p, jnp.asarray(x), jcfg,
                                router_type="sigmoid")
    y_t, aux_t = TM.moe_forward(to_torch(p), torch.from_numpy(x), tcfg,
                                router_type="sigmoid")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL,
                               rtol=TOL)
    for name in ("lb_loss", "dropped_frac"):
        assert float(aux_t[name]) == pytest.approx(float(aux_j[name]),
                                                   abs=TOL, rel=TOL)
    assert float(aux_t["dropped_frac"]) == pytest.approx(dropped, abs=1e-6)
    assert E == 256 and min(T, max(8, 4 * -(-T * 8 // E))) == 8
