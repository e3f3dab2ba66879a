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
    """deepseek-v3's dense layers before its MoE stack wait for MLA."""
    cfg = dataclasses.replace(tconfigs.smoke_config("mixtral-8x7b"),
                              first_dense_layers=1)
    with pytest.raises(NotImplementedError, match="5.3"):
        TMD._plan(cfg)
