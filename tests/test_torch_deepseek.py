"""PyTorch port vs JAX reference, deepseek-v3's training path on its smoke
config (1 dense + 4 MoE layers, MLA, MTP): `forward` and `loss_fn` (CE,
MoE aux, MTP CE and the total; f32 2e-4, adapter grads of the "pre" and
the scanned layers within 2e-4 relative Frobenius), with the adapted
projections through K2's wrapper too; the MTP term reads only frozen
weights, so it moves the loss and no adapter's gradient, in both
packages; the layer units drop the MTP term, as the reference's do; and
one microbatch of the unit engine, EMBED running the dense "pre" layer
with its adapters and EMBED_BWD back-propagating into them, against the
JAX units (loss 1e-2 and grads 8e-2 relative Frobenius: the bf16
tolerances of `tests/test_torch_training.py`), then OPT."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.models import lora as TLR  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "deepseek-v3-671b"


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


def _frob_err(got, expect):
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    return np.linalg.norm(got - expect) / max(np.linalg.norm(expect), 1e-30)


def _nonzero_b(adapters_j, seed):
    """The reference's adapters with B drawn too, so dA is not 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                 * 0.05) if p[-1].key == "b" else x,
        adapters_j)


def k2_calls_per_step(cfg):
    """K2 calls of a one-shot step with remat: each adapted projection of
    each layer forward, recomputed, and its dx, less the first layer's
    projections whose input depends on no adapter (MLA's q)."""
    pre, scan_kind, n, _ = TMD._plan(cfg)
    kinds = pre + [scan_kind] * n
    per_layer = [len(TLR._target_dims(cfg, k)) for k in kinds]
    return 3 * sum(per_layer) - 1


@pytest.fixture(scope="module")
def f32_setup():
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ad_j = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 7)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}

    def loss_j(cfg, ad):
        return JMD.loss_fn(params_j, cfg, batch_j, adapters=ad)
    grad_j = jax.value_and_grad(loss_j, argnums=1, has_aux=True)
    (total_j, m_j), grads_j = grad_j(jcfg, ad_j)
    (total_nomtp, _), grads_nomtp = grad_j(
        dataclasses.replace(jcfg, mtp=False), ad_j)
    return dict(jcfg=jcfg, tcfg=tcfg, params_j=params_j, ad_j=ad_j,
                batch_j=batch_j, total_j=total_j, m_j=m_j, grads_j=grads_j,
                total_nomtp=total_nomtp, grads_nomtp=grads_nomtp,
                torch=to_torch((params_j, ad_j, batch_j)))


def _port_loss_and_grads(params, cfg, batch, adapters, use_kernels=False):
    ad = tree_map(lambda t: t.detach().requires_grad_(), adapters)
    total, metrics = TMD.loss_fn(params, cfg, batch, adapters=ad,
                                 use_kernels=use_kernels)
    total.backward()
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: t.grad, ad))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_and_loss_fn_with_mtp_match_reference(f32_setup,
                                                      use_kernels):
    s = f32_setup
    params, ad, batch = s["torch"]
    tcfg = s["tcfg"]
    logits_j, aux_j = JMD.forward(s["params_j"], s["jcfg"], s["batch_j"],
                                  adapters=s["ad_j"])
    logits_t, aux_t = TMD.forward(params, tcfg, batch, adapters=ad)
    np.testing.assert_allclose(_f32(logits_t), np.asarray(logits_j),
                               atol=2e-4, rtol=2e-4)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=2e-4)
    before = K2.PLAIN_CALLS
    total, m, grads = _port_loss_and_grads(params, tcfg, batch, ad,
                                           use_kernels)
    assert K2.PLAIN_CALLS - before == \
        (k2_calls_per_step(tcfg) if use_kernels else 0)
    assert set(m) == {"ce", "aux", "mtp_ce"}
    for name in m:
        assert float(m[name]) == pytest.approx(float(s["m_j"][name]),
                                               rel=2e-4)
    assert float(total) == pytest.approx(float(s["total_j"]), rel=2e-4)
    assert float(total) == pytest.approx(
        float(m["ce"]) + TMD.MOE_AUX_COEF * float(m["aux"]) / tcfg.num_layers
        + TMD.MTP_COEF * float(m["mtp_ce"]), rel=1e-6)
    assert len(grads["pre"]) == 1 and set(grads["pre"][0]) == \
        {"q", "o", "gate", "up", "down"}
    for got, expect in zip(tree_leaves(grads), jax.tree.leaves(s["grads_j"])):
        assert _frob_err(_f32(got), expect) <= 2e-4


def test_mtp_term_moves_the_loss_and_no_adapter_gradient(f32_setup):
    """`_mtp_loss` reads the embedding, the unembedding and `params["mtp"]`
    only, never an adapter: with `mtp` off the loss drops by MTP_COEF x
    mtp_ce and every adapter gradient stays the same, bit for bit in the
    port and within f32 rounding in the reference."""
    s = f32_setup
    params, ad, batch = s["torch"]
    tcfg = s["tcfg"]
    total, m, grads = _port_loss_and_grads(params, tcfg, batch, ad)
    total0, m0, grads0 = _port_loss_and_grads(
        params, dataclasses.replace(tcfg, mtp=False), batch, ad)
    assert "mtp_ce" not in m0 and float(m["mtp_ce"]) > 1.0
    assert float(total) - float(total0) == pytest.approx(
        TMD.MTP_COEF * float(m["mtp_ce"]), rel=1e-5)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert torch.equal(a, b)
    assert float(s["total_j"]) - float(s["total_nomtp"]) == pytest.approx(
        TMD.MTP_COEF * float(s["m_j"]["mtp_ce"]), rel=1e-5)
    for a, b in zip(jax.tree.leaves(s["grads_j"]),
                    jax.tree.leaves(s["grads_nomtp"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def _staged(cfg, seed):
    return jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        cfg.vocab_size, 32, 2, seed=seed)).batches(), 2).stacked()


def test_units_drop_the_mtp_term_that_train_step_keeps():
    """The units' microbatch loss is `loss_fn`'s CE bit for bit (bf16
    weights), not its total with the MoE aux and MTP terms, in the port;
    the reference's units show the same split."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    staged = _staged(tcfg, 6)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    state["adapters"] = to_torch(_nonzero_b(to_numpy(state["adapters"]), 9))
    state["opt"] = topt.adamw_init(state["adapters"])
    ad0 = tree_map(torch.clone, state["adapters"])
    state = TP.run_units(TP.make_unit_step(tcfg, pc, params), state,
                         TP.n_units_per_mb(tcfg))
    batch = {k: torch.as_tensor(v[0]) for k, v in staged.items()}
    with torch.no_grad():
        total, metrics = TMD.loss_fn(params, tcfg, batch, adapters=ad0,
                                     remat=False)
    assert float(state["loss"]) == float(metrics["ce"])
    assert float(total) - float(metrics["ce"]) > \
        0.5 * TMD.MTP_COEF * float(metrics["mtp_ce"])

    pc_j = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                               staged)
    unit_j = jax.jit(JP.make_unit_step(jcfg, pc_j, params_j))
    for _ in range(JP.n_units_per_mb(jcfg)):
        state_j = unit_j(state_j)
    total_j, m_j = JMD.loss_fn(params_j, jcfg,
                               {k: jnp.asarray(v[0])
                                for k, v in staged.items()},
                               adapters=state_j["adapters"])
    assert float(state_j["loss"]) == pytest.approx(float(m_j["ce"]),
                                                   rel=1e-2)
    assert float(total_j) - float(m_j["ce"]) > \
        0.5 * TMD.MTP_COEF * float(m_j["mtp_ce"])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_matches_reference_units(use_kernels):
    """From the JAX units' ft_state (B drawn): a microbatch's units give
    the reference's loss and accumulated grads, the "pre" layer's among
    them (EMBED_BWD's); K2's wrapper runs on every adapted projection
    (EMBED the pre layer's 5, FWD 5, BWD 10, EMBED_BWD 5 forward and 4
    dx: the pre layer's q input depends on no adapter); then OPT on both
    sides moves the adapters alike, and AdamW's m and v agree at the
    grads' tolerance (v at twice it: it is the grads squared)."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    staged = _staged(jcfg, 3)
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state0 = JP.init_ft_state(jcfg, pc_j, params, jax.random.PRNGKey(1),
                              staged)
    state0["adapters"] = _nonzero_b(state0["adapters"], 11)
    state0 = jax.tree.map(np.asarray, state0)
    unit_j = jax.jit(JP.make_unit_step(jcfg, pc_j, params))
    state_j = state0
    for _ in range(JP.n_units_per_mb(jcfg)):
        state_j = unit_j(state_j)

    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    unit = TP.make_unit_step(tcfg, pc, to_torch(params),
                             use_kernels=use_kernels)
    assert [unit.kind(u) for u in range(unit.upm)] == \
        ["EMBED"] + ["FWD"] * 4 + ["HEAD"] + ["BWD"] * 4 + ["EMBED_BWD"]
    before = K2.PLAIN_CALLS
    state = TP.run_units(unit, to_torch(state0), TP.n_units_per_mb(tcfg))
    assert K2.PLAIN_CALLS - before == \
        (5 + 4 * 5 + 4 * 10 + 9 if use_kernels else 0)
    assert float(state["loss"]) == pytest.approx(float(state_j["loss"]),
                                                 rel=1e-2)
    assert any(t.any() for t in tree_leaves(state["grads"]["pre"]))
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(state_j["grads"])):
        assert _frob_err(_f32(got), expect) <= 8e-2
    state = unit(state)                                     # OPT
    state_j = unit_j(state_j)
    assert state["iter"] == 1 and state["opt"]["t"] == 1
    for got, before, expect in zip(tree_leaves(state["adapters"]),
                                   jax.tree.leaves(state0["adapters"]),
                                   jax.tree.leaves(state_j["adapters"])):
        step = np.abs(_f32(got) - before).max()
        assert step > 0
        assert np.abs(_f32(got) - np.asarray(expect)).max() <= 2 * step + 1e-7
    for name, tol in (("m", 8e-2), ("v", 16e-2)):
        for got, expect in zip(tree_leaves(state["opt"][name]),
                               jax.tree.leaves(state_j["opt"][name])):
            assert _frob_err(_f32(got), expect) <= tol


def test_reference_embed_bwd_cannot_run_on_f32_weights():
    """A fault of the reference, not mirrored: its EMBED_BWD back-propagates
    `dy.astype(bfloat16)` through the front (`repro/training/peft.py:250`),
    whose output has the weights' dtype, so with f32 weights and "pre"
    layers its unit step cannot be traced. The port's EMBED_BWD casts dy to
    the front's dtype and runs a whole iteration on f32 weights."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    staged = _staged(jcfg, 2)
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                               staged)
    with pytest.raises(ValueError, match="bfloat16"):
        jax.jit(JP.make_unit_step(jcfg, pc_j, params_j))(state_j)
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    state = TP.run_units(TP.make_unit_step(tcfg, pc, params), state,
                         TP.units_per_iteration(tcfg, 1))
    assert state["iter"] == 1 and np.isfinite(float(state["last_loss"]))
    assert state["adapters"]["pre"][0]["q"]["a"].dtype == torch.float32


def test_embed_bwd_stages_its_own_tokens():
    """EMBED_BWD recomputes the front from its microbatch's tokens, which
    its own host part stages: a unit engine built on a state that stands
    at EMBED_BWD (as the co-located runner's eager twin of a graphed round
    may be) gives the same state as the engine that ran the microbatch."""
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=2)
    staged = tdata.Prefetcher(tdata.SyntheticCorpus(tdata.DataConfig(
        tcfg.vocab_size, 16, 2, seed=8)).batches(), 2).stacked()
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, TP.n_units_per_mb(tcfg) - 1)
    assert unit.kind(state["unit_idx"]) == "EMBED_BWD"
    twin = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)
    state = unit(state)
    twin = TP.make_unit_step(tcfg, pc, params)(twin)
    assert any(t.any() for t in tree_leaves(state["grads"]["pre"]))
    for a, b in zip(tree_leaves(state), tree_leaves(twin)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
