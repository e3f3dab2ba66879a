"""PyTorch port vs JAX reference, training path: the data pipeline, AdamW,
`forward`/`loss_fn` with LoRA adapters, and the layer-unit PEFT engine
(against the one-shot train step inside torch, and against the JAX unit
engine on a carried-across `ft_state`). Small widths: the 3-layer d 64
config of `tests/test_peft.py` and the smoke configs."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lora as TLR  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.config import LoRAConfig, ModelConfig  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SMALL = dict(name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=96, vocab_size=256)


def _cfgs(**kw):
    base = dict(SMALL, **kw)
    return (JModelConfig(**base, lora=JLoRAConfig(rank=4)),
            ModelConfig(**base, lora=LoRAConfig(rank=4)))


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


def _frob_err(got, expect):
    """Relative Frobenius error |got - expect| / |expect|."""
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    return np.linalg.norm(got - expect) / max(np.linalg.norm(expect), 1e-30)


def _nonzero_b(adapters_j, seed):
    """The reference's adapters with B drawn too, so dA is not 0."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                 * 0.05) if p[-1].key == "b" else x,
        adapters_j)


# ------------------------------------------------------------------ data --
def test_synthetic_corpus_and_prefetcher_match_reference():
    pj, pt = (m.Prefetcher(m.SyntheticCorpus(m.DataConfig(
        256, 16, 2, seed=5)).batches(), 2) for m in (jdata, tdata))
    for _ in range(3):
        sj, st = pj.stacked(), pt.stacked()
        assert sj.keys() == st.keys()
        for k in sj:
            np.testing.assert_array_equal(sj[k], st[k])
        pj.refill(1)
        pt.refill(1)


# ----------------------------------------------------------------- AdamW --
ADAMW_CASES = [
    dict(),
    dict(lr=1e-3, weight_decay=0.01, grad_clip=0.5, warmup_steps=2),
    dict(lr=5e-3, grad_clip=0.0, warmup_steps=1),
]


def _adamw_inputs():
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"scan": {"q": {"a": rng.normal(size=(2, 8, 4)) * scale,
                               "b": rng.normal(size=(2, 4, 8)) * scale}},
                "pre": [{"o": rng.normal(size=(3, 5)) * scale}]}
    params = tree_map(lambda x: x.astype(np.float32), tree(0.5))
    grads_seq = [tree_map(lambda x: x.astype(np.float32), tree(s))
                 for s in (1e-3, 2.0, 0.3)]
    return params, grads_seq


@pytest.mark.parametrize("opt", ADAMW_CASES)
def test_adamw_matches_reference(opt):
    params, grads_seq = _adamw_inputs()
    cj, ct = jopt.AdamWConfig(**opt), topt.AdamWConfig(**opt)
    pj, sj = params, jopt.adamw_init(params)
    pt = to_torch(params)
    st = topt.adamw_init(pt)
    for g in grads_seq:
        pj, sj = jopt.adamw_update(cj, g, sj, pj)
        pt, st = topt.adamw_update(ct, to_torch(g), st, pt)
    assert st["t"] == int(sj["t"]) == 3
    for got, expect in zip(tree_leaves([pt, st["m"], st["v"]]),
                           jax.tree.leaves([pj, sj["m"], sj["v"]])):
        np.testing.assert_allclose(_f32(got), np.asarray(expect),
                                   atol=1e-6, rtol=1e-6)
    for t in (0, 1, 5, 20):
        assert topt.lr_at(ct, t) == float(jopt.lr_at(cj, jnp.int32(t)))


@pytest.mark.parametrize("opt", ADAMW_CASES)
def test_adamw_in_place_matches_functional_and_reference(opt):
    """The unit engine's in-place AdamW, its lr and bias corrections read
    from a small f32 tensor written before each step, writes the same bits
    as the functional update into the same tensors (a CUDA graph captured
    on them sees every step), and so meets the reference at the
    functional update's tolerance."""
    params, grads_seq = _adamw_inputs()
    cj, ct = jopt.AdamWConfig(**opt), topt.AdamWConfig(**opt)
    pj, sj = params, jopt.adamw_init(params)
    pt = to_torch(params)
    st = topt.adamw_init(pt)
    pi = to_torch(params)
    si = topt.adamw_init(pi)
    hp = torch.zeros((4,), dtype=torch.float32)
    addresses = [t.data_ptr() for t in tree_leaves([pi, si["m"], si["v"]])]
    for g in grads_seq:
        pj, sj = jopt.adamw_update(cj, g, sj, pj)
        pt, st = topt.adamw_update(ct, to_torch(g), st, pt)
        hp.copy_(torch.from_numpy(topt.adamw_hparams(ct, si["t"] + 1)))
        assert float(hp[0]) == topt.lr_at(ct, si["t"] + 1)
        topt.adamw_update_(ct, to_torch(g), si, pi, hp)
        si["t"] += 1
        for a, b in zip(tree_leaves([pt, st["m"], st["v"]]),
                        tree_leaves([pi, si["m"], si["v"]])):
            assert torch.equal(a, b)
    assert si["t"] == st["t"] == 3
    assert [t.data_ptr() for t in tree_leaves([pi, si["m"], si["v"]])] == \
        addresses
    for got, expect in zip(tree_leaves([pi, si["m"], si["v"]]),
                           jax.tree.leaves([pj, sj["m"], sj["v"]])):
        np.testing.assert_allclose(_f32(got), np.asarray(expect),
                                   atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- forward / loss --
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2.5-7b",
                                  "h2o-danube-1.8b"])
def test_forward_and_loss_fn_match_reference(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ad_j = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 7)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.8).astype(np.float32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens),
               "mask": jnp.asarray(mask)}
    params_t, ad_t, batch_t = to_torch((params_j, ad_j, batch_j))

    logits_j, _ = JMD.forward(params_j, jcfg, batch_j, adapters=ad_j)
    logits_t, aux_t = TMD.forward(params_t, tcfg, batch_t, adapters=ad_t)
    assert float(aux_t) == 0.0
    np.testing.assert_allclose(_f32(logits_t), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    loss_j, _ = JMD.loss_fn(params_j, jcfg, batch_j, adapters=ad_j)
    loss_t, metrics = TMD.loss_fn(params_t, tcfg, batch_t, adapters=ad_t)
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-5, rel=1e-5)
    assert float(metrics["ce"]) == float(loss_t)


def test_moe_loss_fn_with_aux_matches_reference():
    """mixtral's smoke config (MoE, window 64) over 80 tokens, so the
    window bites and the capacity drops some assignments: logits, the
    summed load-balance loss, the CE and the total loss CE + 0.01 * aux /
    num_layers match the reference's (f32, 2e-4), as do the adapters'
    gradients of the total (relative Frobenius 2e-4)."""
    jcfg = jconfigs.smoke_config("mixtral-8x7b")
    tcfg = tconfigs.smoke_config("mixtral-8x7b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ad_j = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 7)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 80)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    params_t, ad_t, batch_t = to_torch((params_j, ad_j, batch_j))

    logits_j, aux_j = JMD.forward(params_j, jcfg, batch_j, adapters=ad_j)
    logits_t, aux_t = TMD.forward(params_t, tcfg, batch_t, adapters=ad_t)
    np.testing.assert_allclose(_f32(logits_t), np.asarray(logits_j),
                               atol=2e-4, rtol=2e-4)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=2e-4)
    assert float(aux_t) > 0

    def loss_j(ad):
        return JMD.loss_fn(params_j, jcfg, batch_j, adapters=ad)
    (total_j, m_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(ad_j)
    ad = tree_map(lambda t: t.detach().requires_grad_(), ad_t)
    total_t, m_t = TMD.loss_fn(params_t, tcfg, batch_t, adapters=ad)
    total_t.backward()
    total_t, m_t = total_t.detach(), {k: v.detach() for k, v in m_t.items()}
    for name in ("ce", "aux"):
        assert float(m_t[name]) == pytest.approx(float(m_j[name]), rel=2e-4)
    assert float(total_t) == pytest.approx(float(total_j), rel=2e-4)
    assert float(total_t) == pytest.approx(
        float(m_t["ce"]) + TMD.MOE_AUX_COEF * float(m_t["aux"])
        / tcfg.num_layers, rel=1e-6)
    for got, expect in zip(tree_leaves(tree_map(lambda t: t.grad, ad)),
                           jax.tree.leaves(grads_j)):
        assert _frob_err(_f32(got), expect) <= 2e-4


def test_units_drop_the_moe_aux_loss_that_train_step_keeps():
    """On an MoE stack the layer units train on the CE alone, as the
    reference's do (`repro/training/peft.py:156`, `:224` drop each layer's
    aux), while `make_train_step` minimises CE + 0.01 * aux / layers: the
    units' loss is the train step's CE bit for bit, not its total, and
    their accumulated grads are the CE's gradient, not the total's. The
    reference shows the same split: its units' loss is its `loss_fn`'s CE
    metric."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("mixtral-8x7b"),
                               lora=JLoRAConfig(rank=4))
    tcfg = tconfigs.smoke_config("mixtral-8x7b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0))        # bf16
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    staged = tdata.Prefetcher(tdata.SyntheticCorpus(tdata.DataConfig(
        tcfg.vocab_size, 32, 2, seed=6)).batches(), 2).stacked()
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    state["adapters"] = to_torch(_nonzero_b(to_numpy(state["adapters"]), 9))
    state["opt"] = topt.adamw_init(state["adapters"])
    ad0 = tree_map(torch.clone, state["adapters"])
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, TP.n_units_per_mb(tcfg))
    batch = {k: torch.as_tensor(v[0]) for k, v in staged.items()}
    ad = tree_map(lambda t: t.detach().requires_grad_(), ad0)
    with torch.enable_grad():
        total, metrics = TMD.loss_fn(params, tcfg, batch, adapters=ad,
                                     remat=False)
        grads_total = torch.autograd.grad(total, tree_leaves(ad),
                                          retain_graph=True)
        grads_ce = torch.autograd.grad(metrics["ce"], tree_leaves(ad))
    total, metrics = total.detach(), {k: v.detach()
                                      for k, v in metrics.items()}
    assert float(state["loss"]) == float(metrics["ce"])
    # the difference of two f32 losses near 5.5: 1e-6 is a few ulps
    assert float(total) - float(metrics["ce"]) == pytest.approx(
        TMD.MOE_AUX_COEF * float(metrics["aux"]) / tcfg.num_layers,
        abs=1e-6)
    assert float(metrics["aux"]) > 0
    for got, g_ce, g_tot in zip(tree_leaves(state["grads"]), grads_ce,
                                grads_total):
        assert torch.equal(got, g_ce)
    assert any(not torch.equal(a, b) for a, b in zip(grads_ce, grads_total))

    # the reference: its units' microbatch loss is its loss_fn's CE
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                               staged)
    unit_j = jax.jit(JP.make_unit_step(jcfg, pc_j, params_j))
    for _ in range(JP.n_units_per_mb(jcfg)):
        state_j = unit_j(state_j)
    batch_j = {k: jnp.asarray(v[0]) for k, v in staged.items()}
    total_j, m_j = JMD.loss_fn(params_j, jcfg, batch_j,
                               adapters=state_j["adapters"])
    assert float(state_j["loss"]) == pytest.approx(float(m_j["ce"]),
                                                   rel=1e-2)
    assert abs(float(total_j) - float(m_j["ce"])) > 1e-4


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_moe_matches_reference_units(use_kernels):
    """mixtral's smoke config (LoRA on q/k/v/o only: the routed experts
    take none) from the JAX units' ft_state (B drawn): a microbatch's
    units give the reference's loss (1e-2) and accumulated grads (8e-2
    relative Frobenius), the dense test's bf16 tolerances; 4 K2 calls per
    FWD unit and 8 per BWD unit with the kernels on; then OPT on both
    sides moves the adapters alike."""
    jcfg = jconfigs.smoke_config("mixtral-8x7b")
    tcfg = tconfigs.smoke_config("mixtral-8x7b")
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        jcfg.vocab_size, 32, 2, seed=3)).batches(), 2).stacked()
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
    before = K2.PLAIN_CALLS
    unit = TP.make_unit_step(tcfg, pc, to_torch(params),
                             use_kernels=use_kernels)
    state = TP.run_units(unit, to_torch(state0), TP.n_units_per_mb(tcfg))
    assert K2.PLAIN_CALLS - before == (12 * tcfg.num_layers
                                       if use_kernels else 0)
    assert state["adapters"]["scan"].keys() == {"q", "k", "v", "o"}
    assert float(state["loss"]) == pytest.approx(float(state_j["loss"]),
                                                 rel=1e-2)
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(state_j["grads"])):
        assert _frob_err(_f32(got), expect) <= 8e-2
    state = unit(state)                                     # OPT
    state_j = unit_j(state_j)
    assert state["iter"] == 1 and np.isfinite(float(state["last_loss"]))
    # AdamW's first step moves each entry by about lr whatever its grad's
    # size, so a bf16-noise grad of the other sign moves it the other way:
    # the adapters agree within two of the port's own steps
    for got, before, expect in zip(tree_leaves(state["adapters"]),
                                   jax.tree.leaves(state0["adapters"]),
                                   jax.tree.leaves(state_j["adapters"])):
        step = np.abs(_f32(got) - before).max()
        assert step > 0
        assert np.abs(_f32(got) - np.asarray(expect)).max() <= 2 * step + 1e-7


def test_chunked_xent_and_cross_entropy_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 37, 16)).astype(np.float32)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 37)).astype(np.int32)
    mask = (rng.random((2, 37)) < 0.7).astype(np.float32)
    for m in (None, mask):
        def jloss(x):
            return JL.chunked_softmax_xent(x, table, labels, m, chunk=8)
        lj, gj = jax.value_and_grad(jloss)(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        lt = TL.chunked_softmax_xent(xt, torch.from_numpy(table),
                                     torch.from_numpy(labels),
                                     None if m is None else
                                     torch.from_numpy(m), chunk=8)
        lt.backward()
        assert float(lt.detach()) == pytest.approx(float(lj), abs=1e-5,
                                                   rel=1e-5)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj),
                                   atol=1e-6, rtol=1e-5)
        logits = rng.normal(size=(2, 37, 50)).astype(np.float32)
        ce_j = JL.cross_entropy(jnp.asarray(logits), labels, m)
        ce_t = TL.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if m is None else torch.from_numpy(m))
        assert float(ce_t) == pytest.approx(float(ce_j), abs=1e-5, rel=1e-5)


def test_init_adapters_shapes_match_reference():
    jcfg, tcfg = jconfigs.smoke_config("llama3-8b"), \
        tconfigs.smoke_config("llama3-8b")
    ad_j = JMD.init_adapters(jcfg, jax.random.PRNGKey(0))
    ad_t = TMD.init_adapters(tcfg, 0, device="cpu")
    assert jax.tree.structure(ad_j) == jax.tree.structure(to_numpy(ad_t))
    for j, t in zip(jax.tree.leaves(ad_j), tree_leaves(ad_t)):
        assert tuple(j.shape) == tuple(t.shape) and t.dtype == torch.float32
    for v in ad_t["scan"].values():
        assert not v["b"].any() and v["a"].std() > 0
    assert TLR.adapter_count(ad_t) == sum(x.size for x in
                                          jax.tree.leaves(ad_j))
    assert TLR.lora_scale(tcfg) == 8.0


# ---------------------------------------------------------- unit engine --
def _torch_setup(seed_batch, accum, opt, seq=16):
    jcfg, tcfg = _cfgs()
    params = to_torch(JMD.init_params(jcfg, jax.random.PRNGKey(0)))  # bf16
    pc = TP.PeftConfig(micro_batch=2, seq_len=seq, accum=accum, opt=opt)
    staged = tdata.Prefetcher(tdata.SyntheticCorpus(tdata.DataConfig(
        tcfg.vocab_size, seq, 2, seed=seed_batch)).batches(), 2).stacked()
    return tcfg, params, pc, staged


def _run_iteration(tcfg, params, pc, state, **kw):
    unit = TP.make_unit_step(tcfg, pc, params, **kw)
    return TP.run_units(unit, state,
                        TP.units_per_iteration(tcfg, pc.accum))


def test_unit_engine_equals_train_step():
    """One iteration of units equals one one-shot train step (accum 1), bit
    for bit: loss, accumulated grads and adapters after AdamW. Both run the
    same bf16 layer ops on the same bf16 inputs (the one-shot residual
    stream is bf16 too, since the weights are), and each BWD unit's
    autograd graph is that layer's part of the whole graph."""
    opt = topt.AdamWConfig(lr=1e-3, grad_clip=0.0, warmup_steps=1)
    tcfg, params, pc, staged = _torch_setup(1, 1, opt)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    ad0 = tree_map(torch.clone, state["adapters"])
    # run the units up to OPT, keep the accumulated grads, then OPT
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, TP.n_units_per_mb(tcfg))
    grads_units = tree_map(torch.clone, state["grads"])
    state = unit(state)
    assert state["iter"] == 1 and state["unit_idx"] == 0

    batch = {k: torch.as_tensor(v[0]) for k, v in staged.items()}
    ts = TP.make_train_step(tcfg, opt, remat=False)
    ad1, _, metrics = ts(params, ad0, topt.adamw_init(ad0), batch)
    assert float(state["last_loss"]) == float(metrics["loss"])

    ad = tree_map(lambda t: t.detach().requires_grad_(), ad0)
    with torch.enable_grad():
        loss, _ = TMD.loss_fn(params, tcfg, batch, adapters=ad, remat=False)
        loss.backward()
    for g_units, a in zip(tree_leaves(grads_units), tree_leaves(ad)):
        assert torch.equal(g_units, a.grad)
    for got, expect in zip(tree_leaves(state["adapters"]), tree_leaves(ad1)):
        assert torch.equal(got, expect)


def test_unit_engine_grad_accumulation():
    """accum = 2: the units sum the two microbatches' gradients (as the
    reference's do), and AdamW, invariant to that scale up to eps, moves
    the adapters as it would on their average."""
    opt = topt.AdamWConfig(lr=1e-3, grad_clip=0.0, warmup_steps=1)
    tcfg, params, pc, staged = _torch_setup(2, 2, opt)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    ad0 = tree_map(torch.clone, state["adapters"])
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, 2 * TP.n_units_per_mb(tcfg))
    assert state["consumed"] == 2 and state["data_idx"] == 2

    ad = tree_map(lambda t: t.detach().requires_grad_(), ad0)
    with torch.enable_grad():
        total = 0.0
        for i in range(2):
            batch = {k: torch.as_tensor(v[i]) for k, v in staged.items()}
            total = total + TMD.loss_fn(params, tcfg, batch, adapters=ad,
                                        remat=False)[0] / 2
        total.backward()
    assert float(state["loss"]) == pytest.approx(float(total.detach()),
                                                 abs=1e-6)
    mean = tree_map(lambda a: a.grad, ad)
    for g_units, g in zip(tree_leaves(state["grads"]), tree_leaves(mean)):
        torch.testing.assert_close(g_units, 2 * g, atol=1e-6, rtol=1e-6)
    state = unit(state)
    assert state["iter"] == 1 and float(state["loss"]) == 0.0
    assert all(not g.any() for g in tree_leaves(state["grads"]))
    ad1, _ = topt.adamw_update(opt, mean, topt.adamw_init(ad0), ad0)
    for got, expect in zip(tree_leaves(state["adapters"]), tree_leaves(ad1)):
        torch.testing.assert_close(got, expect, atol=5e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_units():
    """The JAX unit engine through EMBED .. EMBED_BWD of one microbatch (no
    OPT), from an ft_state with B drawn, plus that initial state."""
    jcfg, _ = _cfgs()
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    pc = JP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        jcfg.vocab_size, 16, 2, seed=3)).batches(), 2).stacked()
    state0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1), staged)
    state0["adapters"] = _nonzero_b(state0["adapters"], 11)
    state0 = jax.tree.map(np.asarray, state0)
    unit = jax.jit(JP.make_unit_step(jcfg, pc, params))
    state = state0
    for _ in range(JP.n_units_per_mb(jcfg)):
        state = unit(state)
    return params, state0, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_matches_reference_units(jax_units, use_kernels):
    """The same ft_state carried across runs the same microbatch's units on
    both sides. Both compute in bf16 (the residual stream is bf16) and
    round at other places inside the ops, so the loss agrees to 1e-2
    relative and each accumulated grad to 8e-2 in relative Frobenius norm:
    bf16 noise of the size that separates the reference's own units from
    an f32 computation of the same gradient (2-4e-2 here). With
    use_kernels (the plain version on the CPU) the adapted projections
    round once instead of three times, within the same tolerance."""
    params_j, state0_j, state1_j = jax_units
    _, tcfg = _cfgs()
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    state = to_torch(state0_j)
    assert state["unit_idx"] == 0 and isinstance(state["iter"], int)
    before = K2.PLAIN_CALLS
    unit = TP.make_unit_step(tcfg, pc, to_torch(params_j),
                             use_kernels=use_kernels)
    state = TP.run_units(unit, state, TP.n_units_per_mb(tcfg))
    # 7 adapted projections per FWD unit, 7 forward + 7 dx per BWD unit
    assert K2.PLAIN_CALLS - before == (21 * tcfg.num_layers
                                       if use_kernels else 0)
    assert float(state["loss"]) == pytest.approx(float(state1_j["loss"]),
                                                 rel=1e-2)
    assert state["unit_idx"] == int(state1_j["unit_idx"])
    assert state["consumed"] == int(state1_j["consumed"]) == 1
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(state1_j["grads"])):
        assert _frob_err(_f32(got), expect) <= 8e-2
    # and the state crosses back: the same tree, the counters as int32
    back = to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(state1_j)
    assert back["unit_idx"].dtype == np.int32


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_ssm_family_matches_reference(use_kernels):
    """The unit engine runs a whole iteration of an SSM stack (the SSM
    config of test_peft.py::test_unit_engine_families) from the JAX units'
    ft_state (B drawn, so every adapter leaf gets a gradient): the
    microbatch's loss and accumulated grads agree with the JAX units' at
    the dense test's 1e-2 and 8e-2 (bf16 noise; measured 1.2e-2), then
    OPT brings iter to 1 with last_loss finite and equal to that loss.
    Training keeps the plain, differentiable scan with the kernels on (K3
    has no backward): no K3 or K2 call."""
    kw = dict(family="ssm", d_ff=0, ssm_state=16, ssm_headdim=16,
              ssm_chunk=4, num_kv_heads=4)
    jcfg, tcfg = _cfgs(**kw)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        jcfg.vocab_size, 12, 2, seed=3)).batches(), 2).stacked()
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=12, accum=1,
                         opt=jopt.AdamWConfig(lr=1e-3))
    state0 = JP.init_ft_state(jcfg, pc_j, params, jax.random.PRNGKey(1),
                              staged)
    state0["adapters"] = _nonzero_b(state0["adapters"], 11)
    state0 = jax.tree.map(np.asarray, state0)
    unit_j = jax.jit(JP.make_unit_step(jcfg, pc_j, params))
    state_j = state0
    for _ in range(JP.n_units_per_mb(jcfg)):
        state_j = unit_j(state_j)

    pc = TP.PeftConfig(micro_batch=2, seq_len=12, accum=1,
                       opt=topt.AdamWConfig(lr=1e-3))
    before = (K2.PLAIN_CALLS, K3.PLAIN_CALLS)
    unit = TP.make_unit_step(tcfg, pc, to_torch(params),
                             use_kernels=use_kernels)
    state = TP.run_units(unit, to_torch(state0), TP.n_units_per_mb(tcfg))
    assert (K2.PLAIN_CALLS, K3.PLAIN_CALLS) == before
    loss = float(state["loss"])
    assert loss == pytest.approx(float(state_j["loss"]), rel=1e-2)
    assert state["adapters"]["scan"].keys() == {"ssm_io"}
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(state_j["grads"])):
        assert _frob_err(_f32(got), expect) <= 8e-2
    state = unit(state)                                     # OPT
    assert state["iter"] == 1 and state["unit_idx"] == 0
    assert np.isfinite(float(state["last_loss"]))
    assert float(state["last_loss"]) == loss


def test_ft_state_round_trip_is_exact(jax_units):
    _, state0_j, _ = jax_units
    back = to_numpy(to_torch(state0_j))
    assert jax.tree.structure(back) == jax.tree.structure(state0_j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state0_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_loss_descends():
    opt = topt.AdamWConfig(lr=5e-3, warmup_steps=1)
    tcfg, params, pc, staged = _torch_setup(4, 1, opt)
    batch = {k: torch.as_tensor(v[0]) for k, v in staged.items()}
    step = TP.make_train_step(tcfg, pc.opt, remat=True)
    ad = TMD.init_adapters(tcfg, 0, device="cpu")
    st = topt.adamw_init(ad)
    losses = []
    for _ in range(8):
        ad, st, m = step(params, ad, st, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def _addresses(tree, path=""):
    """{path: data_ptr} of every tensor of a state tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_addresses(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_addresses(v, f"{path}/{i}"))
        return out
    return {path: tree.data_ptr()} if isinstance(tree, torch.Tensor) else {}


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m", "mixtral-8x7b"])
def test_ft_state_tensors_keep_their_addresses(arch):
    """Every tensor of `ft_state` (x, the residuals, the loss and last
    loss, the adapters, AdamW's m and v, the accumulated grads, the staged
    ring) keeps its address through a whole iteration of two microbatches
    and its OPT: the units write in place, which is what lets a CUDA graph
    captured on the state replay on it."""
    cfg = tconfigs.smoke_config(arch)
    params = TMD.init_params(cfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=2,
                       opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1))
    staged = tdata.Prefetcher(tdata.SyntheticCorpus(tdata.DataConfig(
        cfg.vocab_size, 16, 2, seed=2)).batches(), 2).stacked()
    state = TP.init_ft_state(cfg, pc, params, 0, staged)
    before = _addresses(state)
    assert {"/x", "/residuals", "/loss", "/last_loss"} <= set(before)
    adapters0 = tree_map(torch.clone, state["adapters"])
    unit = TP.make_unit_step(cfg, pc, params)
    for _ in range(TP.units_per_iteration(cfg, pc.accum)):
        state = unit(state)
        assert _addresses(state) == before
    assert state["iter"] == 1 and state["unit_idx"] == 0
    assert state["opt"]["t"] == 1 and state["consumed"] == 2
    assert float(state["last_loss"]) > 0 and float(state["loss"]) == 0.0
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(state["adapters"]), tree_leaves(adapters0)))


def test_unit_engine_loss_descends_with_kernels_switch():
    """Several iterations of units (use_kernels on: the plain version on
    the CPU) lower the loss on a repeated microbatch ring."""
    opt = topt.AdamWConfig(lr=5e-3, warmup_steps=1)
    tcfg, params, pc, staged = _torch_setup(4, 1, opt)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    losses = []
    for _ in range(6):
        state = _run_iteration(tcfg, params, pc, state, use_kernels=True)
        losses.append(float(state["last_loss"]))
    assert state["iter"] == 6 and state["consumed"] == 6
    assert min(losses[-2:]) < losses[0] - 0.05, losses
