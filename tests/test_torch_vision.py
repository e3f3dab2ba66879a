"""PyTorch port vs JAX reference, the vision-stub frontend (phi-3-vision):
F patch embeddings ahead of the tokens. `forward`, `loss_fn`, `prefill`
and `decode_step` against the JAX package on the smoke config (8 patches);
two faults of the reference and the port's repairs: its unit engine
cannot run a model with a frontend (EMBED writes F + S rows into
residuals sized S), while the port's units train on F + S rows and give
`loss_fn`'s CE; and its engine's decode feeds position prompt_len + 1,
inside the patches and the prompt, while the port's starts after them.
The engine's greedy tokens against the reference engine with its slot
insert and decode position repaired; the entry points on the CPU.
Weights come from the reference's init through interop; inputs are made
with numpy from a seed."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "phi-3-vision-4.2b"
B, S = 2, 24


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


def _frob_err(got, expect):
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    return np.linalg.norm(got - expect) / max(np.linalg.norm(expect), 1e-30)


def _nonzero_b(adapters_j, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                 * 0.05) if p[-1].key == "b" else x,
        adapters_j)


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    adapters = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 2)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(B, S)
                                    ).astype(np.int32),
             "frontend": rng.normal(size=(B, jcfg.frontend_tokens,
                                          jcfg.d_model)).astype(np.float32)}
    batch["labels"] = batch["tokens"]
    return jcfg, tcfg, params, adapters, batch


def _staged(cfg, seed):
    return jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        cfg.vocab_size, 16, 2, seed=seed, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model)).batches(), 2).stacked()


def test_forward_and_loss_fn_match_reference(f32_model):
    """The text rows' logits (the patches' dropped) and the loss, with
    adapters, against the reference."""
    jcfg, tcfg, params, adapters, batch = f32_model
    lg_j, _ = JMD.forward(params, jcfg, batch, adapters=adapters)
    loss_j, _ = JMD.loss_fn(params, jcfg, batch, adapters=adapters)
    pt, at, bt = to_torch(params), to_torch(adapters), to_torch(batch)
    lg_t, _ = TMD.forward(pt, tcfg, bt, adapters=at)
    loss_t, _ = TMD.loss_fn(pt, tcfg, bt, adapters=at)
    assert lg_t.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(_f32(lg_t), np.asarray(lg_j), atol=2e-4,
                               rtol=2e-4)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=2e-5)
    # the patches move the text rows: without them the logits differ
    lg_0, _ = TMD.forward(pt, tcfg, dict(bt, frontend=None), adapters=at)
    assert (lg_0 - lg_t).abs().max() > 1e-2


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(f32_model, use_kernels):
    """The prefill writes positions 0..F+S-1 (patches, then the prompt);
    the decode step at position F + S: logits and caches."""
    jcfg, tcfg, params, _, batch = f32_model
    F = jcfg.frontend_tokens
    pb = {"tokens": batch["tokens"], "frontend": batch["frontend"]}
    cache_j = JMD.init_cache(jcfg, B, 64, dtype=jnp.float32)
    lg_j, cache_j = JMD.prefill(params, jcfg, pb, cache_j)
    tok = np.array([3, 5], np.int32)
    pos = np.full((B,), F + S, np.int32)
    lg2_j, cache2_j = JMD.decode_step(params, jcfg, tok, pos, cache_j)
    pt = to_torch(params)
    cache = TMD.init_cache(tcfg, B, 64, dtype=torch.float32, device="cpu")
    lg, cache = TMD.prefill(pt, tcfg, to_torch(pb), cache,
                            use_kernels=use_kernels)
    np.testing.assert_allclose(_f32(lg), np.asarray(lg_j), atol=2e-4,
                               rtol=2e-4)
    assert (cache["scan"]["kv_pos"][:, :, :F + S] ==
            torch.arange(F + S, dtype=torch.int32)).all()
    lg2, cache = TMD.decode_step(pt, tcfg, torch.from_numpy(tok),
                                 torch.from_numpy(pos), cache,
                                 use_kernels=use_kernels)
    np.testing.assert_allclose(_f32(lg2), np.asarray(lg2_j), atol=2e-4,
                               rtol=2e-4)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(cache2_j)):
        np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32),
                                   atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------- training --
def test_reference_units_fail_at_embed_and_the_port_trains():
    """A fault of the reference, repaired: its EMBED writes the (B, F+S,
    d) front into residuals that `init_ft_state` sized (B, S, d), so its
    unit step cannot be traced for a model with a frontend. The port's
    units keep F + S rows, drop the patches before the loss, and give
    `loss_fn`'s CE bit for bit (bf16 weights); a whole iteration's OPT
    then steps every adapter."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    staged = _staged(jcfg, 2)
    assert staged["frontend"].shape == (2, 2, 8, jcfg.d_model)
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    state_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                               staged)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax.jit(JP.make_unit_step(jcfg, pc_j, params_j))(state_j)

    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    assert state["x"].shape == (2, 8 + 16, tcfg.d_model)
    assert state["residuals"].shape == (tcfg.num_layers + 1, 2, 24,
                                        tcfg.d_model)
    state["adapters"] = to_torch(_nonzero_b(to_numpy(state["adapters"]), 4))
    ad0 = tree_map(torch.clone, state["adapters"])
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, unit.upm)
    batch = {k: torch.as_tensor(v[0]) for k, v in staged.items()}
    with torch.no_grad():
        _, metrics = TMD.loss_fn(params, tcfg, batch, adapters=ad0,
                                 remat=False)
    assert float(state["loss"]) == float(metrics["ce"])
    state = unit(state)                                     # OPT
    assert state["iter"] == 1
    for got, before in zip(tree_leaves(state["adapters"]), tree_leaves(ad0)):
        assert not torch.equal(got, before)


def test_unit_grads_match_the_reference_loss_gradient(f32_model):
    """The units' accumulated grads (f32 weights) against `jax.grad` of
    the reference's `loss_fn` with the frontend, and their loss against
    its loss (the reference's units cannot run this model)."""
    jcfg, tcfg, params_j, adapters_j, _ = f32_model
    staged = _staged(jcfg, 5)
    batch_j = {k: jnp.asarray(v[0]) for k, v in staged.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda ad: JMD.loss_fn(params_j, jcfg, batch_j, adapters=ad)[0]
    )(adapters_j)
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    state["adapters"] = to_torch(adapters_j)
    unit = TP.make_unit_step(tcfg, pc, params)
    state = TP.run_units(unit, state, unit.upm)
    assert float(state["loss"]) == pytest.approx(float(loss_j), rel=1e-2)
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(grads_j)):
        assert _frob_err(_f32(got), expect) <= 8e-2


def test_init_ft_state_needs_the_staged_patches():
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        tcfg.vocab_size, 16, 2)).batches(), 2).stacked()
    with pytest.raises(ValueError, match="frontend"):
        TP.init_ft_state(tcfg, TP.PeftConfig(micro_batch=2, seq_len=16),
                         params, 0, staged)


# ------------------------------------------------------------- serving --
class _JEngineSlotFixed(JEngine):
    """The stacked caches' insert at [:, slot] (tests/
    test_torch_serving.py), and nothing else changed."""

    def _insert_slot_cache(self, slot, one_cache):
        self.cache = dict(self.cache, scan=jax.tree.map(
            lambda d, s: d.at[:, slot].set(s[:, 0]), self.cache["scan"],
            one_cache["scan"]))


class _JEngineRepaired(_JEngineSlotFixed):
    """The decode step fed at the token's own position: F + context_len -
    1, after the patches (the reference feeds context_len)."""

    def decode_round(self):
        F = self.cfg.frontend_tokens
        active = jnp.asarray([r is not None and r.phase.value == "decoding"
                              for r in self.slots], jnp.int32)
        jitted = self._decode
        self._decode = lambda p, t, pos, c: jitted(p, t, pos + (F - 1) *
                                                   active, c)
        try:
            return super().decode_round()
        finally:
            self._decode = jitted


def test_reference_decode_writes_inside_the_patches():
    """A fault of the reference, repaired: after a prefill of F = 8
    patches and a 4-token prompt (positions 0..11), its first decode
    writes position prompt_len + 1 = 5, a patch's slot, and attends only
    to positions 0..5; the port's writes position F + 4 = 12, the first
    free one, and its page table counts F + prompt_len tokens."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    F, P = jcfg.frontend_tokens, 4
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.arange(P, dtype=np.int32) + 3
    patches = np.random.default_rng(1).normal(size=(F, jcfg.d_model)
                                              ).astype(np.float32)
    ref = _JEngineSlotFixed(jcfg, params_j, max_slots=2, s_max=64)
    assert ref.try_admit(JRequest(rid=0, arrival=0.0, prompt_len=P,
                                  max_new_tokens=4), prompt,
                         {"frontend": patches})
    k_before = np.asarray(ref.cache["scan"]["k"][:, 0], np.float32)
    ref.decode_round()
    k_after = np.asarray(ref.cache["scan"]["k"][:, 0], np.float32)
    changed = np.nonzero((k_before != k_after).any(axis=(0, 2, 3)))[0]
    assert changed.tolist() == [P + 1] and P + 1 < F
    assert int(np.asarray(ref.cache["scan"]["kv_pos"][:, 0]).max()) == \
        F + P - 1

    eng = TEngine(tcfg, to_torch(params_j), max_slots=2, s_max=64,
                  device="cpu")
    assert eng.try_admit(TRequest(rid=0, arrival=0.0, prompt_len=P,
                                  max_new_tokens=4), prompt,
                         {"frontend": patches})
    assert eng.pages.lengths[0] == F + P
    k_before = eng.cache["scan"]["k"][:, 0].clone()
    eng.decode_round()
    changed = torch.nonzero((k_before != eng.cache["scan"]["k"][:, 0]
                             ).any(dim=(0, 2, 3)))[:, 0]
    assert changed.tolist() == [F + P]
    assert int(eng.cache["scan"]["kv_pos"][:, 0].max()) == F + P
    assert eng.pages.lengths[0] == F + P + 1


def _drive(eng, reqs):
    """run_trace's loop (the patches drawn after each prompt from the
    engine's rng, as the reference draws them), recording every request's
    greedy tokens."""
    toks = {r.rid: [] for r in reqs}
    qi = 0
    while True:
        while qi < len(reqs):
            r = reqs[qi]
            prompt = eng.rng.integers(0, eng.cfg.vocab_size,
                                      size=r.prompt_len, dtype=np.int32)
            if not eng.try_admit(r, prompt, eng._stub_extras(r)):
                break
            toks[r.rid].append(int(eng.last_token[r.slot]))
            qi += 1
        if not eng.active_requests() and qi >= len(reqs):
            return toks
        for rid, t in eng.decode_round().items():
            toks[rid].append(t)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_match_reference(use_kernels):
    """f32 weights, the engines' bf16 caches, 8 patches per request drawn
    from each engine's rng: the same greedy tokens as the reference engine
    with its insert and its decode position repaired."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def trace(R):
        return [R(rid=i, arrival=i * 0.01, prompt_len=8 + 3 * i,
                  max_new_tokens=6) for i in range(6)]
    expect = _drive(_JEngineRepaired(jcfg, params_j, max_slots=4, s_max=64,
                                     use_kernels=use_kernels), trace(JRequest))
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=64,
                  use_kernels=use_kernels, device="cpu")
    got = _drive(eng, trace(TRequest))
    assert got == expect
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0


def test_finishing_counts_the_patches():
    """A request whose patches, prompt and tokens fill s_max - 1 positions
    finishes there, as a text-only one does at prompt + tokens."""
    tcfg = tconfigs.smoke_config(ARCH)
    eng = TEngine(tcfg, TMD.init_params(tcfg, 0, device="cpu"), max_slots=1,
                  s_max=32, device="cpu")
    r = TRequest(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=100)
    assert eng.try_admit(r, np.zeros(16, np.int32), eng._stub_extras(r))
    while eng.active_requests():
        eng.decode_round()
    assert 8 + r.context_len == 31 and eng.pages.pages_in_use == 0


# ---------------------------------------------------------- entry points --
@pytest.mark.parametrize("extra", [[], ["--colocate"],
                                   ["--colocate", "--predictor",
                                    "costmodel"]],
                         ids=["serve", "colocate", "costmodel"])
def test_serve_entry_point_runs_the_vision_stub_on_cpu(extra):
    """`launch/serve.py --arch phi-3-vision-4.2b --smoke --device cpu
    --use-kernels [--colocate [--predictor costmodel]]`: 8 patches ahead
    of each prompt, K1's wrapper on every layer of every round; a 10 s
    target admits k_max units every round."""
    k1 = K1.PLAIN_CALLS
    if extra:
        extra = extra + ["--k-max", "2", "--qos-s", "10"]
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--use-kernels", "--requests", "3", "--slots", "2",
                    "--s-max", "64"] + extra)
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K1.PLAIN_CALLS - k1 >= m.decode_rounds
    assert m.ft_units == (2 * m.decode_rounds if extra else 0)


@pytest.mark.parametrize("units", [False, True])
def test_train_entry_point_runs_the_vision_stub_on_cpu(units):
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--use-kernels"] + (["--layer-units"] if units else []))
    assert out["opt"]["t"] == 2
    if units:
        assert out["x"].shape == (2, 8 + 16, 64)
