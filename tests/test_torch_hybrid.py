"""PyTorch port vs JAX reference, the hybrid RG-LRU family (recurrentgemma):
`forward`, `prefill` and `decode_step` on the smoke config at 3 layers
(one "rra" superblock) and at 5 (the superblock and 2 trailing RG-LRU
layers in "post", as the published 8 x 3 + 2 layout has), prompts past the
local window so that the attention rings wrap; greedy decode against the
teacher-forced forward; the engine's greedy tokens against the reference
engine with its slot insert and decode position repaired; the unit
engine's loss and grads (the post layers' adapters among them) against
the reference's units, and a co-located round against a decode step plus
k units; the adapters' targets, interop and checkpoints with post lists;
and the entry points on the CPU. Weights come from the reference's init
through interop; inputs are made with numpy from a seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.colocation import ColocatedRunner as JRunner  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.distributed import fault_tolerance as TFT  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "recurrentgemma-2b"
B, S = 2, 70                       # smoke local window 64: the rings wrap


def _cfgs(layers):
    return (dataclasses.replace(jconfigs.smoke_config(ARCH),
                                num_layers=layers),
            dataclasses.replace(tconfigs.smoke_config(ARCH),
                                num_layers=layers))


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


def _close_leaves(got, expect):
    """Cache leaves, f32 at 2e-4; the RG-LRU conv state is bf16 whatever
    the model's dtype (as in the reference), so a rounding of it may fall
    the other way: bf16's 3e-2."""
    leaves = tree_leaves(got)
    assert len(leaves) == len(jax.tree.leaves(expect))
    for a, b in zip(leaves, jax.tree.leaves(expect)):
        tol = 3e-2 if a.dtype == torch.bfloat16 else 2e-4
        np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32),
                                   atol=tol, rtol=tol)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


@pytest.fixture(scope="module", params=[3, 5], ids=["3 layers", "5 layers"])
def f32_model(request):
    """f32 weights and adapters (B drawn) of the reference at 3 or 5
    layers, and seeded tokens of S + 1 positions."""
    jcfg, tcfg = _cfgs(request.param)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    adapters = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 2)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return jcfg, tcfg, params, adapters, toks


def test_plan_and_trees_match_reference(f32_model):
    """The layout (superblocks, post layers), params, adapters and caches
    cross with `interop` one to one: the same tree, shapes and dtypes, the
    post lists included; the LoRA targets of an RG-LRU layer are gate/up/
    down and the parallel rg_io."""
    jcfg, tcfg, params, adapters, _ = f32_model
    assert TMD._plan(tcfg) == JMD._plan(jcfg)
    n_post = jcfg.num_layers - 3
    assert TMD._plan(tcfg)[3] == ["rglru"] * n_post
    for got, expect in ((TMD.init_params(tcfg, 0, device="cpu",
                                         dtype=torch.float32), params),
                        (TMD.init_adapters(tcfg, 0, device="cpu"), adapters),
                        (TMD.init_cache(tcfg, B, 96, device="cpu"),
                         JMD.init_cache(jcfg, B, 96))):
        back = to_numpy(got)
        assert jax.tree.structure(back) == jax.tree.structure(expect)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(expect)):
            assert a.shape == b.shape and a.dtype == b.dtype
    ad = TMD.init_adapters(tcfg, 0, device="cpu")
    assert ad["scan"]["sub0"].keys() == {"gate", "up", "down", "rg_io"}
    assert ad["scan"]["sub2"].keys() == {"q", "k", "v", "o", "gate", "up",
                                         "down"}
    assert len(ad["post"]) == n_post
    for a, b in zip(tree_leaves(to_torch(to_numpy(to_torch(params)))),
                    jax.tree.leaves(params)):
        assert np.asarray(to_numpy(a)).tobytes() == np.asarray(b).tobytes()


def test_forward_and_loss_fn_match_reference(f32_model):
    jcfg, tcfg, params, adapters, toks = f32_model
    batch = {"tokens": toks[:, :S], "labels": toks[:, :S]}
    lg_j, _ = JMD.forward(params, jcfg, batch, adapters=adapters)
    loss_j, _ = JMD.loss_fn(params, jcfg, batch, adapters=adapters)
    pt, at, bt = to_torch(params), to_torch(adapters), to_torch(batch)
    lg_t, _ = TMD.forward(pt, tcfg, bt, adapters=at)
    loss_t, _ = TMD.loss_fn(pt, tcfg, bt, adapters=at)
    np.testing.assert_allclose(_f32(lg_t), np.asarray(lg_j), atol=2e-4,
                               rtol=2e-4)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=2e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(f32_model, use_kernels):
    """A prefill of S tokens past the window and a decode step: logits and
    every cache leaf (RG-LRU h and conv, the attention ring), nested and
    post, against the reference (f32; the bf16 conv state at bf16's
    tolerance). With use_kernels the decode's local attention runs K1's
    wrapper (its plain version here) on the ring, once per superblock; the
    reference sends a windowed cache to its oracle."""
    jcfg, tcfg, params, _, toks = f32_model
    cache_j = JMD.init_cache(jcfg, B, 96, dtype=jnp.float32)
    lg_j, cache_j = JMD.prefill(params, jcfg, {"tokens": toks[:, :S]},
                                cache_j)
    pos = np.full((B,), S, np.int32)
    lg2_j, cache2_j = JMD.decode_step(params, jcfg, toks[:, S], pos, cache_j,
                                      use_kernels=use_kernels)
    pt = to_torch(params)
    cache = TMD.init_cache(tcfg, B, 96, dtype=torch.float32, device="cpu")
    lg, cache = TMD.prefill(pt, tcfg, {"tokens": torch.from_numpy(
        toks[:, :S])}, cache, use_kernels=use_kernels)
    np.testing.assert_allclose(_f32(lg), np.asarray(lg_j), atol=2e-4,
                               rtol=2e-4)
    _close_leaves(cache, cache_j)
    before = K1.PLAIN_CALLS
    lg2, cache = TMD.decode_step(pt, tcfg, torch.from_numpy(toks[:, S]),
                                 torch.from_numpy(pos), cache,
                                 use_kernels=use_kernels)
    assert K1.PLAIN_CALLS - before == (1 if use_kernels else 0)
    np.testing.assert_allclose(_f32(lg2), np.asarray(lg2_j), atol=2e-4,
                               rtol=2e-4)
    _close_leaves(cache, cache2_j)


def test_decode_consistency(f32_model):
    """As `tests/test_attention.py::test_decode_consistency_hybrid`: a
    prefill of half the tokens, then the rest fed one decode step at a
    time, give the teacher-forced forward's logits (f32 weights; the conv
    state is bf16, as in the reference, hence 3e-2), past the window."""
    _, tcfg, params, _, toks = f32_model
    pt = to_torch(params)
    full, _ = TMD.forward(pt, tcfg, {"tokens": torch.from_numpy(toks)})
    half = 40
    cache = TMD.init_cache(tcfg, B, 96, dtype=torch.float32, device="cpu")
    lg, cache = TMD.prefill(pt, tcfg, {"tokens": torch.from_numpy(
        toks[:, :half])}, cache)
    rows = [lg]
    for t in range(half, S):
        lg, cache = TMD.decode_step(pt, tcfg, torch.from_numpy(toks[:, t]),
                                    torch.full((B,), t, dtype=torch.int32),
                                    cache, use_kernels=True)
        rows.append(lg)
    torch.testing.assert_close(torch.stack(rows, dim=1),
                               full[:, half - 1:S], atol=3e-2, rtol=3e-2)


# ------------------------------------------------------------- serving --
class _JEngineRepaired(JEngine):
    """The reference engine with its two serving faults repaired, as in
    tests/test_torch_serving.py: the stacked caches' insert at [:, slot]
    ("pre" and "post" caches, which have no layer axis, at [slot]) and the
    decode step fed at `context_len - 1`."""

    def _insert_slot_cache(self, slot, one_cache):
        def put(d, s):
            return d.at[slot].set(s[0])
        self.cache = dict(
            self.cache,
            pre=jax.tree.map(put, self.cache["pre"], one_cache["pre"]),
            post=jax.tree.map(put, self.cache["post"], one_cache["post"]),
            scan=jax.tree.map(lambda d, s: d.at[:, slot].set(s[:, 0]),
                              self.cache["scan"], one_cache["scan"]))

    def decode_round(self):
        active = jnp.asarray([r is not None and r.phase.value == "decoding"
                              for r in self.slots], jnp.int32)
        jitted = self._decode
        self._decode = lambda p, t, pos, c: jitted(p, t, pos - active, c)
        try:
            return super().decode_round()
        finally:
            self._decode = jitted


def _drive(eng, reqs):
    """run_trace's loop, recording every request's greedy tokens."""
    toks = {r.rid: [] for r in reqs}
    qi = 0
    while True:
        while qi < len(reqs):
            r = reqs[qi]
            prompt = eng.rng.integers(0, eng.cfg.vocab_size,
                                      size=r.prompt_len, dtype=np.int32)
            if not eng.try_admit(r, prompt):
                break
            toks[r.rid].append(int(eng.last_token[r.slot]))
            qi += 1
        if not eng.active_requests() and qi >= len(reqs):
            return toks
        for rid, t in eng.decode_round().items():
            toks[rid].append(t)


def _trace(R):
    return [R(rid=i, arrival=i * 0.01, prompt_len=n, max_new_tokens=6)
            for i, n in enumerate((8, 30, 66, 70, 2, 61))]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_match_reference(use_kernels):
    """5 layers (post caches inserted at [slot]), f32 weights, the engines'
    bf16 caches, prompts from 2 tokens (shorter than the conv state) to
    past the window: the same greedy tokens as the repaired reference."""
    jcfg, tcfg = _cfgs(5)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    expect = _drive(_JEngineRepaired(jcfg, params_j, max_slots=4, s_max=96,
                                     use_kernels=use_kernels),
                    _trace(JRequest))
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=96,
                  use_kernels=use_kernels, device="cpu")
    assert eng.cache["post"][0]["h"].shape == (4, tcfg.d_model)
    assert eng.cache["scan"]["sub2"]["k"].shape[2] == tcfg.local_window
    before = K1.PLAIN_CALLS
    got = _drive(eng, _trace(TRequest))
    assert got == expect
    assert K1.PLAIN_CALLS - before == \
        (eng.metrics.decode_rounds if use_kernels else 0)
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0


def test_slot_insert_reaches_nested_and_post_caches():
    """A request admitted into slot 1 finds its prefilled cache there in
    every leaf, the superblock's nested ones at [:, 1] and the post
    layers' at [1]; slot 2 stays empty."""
    _, tcfg = _cfgs(5)
    params = TMD.init_params(tcfg, 0, device="cpu")
    eng = TEngine(tcfg, params, max_slots=3, s_max=96, device="cpu")
    prompt = np.arange(20, dtype=np.int32) * 7 % tcfg.vocab_size
    for rid in range(2):
        assert eng.try_admit(TRequest(rid=rid, arrival=0.0, prompt_len=20,
                                      max_new_tokens=4), prompt)
    direct = TMD.init_cache(tcfg, 1, 96, device="cpu")
    TMD.prefill(params, tcfg, {"tokens": torch.from_numpy(prompt[None])},
                direct)
    for a, b in zip(tree_leaves(eng.cache["scan"]),
                    tree_leaves(direct["scan"])):
        assert torch.equal(a[:, 1], b[:, 0])
    for a, b in zip(tree_leaves(eng.cache["post"]),
                    tree_leaves(direct["post"])):
        assert torch.equal(a[1], b[0])
        assert not a[2].any()
    assert torch.all(eng.cache["scan"]["sub2"]["kv_pos"][:, 2] == -1)


# ------------------------------------------------------------- training --
def _staged(cfg, seed):
    return jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        cfg.vocab_size, 32, 2, seed=seed)).batches(), 2).stacked()


@pytest.fixture(scope="module")
def jax_units():
    """The reference's units over one microbatch and its OPT, at 5 layers
    (bf16 weights, adapters with B drawn)."""
    jcfg, _ = _cfgs(5)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    pc = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    state0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1),
                              _staged(jcfg, 3))
    state0["adapters"] = _nonzero_b(state0["adapters"], 11)
    state0 = jax.tree.map(np.asarray, state0)
    unit = jax.jit(JP.make_unit_step(jcfg, pc, params))
    state = state0
    for _ in range(JP.n_units_per_mb(jcfg)):
        state = unit(state)
    after_opt = jax.tree.map(np.asarray, unit(state))
    return params, state0, jax.tree.map(np.asarray, state), after_opt


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_matches_reference_units(jax_units, use_kernels):
    """From the reference's ft_state: a microbatch's units (EMBED, FWD and
    BWD of the superblock, HEAD with the 2 post layers) give its loss and
    accumulated grads, the post adapters' among them (HEAD's); K2's
    wrapper takes every adapted projection (FWD 13 = 2 x 3 + 7, BWD 26,
    HEAD 2 x 2 x 3; never rg_io); OPT moves the adapters as the
    reference's does."""
    params, state0, state_j, opt_j = jax_units
    _, tcfg = _cfgs(5)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    unit = TP.make_unit_step(tcfg, pc, to_torch(params),
                             use_kernels=use_kernels)
    assert [unit.kind(u) for u in range(unit.upm)] == \
        ["EMBED", "FWD", "HEAD", "BWD", "EMBED_BWD"]
    before = K2.PLAIN_CALLS
    state = TP.run_units(unit, to_torch(state0), unit.upm)
    assert K2.PLAIN_CALLS - before == (13 + 26 + 12 if use_kernels else 0)
    assert float(state["loss"]) == pytest.approx(float(state_j["loss"]),
                                                 rel=1e-2)
    assert len(state["grads"]["post"]) == 2
    assert all(g.any() for g in tree_leaves(state["grads"]["post"]))
    for got, expect in zip(tree_leaves(state["grads"]),
                           jax.tree.leaves(state_j["grads"])):
        assert _frob_err(_f32(got), expect) <= 8e-2
    state = unit(state)                                     # OPT
    assert state["iter"] == 1 and state["opt"]["t"] == 1
    for got, before, expect in zip(tree_leaves(state["adapters"]),
                                   jax.tree.leaves(state0["adapters"]),
                                   jax.tree.leaves(opt_j["adapters"])):
        step = np.abs(_f32(got) - before).max()
        assert step > 0
        assert np.abs(_f32(got) - np.asarray(expect)).max() <= 2 * step + 1e-7


def test_units_loss_equals_loss_fn_ce():
    """The units' microbatch loss is `loss_fn`'s CE bit for bit (bf16
    weights, no kernels), post layers and all."""
    _, tcfg = _cfgs(5)
    params = TMD.init_params(tcfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    staged = _staged(tcfg, 4)
    state = TP.init_ft_state(tcfg, pc, params, 0, staged)
    ad0 = _clone(state["adapters"])
    state = TP.run_units(TP.make_unit_step(tcfg, pc, params), state,
                         TP.n_units_per_mb(tcfg))
    with torch.no_grad():
        _, metrics = TMD.loss_fn(params, tcfg, {k: torch.as_tensor(v[0])
                                                for k, v in staged.items()},
                                 adapters=ad0, remat=False)
    assert float(state["loss"]) == float(metrics["ce"])


@pytest.fixture(scope="module")
def jax_round():
    """The reference runner's round of k = 4 units (EMBED, FWD, HEAD, BWD)
    on the 5-layer hybrid: f32 weights and cache, its 3 slots prefilled
    past the window, and a ft_state with B drawn."""
    jcfg, _ = _cfgs(5)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pc = JP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    ft0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1),
                           _staged(jcfg, 5))
    ft0["adapters"] = _nonzero_b(ft0["adapters"], 7)
    ft0 = jax.tree.map(np.asarray, ft0)
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(3, 70)).astype(np.int32)
    _, cache0 = JMD.prefill(params, jcfg, {"tokens": jnp.asarray(prompts)},
                            JMD.init_cache(jcfg, 3, 96, dtype=jnp.float32))
    cache0 = jax.tree.map(np.asarray, cache0)
    tok = np.array([1, 2, 3], np.int32)
    pos = np.full((3,), 70, np.int32)
    runner = JRunner(jcfg, params, jcfg, params, pc, k_max=4, donate=False)
    out = jax.tree.map(np.asarray, runner.run_round(4, tok, pos, cache0, ft0))
    return params, ft0, cache0, tok, pos, out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_colocated_round_equals_decode_plus_units(jax_round, use_kernels):
    """The port's round of k = 4 units on the reference's state equals a
    decode step then 4 units bit for bit (the CPU's eager rounds; the
    post layers' adapter grads from HEAD among them), and meets the
    reference runner's round: f32 decode logits and caches at 2e-4 (the
    bf16 conv state at bf16's tolerance), the units' bf16 stream (loss,
    HEAD's dx carried through BWD) at bf16 noise."""
    params_j, ft0_j, cache0_j, tok, pos, (lg_j, cache_j, ft_j) = jax_round
    _, tcfg = _cfgs(5)
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=32, accum=1)
    ft0, cache0 = to_torch(ft0_j), to_torch(cache0_j)
    tok_t, pos_t = torch.from_numpy(tok), torch.from_numpy(pos)
    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=4,
                               use_kernels=use_kernels)
    lg_f, cache_f, ft_f = runner.run_round(4, tok_t, pos_t, _clone(cache0),
                                           _clone(ft0))
    lg_s, cache_s = TMD.decode_step(params, tcfg, tok_t, pos_t,
                                    _clone(cache0), use_kernels=use_kernels)
    ft_s = TP.run_units(TP.make_unit_step(tcfg, pc, params,
                                          use_kernels=use_kernels),
                        _clone(ft0), 4)
    assert torch.equal(lg_f, lg_s)
    for a, b in zip(tree_leaves(cache_f), tree_leaves(cache_s)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ft_f), tree_leaves(ft_s)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert ft_f["unit_idx"] == 4 and ft_f["grads"]["post"][0]["up"]["b"].any()

    np.testing.assert_allclose(_f32(lg_f), lg_j, atol=2e-4, rtol=2e-4)
    _close_leaves(cache_f, cache_j)
    assert float(ft_f["loss"]) == pytest.approx(float(ft_j["loss"]),
                                                rel=1e-2)
    for got, expect in ((ft_f["x"], ft_j["x"]),
                        (ft_f["grads"]["post"], ft_j["grads"]["post"])):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(expect)):
            assert _frob_err(_f32(a), b) <= 8e-2


def test_checkpoint_with_post_adapters_crosses_both_ways(tmp_path):
    """Adapters and AdamW state with post lists, saved by either manager,
    restore in the other bit for bit (bf16 base weights too)."""
    jcfg, tcfg = _cfgs(5)
    tree_j = {"adapters": _nonzero_b(JMD.init_adapters(
        jcfg, jax.random.PRNGKey(1)), 3),
        "post_weights": JMD.init_params(jcfg, jax.random.PRNGKey(0))["post"]}
    tree_t = to_torch(tree_j)
    JFT.CheckpointManager(tmp_path / "j").save(7, tree_j)
    TFT.CheckpointManager(tmp_path / "t").save(7, tree_t)
    zeros_t = tree_map(torch.zeros_like, tree_t)
    got_t = TFT.CheckpointManager(tmp_path / "j").restore(zeros_t)
    got_j = JFT.CheckpointManager(tmp_path / "t").restore(
        jax.tree.map(jnp.zeros_like, tree_j))
    assert len(got_t["adapters"]["post"]) == 2
    for a, b in zip(tree_leaves(got_t), jax.tree.leaves(tree_j)):
        assert np.asarray(to_numpy(a)).tobytes() == np.asarray(b).tobytes()
    for a, b in zip(jax.tree.leaves(got_j), jax.tree.leaves(tree_j)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------- entry points --
@pytest.mark.parametrize("extra", [[], ["--colocate"],
                                   ["--colocate", "--predictor",
                                    "costmodel"]],
                         ids=["serve", "colocate", "costmodel"])
def test_serve_entry_point_runs_the_hybrid_on_cpu(extra):
    """`launch/serve.py --arch recurrentgemma-2b --smoke --device cpu
    --use-kernels [--colocate [--predictor costmodel]]`: s_max 96 against
    the smoke window of 64, so the rings wrap; K1's wrapper once per
    superblock per round; a 10 s target admits k_max units every
    round."""
    k1 = K1.PLAIN_CALLS
    if extra:
        extra = extra + ["--k-max", "2", "--qos-s", "10"]
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--use-kernels", "--requests", "3", "--slots", "2",
                    "--s-max", "96"] + extra)
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K1.PLAIN_CALLS - k1 >= m.decode_rounds
    assert m.ft_units == (2 * m.decode_rounds if extra else 0)


@pytest.mark.parametrize("units", [False, True])
def test_train_entry_point_runs_the_hybrid_on_cpu(units):
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--use-kernels"] + (["--layer-units"] if units else []))
    assert out["opt"]["t"] == 2
    assert np.isfinite(float(out["last_loss"])) if units else True
