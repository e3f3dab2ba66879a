"""PyTorch port vs JAX reference, the encoder-decoder family
(seamless-m4t-large-v2): the soft-capped flash attention, the
bidirectional encoder over stub frames, "dec" layers with cross-attention
whose K/V the prefill caches, `forward`, `loss_fn` and its adapter
gradients, prefill and decode (with and without K1's wrapper), the unit
engine (EMBED runs the encoder), the engine's greedy tokens and the entry
points, on the smoke config (2 encoder and 2 decoder layers, d 64).
Weights come from the reference's init through interop; inputs are made
with numpy from a seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S, SE = 2, 12, 6          # batch, decoder tokens, encoder frames


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


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


@pytest.fixture(scope="module")
def f32_model():
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    adapters = _nonzero_b(JMD.init_adapters(jcfg, jax.random.PRNGKey(1)), 2)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(B, S)
                                    ).astype(np.int32),
             "enc_frames": rng.normal(size=(B, SE, jcfg.d_model)
                                      ).astype(np.float32)}
    batch["labels"] = batch["tokens"]
    return jcfg, tcfg, params, adapters, batch


def _shapes(tree):
    """{path: (shape, dtype name)} of a tree's leaves, either package."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            a = to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)
            out[path] = (a.shape, str(a.dtype))
    walk(tree, ())
    return out


# ------------------------------------------------------------ structure --
@pytest.mark.parametrize("kv_quant", [False, True])
def test_plan_and_trees_match_reference(kv_quant):
    """The plan ("dec" x 2), the params (the encoder stack and its final
    norm, each "dec" layer's lnx and xattn), the adapters (a "dec" layer's
    are an "attn" layer's: none on the encoder or the cross-attention) and
    the cache ({"self", "xk", "xv"}, the self cache bf16 under kv_quant)
    have the reference's leaves, shapes and dtypes."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), kv_quant=kv_quant)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), kv_quant=kv_quant)
    assert TMD._plan(tcfg) == JMD._plan(jcfg) == ([], "dec", 2, [])
    pairs = [(TMD.init_params(tcfg, 0, device="cpu"),
              JMD.init_params(jcfg, jax.random.PRNGKey(0))),
             (TMD.init_adapters(tcfg, 0, device="cpu"),
              JMD.init_adapters(jcfg, jax.random.PRNGKey(1))),
             (TMD.init_cache(tcfg, 3, 32, enc_len=5, device="cpu"),
              JMD.init_cache(jcfg, 3, 32, enc_len=5))]
    for got, expect in pairs:
        assert _shapes(got) == _shapes(expect)
    params, adapters, cache = (p[0] for p in pairs)
    assert params["enc"]["scan"]["attn"]["wq"].shape[0] == tcfg.enc_layers
    assert "xattn" not in adapters["scan"] and "enc" not in adapters
    assert cache["scan"]["xk"].shape == (2, 3, 5, 4, 16)
    assert cache["scan"]["self"]["k"].dtype == torch.bfloat16
    assert "k_scale" not in cache["scan"]["self"]


# ------------------------------------------------------------- layers --
@pytest.mark.parametrize("causal", [True, False], ids=["causal",
                                                       "bidirectional"])
@pytest.mark.parametrize("cap", [30.0, 2.0])
def test_soft_capped_flash_attention_matches_attention_ref(causal, cap):
    """`flash_attention(soft_cap=...)` (cap * tanh(s / cap) after the
    scale, before the mask) against the reference's dense oracle, at
    `tests/test_attention.py`'s soft-cap shape, in chunks smaller than
    the sequence, f32 2e-5; a cap of 2 bends most scores."""
    rng = np.random.default_rng(int(cap) + causal)
    q, k, v = (rng.normal(size=(2, 24, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    expect = JL.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, soft_cap=cap)
    got = TL.flash_attention(*to_torch([q, k, v]), causal=causal,
                             soft_cap=cap, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(_f32(got), np.asarray(expect), atol=2e-5,
                               rtol=2e-5)
    plain = TL.flash_attention(*to_torch([q, k, v]), causal=causal)
    assert (plain - got).abs().max() > 1e-2


def test_encode_matches_reference(f32_model):
    """The bidirectional encoder with its final norm over the stub frames,
    f32 2e-4; it builds no autograd graph."""
    jcfg, tcfg, params, _, batch = f32_model
    expect = JMD._encode(params, jcfg, batch)
    pt = to_torch(params)
    with torch.enable_grad():
        got = TMD._encode(pt, tcfg, to_torch(batch))
    assert got.shape == (B, SE, tcfg.d_model) and got.grad_fn is None
    np.testing.assert_allclose(_f32(got), np.asarray(expect), atol=2e-4,
                               rtol=2e-4)


def test_cross_attention_of_an_idle_slot_is_zero():
    """A slot no request has used keeps the cache's zero cross K/V: its
    cross-attention gives 0, not NaN (uniform weights over zero values),
    as the reference's flash attention does on the same cache."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    h = np.random.default_rng(3).normal(size=(2, 1, 64)).astype(np.float32)
    lp_j = jax.tree.map(lambda t: t[0], params_j["scan"]["xattn"])
    cache_j = jax.tree.map(lambda t: t[0],
                           JMD.init_cache(jcfg, 2, 16, enc_len=4,
                                          dtype=jnp.float32)["scan"])
    expect, _, _ = JMD._cross_attention(lp_j, jnp.asarray(h), jcfg,
                                        "decode", cache_j, None)
    cache_t = tree_map(lambda t: t[0], TMD.init_cache(
        tcfg, 2, 16, enc_len=4, dtype=torch.float32, device="cpu")["scan"])
    got = TMD._cross_attention(to_torch(lp_j), torch.from_numpy(h), tcfg,
                               cache_t, None)
    assert torch.isfinite(got).all() and not got.any()
    np.testing.assert_array_equal(_f32(got), np.asarray(expect))


# --------------------------------------------------------- full forward --
def test_forward_and_loss_fn_match_reference(f32_model):
    """Logits and the loss with adapters, f32 2e-4; the frames move the
    logits."""
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
    lg_0, _ = TMD.forward(pt, tcfg, dict(bt, enc_frames=bt["enc_frames"]
                                         * 2), adapters=at)
    assert (lg_0 - lg_t).abs().max() > 1e-2


def test_train_step_gradients_match_reference(f32_model):
    """`make_train_step`'s step (remat, f32 weights): its AdamW moments
    hold (1 - b1) g and (1 - b2) g^2 of the adapters' gradients, held
    against the reference's step at f32 2e-4 relative to each leaf's
    largest entry; the adapters it returns as well."""
    jcfg, tcfg, params, adapters, batch = f32_model
    cfg_o = jopt.AdamWConfig()
    ad_j, opt_j, m_j = JP.make_train_step(jcfg, cfg_o)(
        params, adapters, jopt.adamw_init(adapters), batch)
    at = to_torch(adapters)
    ad_t, opt_t, m_t = TP.make_train_step(tcfg, topt.AdamWConfig())(
        to_torch(params), at, topt.adamw_init(at), to_torch(batch))
    assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]), rel=2e-5)
    for got, expect in zip(tree_leaves([opt_t["m"], ad_t]),
                           jax.tree.leaves([opt_j["m"], ad_j])):
        expect = np.asarray(expect)
        np.testing.assert_allclose(_f32(got), expect, rtol=2e-4,
                                   atol=2e-4 * np.abs(expect).max())
    assert all(g.any() for g in tree_leaves(opt_t["m"]))


# --------------------------------------------------------------- serving --
@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_match_reference(f32_model, use_kernels):
    """Prefill's last logits and every cache leaf (the cross K/V of the
    encoder output included), then two decode steps that read the cached
    xk/xv and never encode: logits and caches, f32 2e-4. With the wrapper
    on, K1's plain version takes every layer's self-attention."""
    jcfg, tcfg, params, _, batch = f32_model
    pb = {"tokens": batch["tokens"], "enc_frames": batch["enc_frames"]}
    cache_j = JMD.init_cache(jcfg, B, 32, enc_len=SE, dtype=jnp.float32)
    lg_j, cache_j = JMD.prefill(params, jcfg, pb, cache_j)
    pt = to_torch(params)
    cache = TMD.init_cache(tcfg, B, 32, enc_len=SE, dtype=torch.float32,
                           device="cpu")
    lg, cache = TMD.prefill(pt, tcfg, to_torch(pb), cache,
                            use_kernels=use_kernels)
    np.testing.assert_allclose(_f32(lg), np.asarray(lg_j), atol=2e-4,
                               rtol=2e-4)
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(cache_j)):
        np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32),
                                   atol=2e-4, rtol=2e-4)
    assert cache["scan"]["xk"].abs().amax() > 0
    for step, tok in enumerate(([3, 5], [7, 1])):
        tok = np.array(tok, np.int32)
        pos = np.full((B,), S + step, np.int32)
        lg_j, cache_j = JMD.decode_step(params, jcfg, tok, pos, cache_j)
        before = K1.PLAIN_CALLS
        lg, cache = TMD.decode_step(pt, tcfg, torch.from_numpy(tok),
                                    torch.from_numpy(pos), cache,
                                    use_kernels=use_kernels)
        assert K1.PLAIN_CALLS - before == (tcfg.num_layers if use_kernels
                                           else 0)
        np.testing.assert_allclose(_f32(lg), np.asarray(lg_j), atol=2e-4,
                                   rtol=2e-4)
        for a, b in zip(tree_leaves(cache), jax.tree.leaves(cache_j)):
            np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32),
                                       atol=2e-4, rtol=2e-4)


def test_prefill_needs_the_cache_s_frame_count(f32_model):
    """The cross K/V are sized by `init_cache`'s enc_len (the engine's):
    a prefill with another number of frames raises, where a silent
    broadcast would write wrong K/V."""
    _, tcfg, params, _, batch = f32_model
    cache = TMD.init_cache(tcfg, B, 32, enc_len=SE + 1, dtype=torch.float32,
                           device="cpu")
    with pytest.raises(ValueError, match="encoder frames"):
        TMD.prefill(to_torch(params), tcfg, to_torch(
            {"tokens": batch["tokens"], "enc_frames": batch["enc_frames"]}),
            cache)


class _JEngineRepaired(JEngine):
    """The reference engine with its two serving faults repaired
    (tests/test_torch_serving.py): the stacked caches' slot insert at
    [:, slot] and the decode fed at context_len - 1."""

    def _insert_slot_cache(self, slot, one_cache):
        self.cache = dict(self.cache, scan=jax.tree.map(
            lambda d, s: d.at[:, slot].set(s[:, 0]), self.cache["scan"],
            one_cache["scan"]))

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
    """run_trace's loop (the frames drawn after each prompt from the
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
    """f32 weights, the engines' bf16 caches, 5 stub frames per request
    drawn from each engine's rng: the same greedy tokens as the repaired
    reference engine; K1's wrapper on every layer of every round."""
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def trace(R):
        return [R(rid=i, arrival=i * 0.01, prompt_len=4 + 3 * i,
                  max_new_tokens=5) for i in range(6)]
    expect = _drive(_JEngineRepaired(jcfg, params_j, max_slots=4, s_max=48,
                                     enc_len=5, use_kernels=use_kernels),
                    trace(JRequest))
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=48, enc_len=5,
                  use_kernels=use_kernels, device="cpu")
    before = K1.PLAIN_CALLS
    got = _drive(eng, trace(TRequest))
    assert got == expect
    assert K1.PLAIN_CALLS - before == \
        (tcfg.num_layers * eng.metrics.decode_rounds if use_kernels else 0)
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0


def test_engine_frames_and_page_accounting():
    """The engine needs enc_len >= 1 for an encoder-decoder model; every
    request draws enc_len frames; the cross K/V (slots x enc_len) are not
    in the page accounting, whose pages are those of the self caches
    alone, as in the reference."""
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="enc_len"):
        TEngine(tcfg, params, device="cpu")
    eng = TEngine(tcfg, params, max_slots=2, s_max=32, enc_len=7,
                  device="cpu")
    r = TRequest(rid=0, arrival=0.0, prompt_len=5, max_new_tokens=2)
    assert eng._stub_extras(r)["enc_frames"].shape == (7, tcfg.d_model)
    ref = JEngine(jconfigs.smoke_config(ARCH), JMD.init_params(
        jconfigs.smoke_config(ARCH), jax.random.PRNGKey(0)), max_slots=2,
        s_max=32, enc_len=7)
    fields = ("n_layers", "num_pages", "page_tokens", "kv_heads", "head_dim")
    assert [getattr(eng.pages.spec, f) for f in fields] == \
        [getattr(ref.pages.spec, f) for f in fields] == \
        [tcfg.num_layers, 2 * 2, 16, 4, 16]
    assert eng.try_admit(r, np.arange(5, dtype=np.int32),
                         eng._stub_extras(r))
    assert eng.pages.lengths[0] == 5


# ------------------------------------------------------------- training --
def _staged(cfg, seed):
    return jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        cfg.vocab_size, 16, 2, seed=seed, enc_frames=8,
        d_model=cfg.d_model)).batches(), 2).stacked()


@pytest.fixture(scope="module")
def jax_units():
    """The reference's units over one microbatch (EMBED runs the
    encoder) and its OPT: bf16 weights, adapters with B drawn."""
    jcfg = jconfigs.smoke_config(ARCH)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    pc = JP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    state0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1),
                              _staged(jcfg, 3))
    state0["adapters"] = _nonzero_b(state0["adapters"], 11)
    state0 = jax.tree.map(np.asarray, state0)
    unit = jax.jit(JP.make_unit_step(jcfg, pc, params))
    state = unit(state0)
    after_embed = jax.tree.map(np.asarray, state)
    for _ in range(JP.n_units_per_mb(jcfg) - 1):
        state = unit(state)
    after_opt = jax.tree.map(np.asarray, unit(state))
    return params, state0, after_embed, jax.tree.map(np.asarray, state), \
        after_opt


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unit_engine_matches_reference_units(jax_units, use_kernels):
    """From the reference's ft_state: EMBED's encoder output at bf16
    2e-2; the microbatch's units give its loss and accumulated grads
    (bf16 noise, as in tests/test_torch_training.py); K2's wrapper takes
    every adapted projection (FWD 7, BWD 14 per layer; none in EMBED: the
    encoder has no adapter); OPT moves the adapters as the reference's
    does."""
    params, state0, embed_j, state_j, opt_j = jax_units
    tcfg = tconfigs.smoke_config(ARCH)
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    unit = TP.make_unit_step(tcfg, pc, to_torch(params),
                             use_kernels=use_kernels)
    assert [unit.kind(u) for u in range(unit.upm)] == \
        ["EMBED", "FWD", "FWD", "HEAD", "BWD", "BWD", "EMBED_BWD"]
    state = to_torch(state0)
    assert state["enc_out"].shape == (2, 8, tcfg.d_model)
    before = K2.PLAIN_CALLS
    state = unit(state)
    assert K2.PLAIN_CALLS == before
    np.testing.assert_allclose(_f32(state["enc_out"]),
                               _f32(to_torch(embed_j["enc_out"])),
                               atol=2e-2, rtol=2e-2)
    state = TP.run_units(unit, state, unit.upm - 1)
    assert K2.PLAIN_CALLS - before == (2 * (7 + 14) if use_kernels else 0)
    assert float(state["loss"]) == pytest.approx(float(state_j["loss"]),
                                                 rel=1e-2)
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


def test_units_loss_equals_loss_fn_ce_and_grads_skip_the_encoder():
    """The units' microbatch loss is `loss_fn`'s CE bit for bit (bf16
    weights, no kernels), and no unit leaves a gradient on the encoder's
    output or weights."""
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
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
    assert not state["enc_out"].requires_grad
    assert all(t.grad is None for t in tree_leaves(params["enc"]))


def test_init_ft_state_needs_the_staged_frames():
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        tcfg.vocab_size, 16, 2)).batches(), 2).stacked()
    with pytest.raises(ValueError, match="enc_frames"):
        TP.init_ft_state(tcfg, TP.PeftConfig(micro_batch=2, seq_len=16),
                         params, 0, staged)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_colocated_round_equals_decode_plus_units(use_kernels):
    """A co-located round of k = 3 units (EMBED with the encoder, then two
    FWD) on the CPU equals a decode step then 3 separate units, bit for
    bit: logits, caches (cross K/V included) and finetune state."""
    tcfg = tconfigs.smoke_config(ARCH)
    params = TMD.init_params(tcfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    ft0 = TP.init_ft_state(tcfg, pc, params, 1, _staged(tcfg, 5))
    rng = np.random.default_rng(6)
    cache0 = TMD.init_cache(tcfg, 3, 48, enc_len=4, device="cpu")
    TMD.prefill(params, tcfg, {
        "tokens": torch.from_numpy(rng.integers(0, 256, size=(3, 20))),
        "enc_frames": torch.from_numpy(rng.normal(size=(3, 4, 64)))}, cache0)
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    pos = torch.full((3,), 20, dtype=torch.int32)
    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=3,
                               use_kernels=use_kernels)
    lg_f, cache_f, ft_f = runner.run_round(3, tok, pos, _clone(cache0),
                                           _clone(ft0))
    lg_s, cache_s = TMD.decode_step(params, tcfg, tok, pos, _clone(cache0),
                                    use_kernels=use_kernels)
    ft_s = TP.run_units(TP.make_unit_step(tcfg, pc, params,
                                          use_kernels=use_kernels),
                        _clone(ft0), 3)
    assert torch.equal(lg_f, lg_s)
    for a, b in zip(tree_leaves([cache_f, ft_f]), tree_leaves([cache_s,
                                                               ft_s])):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert ft_f["unit_idx"] == 3 and ft_f["enc_out"].any()


# ---------------------------------------------------------- entry points --
@pytest.mark.parametrize("extra", [[], ["--colocate"],
                                   ["--colocate", "--predictor",
                                    "costmodel"]],
                         ids=["serve", "colocate", "costmodel"])
def test_serve_entry_point_runs_seamless_on_cpu(extra):
    """`launch/serve.py --arch seamless-m4t-large-v2 --smoke --device cpu
    --use-kernels [--colocate [--predictor costmodel]]`: 16 frames per
    request, K1's wrapper on every decoder layer of every round; a 10 s
    target admits k_max units every round."""
    k1 = K1.PLAIN_CALLS
    if extra:
        extra = extra + ["--k-max", "2", "--qos-s", "10"]
    m = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--use-kernels", "--requests", "3", "--slots", "2",
                    "--s-max", "64"] + extra)
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K1.PLAIN_CALLS - k1 >= 2 * m.decode_rounds
    assert m.ft_units == (2 * m.decode_rounds if extra else 0)


@pytest.mark.parametrize("units", [False, True])
def test_train_entry_point_runs_seamless_on_cpu(units):
    """`launch/train.py --arch seamless-m4t-large-v2 --smoke --device cpu
    --steps 2 --use-kernels [--layer-units]`: seq // 2 = 8 frames per
    sample reach the one-shot step and the units (K2's wrapper on the 2 x
    7 adapted projections: 3 x 14 - 3 a one-shot step, 42 an iteration of
    units)."""
    before = K2.PLAIN_CALLS
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "16",
                      "--use-kernels"] + (["--layer-units"] if units else []))
    assert out["opt"]["t"] == 2
    assert K2.PLAIN_CALLS - before == 2 * (42 if units else 39)
    if units:
        assert out["enc_out"].shape == (2, 8, 64)
