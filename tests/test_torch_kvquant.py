"""PyTorch port vs JAX reference, int8 KV caches (`kv_quant`): per-token
symmetric quantization (half to even), the bulk, prefill and ring writes
into an int8 cache, the dense decode oracle with the scales folded in, and
prefill + decode of a dense GQA model, a sliding-window model and the
hybrid's local-attention rings, each against the JAX model with
`kv_quant=True`. Which caches `kv_quant` reaches (not MLA's latent cache,
not an encoder-decoder's self cache), the oracle route that keeps int8
caches away from K1 (counted), and the reference's byte accounting that
still counts them as bf16. Inputs are made with numpy from a seed."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.costmodel import CostModel as JCostModel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.core.costmodel import CostModel as TCostModel  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

KV, HD = 2, 16


def _cfgs(arch="llama3-8b", **kw):
    kw = dict(kv_quant=True, **kw)
    return (dataclasses.replace(jconfigs.smoke_config(arch), **kw),
            dataclasses.replace(tconfigs.smoke_config(arch), **kw))


def _same_cache(got, expect):
    """int8 K/V and positions bit for bit, the f32 scales at f32 2e-5."""
    assert got.keys() == set(expect)
    for name, t in got.items():
        a, b = to_numpy(t), np.asarray(expect[name])
        assert a.dtype == b.dtype, name
        if name.endswith("_scale"):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=0)
        else:
            np.testing.assert_array_equal(a, b)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


# --------------------------------------------------------- quantization --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tok_matches_reference(dtype):
    """int8 values bit for bit and the scales at f32 2e-5, on random
    tokens of either dtype, a token of zeros (scale from the 1e-6 floor)
    and a token of exact ties: amax 127 gives scale 1, so 2.5, -3.5, 0.5
    and -0.5 round half to even, to 2, -4, 0 and 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, KV, HD)).astype(np.float32) * 3
    x[0, 1] = 0.0
    x[1, 2] = 0.0
    x[1, 2, 0, :5] = [127.0, 2.5, -3.5, 0.5, -0.5]
    xj = jnp.asarray(x).astype(dtype)
    qj, sj = JA._quantize_tok(xj)
    qt, st = TA._quantize_tok(to_torch(np.asarray(xj)))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(qt), np.asarray(qj))
    np.testing.assert_allclose(to_numpy(st), np.asarray(sj), rtol=2e-5,
                               atol=0)
    assert to_numpy(qt)[1, 2, 0, :5].tolist() == [127, 2, -4, 0, 0]
    assert float(st[1, 2]) == 1.0 and float(st[0, 1]) == pytest.approx(
        1e-6 / 127)


# ----------------------------------------------------------- the writes --
@pytest.mark.parametrize("s_max,window,S", [
    (32, 0, 20),        # full cache
    (32, 0, 40),        # prompt longer than the cache: the first s_max
    (64, 16, 10),       # ring, S < W: the reference's _ring_quant_fallback
    (64, 16, 16),       # ring, S = W
    (64, 16, 37),       # ring, S > W: the split write
], ids=["full", "full-overflow", "ring-fallback", "ring-exact",
        "ring-split"])
def test_prefill_then_bulk_writes_match_reference(s_max, window, S):
    """An int8 cache after a prefill write of S tokens, then three decode
    writes (the bulk scatter; across the ring's wrap when windowed; over
    the last slots of a full cache that the prompt overflowed): int8 K/V
    and positions bit for bit, the scales at f32 2e-5."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(S)
    k, v = (rng.normal(size=(2, S, KV, HD)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    cj = JA.make_cache(jcfg, 2, s_max, jnp.float32, window=window,
                       quantized=True)
    ct = TA.make_cache(tcfg, 2, s_max, torch.float32, "cpu", window=window,
                       quantized=True)
    cj = JA._cache_write_prefill(cj, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), window)
    TA._cache_write_prefill(ct, *to_torch([k, v, pos]), window)
    _same_cache(ct, cj)
    for step in range(3):
        k1, v1 = (rng.normal(size=(2, 1, KV, HD)).astype(np.float32)
                  for _ in range(2))
        p1 = np.full((2, 1), (S if window else min(S, s_max - 3)) + step,
                     np.int32)
        cj = JA._cache_write_bulk(cj, jnp.asarray(k1), jnp.asarray(v1),
                                  jnp.asarray(p1), window)
        TA._cache_write_bulk(ct, *to_torch([k1, v1, p1]), window)
        _same_cache(ct, cj)


# ----------------------------------------------------------- the oracle --
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attn_ref_with_scales_matches_reference(dtype, window):
    """The oracle on an int8 cache (scores times k_scale, weights times
    v_scale cast to bf16 before PV, output in q's dtype) against the
    reference's: f32 2e-5 for an f32 q, bf16 2e-2 for a bf16 q; row 1 has
    no valid position and returns 0, not NaN."""
    rng = np.random.default_rng(window)
    B, H, S = 3, 4, 24
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, size=(B, S, KV, HD)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(1e-3, 3e-2, size=(B, S)).astype(np.float32)
              for _ in range(2))
    kv_pos = np.where(np.arange(S)[None] < [[20], [0], [24]],
                      np.arange(S)[None], -1).astype(np.int32)
    positions = np.array([19, 5, 23], np.int32)
    qj = jnp.asarray(q).astype(dtype)
    expect = JA.decode_attn_ref(qj, jnp.asarray(kq), jnp.asarray(vq),
                                jnp.asarray(kv_pos), jnp.asarray(positions),
                                window, scales=(jnp.asarray(ks),
                                                jnp.asarray(vs)))
    ks_t, vs_t = to_torch([ks, vs])
    got = TA.decode_attn_ref(to_torch(np.asarray(qj)), *to_torch(
        [kq, vq, kv_pos, positions]), window, scales=(ks_t, vs_t))
    assert got.dtype == to_torch(np.asarray(qj)).dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(to_numpy(got), np.float32),
                               np.asarray(expect, np.float32), atol=tol,
                               rtol=tol)
    assert torch.isfinite(got.float()).all() and not got[1].any()


# ---------------------------------------------------------------- models --
MODELS = {"dense GQA": ("llama3-8b", 40), "SWA": ("h2o-danube-1.8b", 80),
          "hybrid": ("recurrentgemma-2b", 80)}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_and_decode_match_reference(model, use_kernels):
    """f32 weights, an int8 cache: the prefill's last logits and cache
    (past the window of 64 for SWA and the hybrid's rings, so the split
    write), then two decode steps' logits and caches against the JAX
    model with kv_quant (f32 2e-4; int8 leaves bit for bit). With
    use_kernels every attention layer's decode still takes the oracle,
    counted, and K1's wrapper is never reached."""
    arch, S = MODELS[model]
    jcfg, tcfg = _cfgs(arch)
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, S)).astype(np.int32)
    lg_j, cache_j = JMD.prefill(params, jcfg, {"tokens": toks},
                                JMD.init_cache(jcfg, 2, 96,
                                               dtype=jnp.float32))
    pt = to_torch(params)
    cache = TMD.init_cache(tcfg, 2, 96, dtype=torch.float32, device="cpu")
    lg, _ = TMD.prefill(pt, tcfg, {"tokens": torch.from_numpy(toks)}, cache,
                        use_kernels=use_kernels)
    assert [t.dtype for t in tree_leaves(cache)].count(torch.int8) == 2
    n_attn = len(tcfg.attn_layer_indices())
    for step in range(3):
        np.testing.assert_allclose(to_numpy(lg), np.asarray(lg_j),
                                   atol=2e-4, rtol=2e-4)
        for a, b in zip(tree_leaves(cache), jax.tree.leaves(cache_j)):
            a, b = to_numpy(a), np.asarray(b)
            assert a.dtype == b.dtype
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
            else:
                np.testing.assert_array_equal(a, b)
        if step == 2:
            break
        tok = np.array([3, 5 + step], np.int32)
        pos = np.full((2,), S + step, np.int32)
        lg_j, cache_j = JMD.decode_step(params, jcfg, tok, pos, cache_j)
        k1, oracle = K1.PLAIN_CALLS, TA.INT8_ORACLE_CALLS
        lg, _ = TMD.decode_step(pt, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), cache,
                                use_kernels=use_kernels)
        assert K1.PLAIN_CALLS == k1
        assert TA.INT8_ORACLE_CALLS - oracle == n_attn


def test_int8_logits_stay_within_5_percent_of_bf16():
    """The reference's accuracy bound (`tests/test_attention.py`): on the
    same weights and tokens, the first decode step's logits from an int8
    cache within 5 % of the largest |logit| from the bf16 cache, full and
    ring layouts, in the port."""
    for arch in ("llama3-8b", "h2o-danube-1.8b"):
        _, tcfg = _cfgs(arch)
        params = TMD.init_params(tcfg, 0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, tcfg.vocab_size, size=(2, 70)))
        out = {}
        for quant in (False, True):
            cfg = dataclasses.replace(tcfg, kv_quant=quant)
            cache = TMD.init_cache(cfg, 2, 96, device="cpu")
            TMD.prefill(params, cfg, {"tokens": toks}, cache)
            out[quant], _ = TMD.decode_step(
                params, cfg, toks[:, -1], torch.full((2,), 70,
                                                     dtype=torch.int32),
                cache)
        rel = (out[True] - out[False]).abs().max() / out[False].abs().max()
        assert float(rel) < 0.05, (arch, float(rel))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "seamless-m4t-large-v2"])
def test_mla_latent_and_dec_self_caches_stay_bf16(arch):
    """kv_quant reaches neither MLA's latent cache nor an encoder-decoder's
    self cache (the reference builds it without `quantized`): the port's
    caches match the reference's leaf for leaf, with no int8 leaf and no
    scale."""
    jcfg, tcfg = _cfgs(arch)
    enc = 4 if tcfg.enc_layers else 0
    cache_t = TMD.init_cache(tcfg, 2, 32, enc_len=enc, device="cpu")
    cache_j = JMD.init_cache(jcfg, 2, 32, enc_len=enc)
    for a, b in zip(tree_leaves(cache_t), jax.tree.leaves(cache_j)):
        assert a.shape == b.shape and to_numpy(a).dtype == np.asarray(b).dtype
    assert all(t.dtype != torch.int8 for t in tree_leaves(cache_t))
    assert "k_scale" not in str(jax.tree_util.tree_structure(cache_j))


def test_reference_decode_adapter_ignores_scales_and_the_port_refuses():
    """A reference behaviour, made visible: the reference's
    `ops.decode_attention` takes `scales` and ignores them (an int8 cache
    only avoids it because `attn_decode` routes it to the oracle first).
    The port's adapter refuses scales instead."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(1, 4, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(1, 64, 2, 16)).astype(np.float32)
              for _ in range(2))
    kv_pos = np.arange(64, dtype=np.int32)[None]
    pos = np.array([40], np.int32)
    args = [jnp.asarray(a) for a in (q, kc, vc, kv_pos, pos)]
    scales = (jnp.full((1, 64), 7.0), jnp.full((1, 64), 0.5))
    np.testing.assert_array_equal(
        np.asarray(jops.decode_attention(*args, scales=scales)),
        np.asarray(jops.decode_attention(*args)))
    with pytest.raises(ValueError, match="no int8 path"):
        tops.decode_attention(*to_torch([q, kc, vc, kv_pos, pos]),
                              scales=to_torch([np.asarray(s)
                                               for s in scales]))


def test_byte_accounting_counts_an_int8_cache_as_bf16():
    """A reference behaviour, mirrored: `kv_bytes_per_token_layer` counts
    bf16 K/V under kv_quant, so the page pool's page bytes and the cost
    model's decode time are those of a bf16 cache, in both packages,
    while the int8 cache holds half the K/V bytes plus 8 B of scales per
    token and layer."""
    jcfg, tcfg = _cfgs()
    jb, tb = (dataclasses.replace(c, kv_quant=False) for c in (jcfg, tcfg))
    for a, b in ((jcfg, jb), (tcfg, tb)):
        assert a.kv_bytes_per_token_layer() == b.kv_bytes_per_token_layer() \
            == 2 * 2 * KV * HD
    assert TCostModel(tcfg).decode_solo(8, 512, noisy=False) == \
        TCostModel(tb).decode_solo(8, 512, noisy=False)
    assert JCostModel(jcfg).decode_solo(8, 512, noisy=False) == \
        JCostModel(jb).decode_solo(8, 512, noisy=False)
    params = TMD.init_params(tcfg, 0, device="cpu")
    q8, b16 = (TEngine(c, params, max_slots=2, s_max=64, device="cpu")
               for c in (tcfg, tb))
    assert q8.pages.spec.page_bytes == b16.pages.spec.page_bytes
    nbytes = [sum(t.numel() * t.element_size() for name, t in
                  e.cache["scan"].items() if name != "kv_pos")
              for e in (q8, b16)]
    tokens = tcfg.num_layers * 2 * 64
    assert nbytes == [tokens * (2 * KV * HD + 8), tokens * 2 * 2 * KV * HD]


# --------------------------------------------------------- engine, rounds --
class _JEngineRepaired(JEngine):
    """The reference engine with its slot insert at [:, slot] and its
    decode fed at context_len - 1 (tests/test_torch_serving.py)."""

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


def test_engine_greedy_tokens_match_reference():
    """llama3's smoke config with an int8 cache in both engines (f32
    weights, the kernels asked for): the same greedy tokens as the
    repaired reference engine; every round's attention layers take the
    counted oracle, none K1."""
    jcfg, tcfg = _cfgs()
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)

    def trace(R):
        return [R(rid=i, arrival=i * 0.01, prompt_len=6 + 5 * i,
                  max_new_tokens=6) for i in range(6)]
    expect = _drive(_JEngineRepaired(jcfg, params_j, max_slots=4, s_max=64,
                                     use_kernels=True), trace(JRequest))
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=64,
                  use_kernels=True, device="cpu")
    assert eng.cache["scan"]["k"].dtype == torch.int8
    k1, oracle = K1.PLAIN_CALLS, TA.INT8_ORACLE_CALLS
    assert _drive(eng, trace(TRequest)) == expect
    assert K1.PLAIN_CALLS == k1
    assert TA.INT8_ORACLE_CALLS - oracle == \
        tcfg.num_layers * eng.metrics.decode_rounds


def test_colocated_round_equals_decode_plus_units():
    """A co-located round of 4 units on an int8 cache equals a decode step
    then 4 separate units bit for bit (the CPU's eager rounds)."""
    _, tcfg = _cfgs()
    params = TMD.init_params(tcfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    ft0 = TP.init_ft_state(tcfg, pc, params, 1, tdata.Prefetcher(
        tdata.SyntheticCorpus(tdata.DataConfig(tcfg.vocab_size, 16, 2)
                              ).batches(), 2).stacked())
    cache0 = TMD.init_cache(tcfg, 3, 48, device="cpu")
    TMD.prefill(params, tcfg, {"tokens": torch.from_numpy(
        np.random.default_rng(6).integers(0, 256, size=(3, 20)))}, cache0)
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    pos = torch.full((3,), 20, dtype=torch.int32)
    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=4,
                               use_kernels=True)
    lg_f, cache_f, ft_f = runner.run_round(4, tok, pos, _clone(cache0),
                                           _clone(ft0))
    lg_s, cache_s = TMD.decode_step(params, tcfg, tok, pos, _clone(cache0),
                                    use_kernels=True)
    ft_s = TP.run_units(TP.make_unit_step(tcfg, pc, params,
                                          use_kernels=True), _clone(ft0), 4)
    assert torch.equal(lg_f, lg_s)
    for a, b in zip(tree_leaves([cache_f, ft_f]), tree_leaves([cache_s,
                                                               ft_s])):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert cache_f["scan"]["k_scale"][:, :, 20].all()
