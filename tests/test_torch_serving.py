"""Serving substrate of the port: continuous batching, page tables, paged
pool gather/scatter, and greedy tokens of a seeded trace against JAX's
ServingEngine on the same weights.

The reference engine's `_insert_slot_cache` writes `dst.at[slot]` on caches
whose leading axis is the layer, so it puts layer 0 of the prefilled cache
into layer `slot` of every slot, and its `decode_round` feeds the last token
at position `context_len`, one past the token's own, so position prompt_len
is never written. The port inserts at `[:, slot]` and feeds position
`context_len - 1`; the token comparisons run the reference with both
corrected (subclasses in this file; the JAX package is unchanged)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serving import kv_cache as JKV  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.serving import kv_cache as TKV  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.request import Request as TRequest  # noqa: E402

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=96, vocab_size=256)
# the SSM family at the same width: mamba2's mixer, state 16, chunk 8
TINY_SSM = dict(name="t", family="ssm", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=256,
                ssm_state=16, ssm_headdim=16, ssm_chunk=8)


@pytest.fixture(scope="module")
def tiny():
    params_j = JMD.init_params(JConfig(**TINY), jax.random.PRNGKey(0))
    return params_j, to_torch(params_j)


@pytest.fixture(scope="module")
def tiny_ssm():
    params_j = JMD.init_params(JConfig(**TINY_SSM), jax.random.PRNGKey(0))
    return params_j, to_torch(params_j)


def _trace(R):
    return [R(rid=i, arrival=i * 0.01, prompt_len=8 + i, max_new_tokens=6)
            for i in range(6)]


def test_engine_continuous_batching(tiny):
    eng = TEngine(TConfig(**TINY), tiny[1], max_slots=4, s_max=64,
                  device="cpu")
    reqs = _trace(TRequest)
    m = eng.run_trace(reqs)
    assert m.prefills == 6
    assert m.tokens_out == 6 * 6
    assert max(m.round_batch_sizes) == 4        # slots saturate
    assert all(r.phase.value == "done" for r in reqs)
    assert len(m.round_s) == m.decode_rounds and len(m.prefill_s) == 6


def test_engine_memory_pressure_rejects(tiny):
    eng = TEngine(TConfig(**TINY), tiny[1], max_slots=4, s_max=64,
                  num_pages=4, page_tokens=16, device="cpu")
    r = TRequest(rid=0, arrival=0.0, prompt_len=60, max_new_tokens=4)
    assert eng.try_admit(r, np.arange(60, dtype=np.int32) % 256)
    r2 = TRequest(rid=1, arrival=0.0, prompt_len=60, max_new_tokens=4)
    assert not eng.try_admit(r2, np.arange(60, dtype=np.int32) % 256)


def test_slot_insert_places_prefill_cache_in_its_slot(tiny):
    cfg = TConfig(**TINY)
    eng = TEngine(cfg, tiny[1], max_slots=3, s_max=32, device="cpu")
    prompt = np.arange(10, dtype=np.int32) * 7 % 256
    for rid in range(2):                         # request 1 lands in slot 1
        assert eng.try_admit(TRequest(rid=rid, arrival=0.0, prompt_len=10,
                                      max_new_tokens=4), prompt)
    direct = TMD.init_cache(cfg, 1, 32, device="cpu")
    TMD.prefill(tiny[1], cfg, {"tokens": torch.from_numpy(prompt[None])},
                direct)
    for name, t in eng.cache["scan"].items():
        torch.testing.assert_close(t[:, 1], direct["scan"][name][:, 0])
    assert torch.all(eng.cache["scan"]["kv_pos"][:, 2] == -1)   # untouched


class _JEngineSlotFixed(JEngine):
    """The stacked caches' insert at [:, slot]; a "pre" layer's cache has
    no layer axis, and the reference's [slot] is right for it."""

    def _insert_slot_cache(self, slot, one_cache):
        pre = [jax.tree.map(lambda d, s: d.at[slot].set(s[0]), dst, src)
               for dst, src in zip(self.cache["pre"], one_cache["pre"])]
        scan = jax.tree.map(lambda d, s: d.at[:, slot].set(s[:, 0]),
                            self.cache["scan"], one_cache["scan"])
        self.cache = dict(self.cache, pre=pre, scan=scan)


class _JEngineRepaired(_JEngineSlotFixed):
    """The slot-fixed reference engine whose decode step takes every
    active slot's position one lower: `context_len - 1`, the position of
    the token it feeds, as the port's engine does."""

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


@pytest.mark.parametrize("family", ["dense", "ssm"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_match_reference(request, family, use_kernels):
    """bf16 weights and cache, as served; same seed on both sides. With
    use_kernels the port's dense decode runs K1's wrapper and the SSM
    prefill K3's (the reference engine's prefill takes no kernels, and its
    SSM decode has none); an SSM model has no KV, yet the page accounting
    admits and releases every request."""
    cfg = TINY if family == "dense" else TINY_SSM
    params_j, params_t = request.getfixturevalue(
        "tiny" if family == "dense" else "tiny_ssm")
    expect = _drive(_JEngineRepaired(JConfig(**cfg), params_j, max_slots=4,
                                     s_max=64, use_kernels=use_kernels),
                    _trace(JRequest))
    before, before3 = K.PLAIN_CALLS, K3.PLAIN_CALLS
    eng = TEngine(TConfig(**cfg), params_t, max_slots=4, s_max=64,
                  use_kernels=use_kernels, device="cpu")
    got = _drive(eng, _trace(TRequest))
    assert got == expect
    assert (K.PLAIN_CALLS > before) == (use_kernels and family == "dense")
    assert K3.PLAIN_CALLS - before3 == \
        (cfg["num_layers"] * eng.metrics.prefills
         if use_kernels and family == "ssm" else 0)
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_deepseek_match_reference(use_kernels):
    """deepseek-v3's smoke config (an MLA dense layer in "pre", 4 MLA + MoE
    layers stacked), f32 weights and the engines' bf16 latent caches:
    the same greedy tokens as the reference engine with its stacked-cache
    insert and decode position repaired (`_JEngineRepaired`). With the
    kernels on, MLA decode still runs no K1 (the reference's has no
    kernel either), and serving has no adapters, so no K2."""
    jcfg = jconfigs.smoke_config("deepseek-v3-671b")
    tcfg = tconfigs.smoke_config("deepseek-v3-671b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    expect = _drive(_JEngineRepaired(jcfg, params_j, max_slots=4, s_max=64,
                                     use_kernels=use_kernels),
                    _trace(JRequest))
    before = (K.PLAIN_CALLS, K2.PLAIN_CALLS)
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=64,
                  use_kernels=use_kernels, device="cpu")
    assert eng.cache["pre"][0]["c_kv"].shape == (4, 64, tcfg.mla_kv_rank)
    got = _drive(eng, _trace(TRequest))
    assert got == expect
    assert (K.PLAIN_CALLS, K2.PLAIN_CALLS) == before
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0


def test_reference_slot_insert_is_right_for_pre_caches():
    """The reference's `dst.at[slot].set(src[0])` writes the layer axis of
    a stacked cache (ROADMAP.md §3), but a "pre" layer's cache has no
    layer axis, so there it puts the prefilled cache in its slot: after
    the same admissions, the reference engine's pre cache equals the
    port's, while its stacked cache does not."""
    jcfg = jconfigs.smoke_config("deepseek-v3-671b")
    tcfg = tconfigs.smoke_config("deepseek-v3-671b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ref = JEngine(jcfg, params_j, max_slots=3, s_max=32)
    eng = TEngine(tcfg, to_torch(params_j), max_slots=3, s_max=32,
                  device="cpu")
    prompt = np.arange(10, dtype=np.int32) * 7 % 256
    for rid in range(2):                         # request 1 lands in slot 1
        for e, R in ((ref, JRequest), (eng, TRequest)):
            assert e.try_admit(R(rid=rid, arrival=0.0, prompt_len=10,
                                 max_new_tokens=4), prompt)
    for name, t in eng.cache["pre"][0].items():
        np.testing.assert_allclose(
            np.asarray(to_numpy(t), np.float32),
            np.asarray(ref.cache["pre"][0][name], np.float32),
            atol=2e-2, rtol=2e-2)
    assert torch.all(eng.cache["pre"][0]["kv_pos"][2] == -1)
    assert not np.array_equal(np.asarray(ref.cache["scan"]["kv_pos"]),
                              to_numpy(eng.cache["scan"]["kv_pos"]))


def _drive_forced(ref, eng, jreqs, treqs):
    """Both engines in lockstep on the same prompts, the port's fed the
    reference's greedy tokens (teacher forcing, so a pick that one side's
    rounding flips does not fork the traces). Returns, per round, the
    logits of the slots that decoded in it, (port, reference)."""
    seen = {}
    jitted = ref._decode

    def ref_step(*args):
        out = jitted(*args)
        seen["ref"] = np.asarray(out[0], np.float32)
        return out

    def port_step(tokens, positions, cache):
        out = TMD.decode_step(eng.params, eng.cfg, tokens, positions, cache,
                              use_kernels=eng.use_kernels)
        seen["port"] = out[0].float().numpy()
        return out
    ref._decode = ref_step
    rounds, qi = [], 0
    while True:
        while qi < len(jreqs):
            prompt = ref.rng.integers(0, ref.cfg.vocab_size,
                                      size=jreqs[qi].prompt_len,
                                      dtype=np.int32)
            if not ref.try_admit(jreqs[qi], prompt):
                break
            assert eng.try_admit(treqs[qi], prompt)
            qi += 1
        if not ref.active_requests() and qi >= len(jreqs):
            assert not eng.active_requests()
            return rounds
        live = [i for i, r in enumerate(ref.slots)
                if r is not None and r.phase.value == "decoding"]
        np.copyto(eng.last_token, ref.last_token)
        ref.decode_round()
        eng.decode_round(port_step)
        rounds.append((seen["port"][live], seen["ref"][live]))


# prompts below, at and past the smoke window of 64, and decodes that wrap
# the ring; the longest context is 142 of s_max 160
PAST_THE_WINDOW = [(40, 30), (64, 8), (90, 20), (130, 12), (12, 40), (70, 26)]


def _past_the_window(R):
    return [R(rid=i, arrival=i * 0.01, prompt_len=p, max_new_tokens=n)
            for i, (p, n) in enumerate(PAST_THE_WINDOW)]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_greedy_tokens_past_the_window_match_reference(arch,
                                                              use_kernels):
    """The sliding-window smoke configs (mixtral: MoE too) served on both
    sides, f32 weights and the engines' bf16 caches, every slot's cache a
    ring of 64 and the page accounting holding at most the ring's 4 pages
    of 16 per slot. Kernels off: the same greedy tokens. Kernels on, the
    port runs K1's wrapper once per layer per round over the rings, while
    the reference's adapter sends every windowed cache to its windowed
    oracle, which rounds the softmax weights to the cache's bf16 where K1
    keeps them in f32 (ROADMAP.md §3); that flips greedy picks of the
    random smoke model, so the port is fed the reference's tokens and
    every round's logits agree within the bf16 tolerance of
    test_kernels.py (2e-2) of the round's largest logit. (Elementwise
    2e-2 does not hold: the two attentions' roundings reach the logits
    through every layer and every cached key of earlier rounds.)
    (bf16 weights: the two sides' roundings differ enough over 130-token
    prompts to flip greedy picks even with the kernels off.)"""
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ref = _JEngineRepaired(jcfg, params_j, max_slots=4, s_max=160,
                           use_kernels=use_kernels)
    eng = TEngine(tcfg, to_torch(params_j), max_slots=4, s_max=160,
                  use_kernels=use_kernels, device="cpu")
    assert eng.cache["scan"]["k"].shape[2] == 64 == eng.cache_len
    assert eng.pages.max_pages_per_seq == 4
    before = K.PLAIN_CALLS
    if use_kernels:
        rounds = _drive_forced(ref, eng, _past_the_window(JRequest),
                               _past_the_window(TRequest))
        assert len(rounds) == eng.metrics.decode_rounds
        for got, expect in rounds:
            assert np.abs(got - expect).max() <= 2e-2 * np.abs(expect).max()
    else:
        expect = _drive(ref, _past_the_window(JRequest))
        got = _drive(eng, _past_the_window(TRequest))
        assert got == expect
        assert all(len(t) == n for t, (_, n) in zip(got.values(),
                                                    PAST_THE_WINDOW))
    assert K.PLAIN_CALLS - before == (tcfg.num_layers * eng.metrics.
                                      decode_rounds if use_kernels else 0)
    assert eng.metrics.prefills == 6 and eng.pages.pages_in_use == 0
    assert eng.metrics.tokens_out == sum(n for _, n in PAST_THE_WINDOW)


def test_engine_decode_leaves_a_gap_at_the_prompt_length():
    """A fault of the reference, repaired in the port: the reference's
    `decode_round` feeds the token at `context_len` = prompt_len +
    generated, and generated is 1 after the prefill, so the first decode
    token goes to position P + 1 and P is never written. On a ring of W,
    slot P % W then keeps the prefill's position P - W (outside the
    window) for W rounds: K1 reads it and the windowed oracle masks it.
    The port's engine writes P, so its ring holds exactly the window after
    every round, and K1 over it agrees with the windowed oracle."""
    jcfg = jconfigs.smoke_config("h2o-danube-1.8b")
    tcfg = tconfigs.smoke_config("h2o-danube-1.8b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    P, W = 70, 64
    prompt = np.arange(P, dtype=np.int32) * 3 % 256
    ref = _JEngineSlotFixed(jcfg, params_j, max_slots=1, s_max=160)
    eng = TEngine(tcfg, to_torch(params_j), max_slots=1, s_max=160,
                  device="cpu")
    assert ref.try_admit(JRequest(rid=0, arrival=0.0, prompt_len=P,
                                  max_new_tokens=4), prompt)
    assert eng.try_admit(TRequest(rid=0, arrival=0.0, prompt_len=P,
                                  max_new_tokens=4), prompt)
    layer0 = {n: t[0] for n, t in eng.cache["scan"].items()}
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 4, 16)).astype(np.float32))

    def k1_and_oracle(p, kv_pos, ring=layer0):
        args = (q.to(torch.bfloat16), ring["k"], ring["v"], kv_pos,
                torch.tensor([p], dtype=torch.int32), W)
        return (kops.decode_attention(*args).float(),
                TA.decode_attn_ref(*args).float())

    def close(a, b):                 # the bf16 tolerance of test_kernels.py
        return torch.allclose(a, b, atol=2e-2, rtol=2e-2)
    assert close(*k1_and_oracle(P - 1, layer0["kv_pos"]))  # after prefill
    ref.decode_round()
    eng.decode_round()
    ref_pos = np.asarray(ref.cache["scan"]["kv_pos"][0, 0])
    assert P not in ref_pos and P + 1 in ref_pos
    assert ref_pos[P % W] == P - W          # stale, outside the window
    port_pos = layer0["kv_pos"][0].numpy()
    assert P in port_pos and P + 1 not in port_pos
    np.testing.assert_array_equal(np.sort(port_pos), np.arange(P - W + 1,
                                                               P + 1))
    for _ in range(3):                      # and after later rounds
        assert close(*k1_and_oracle(int(port_pos.max()), layer0["kv_pos"]))
        eng.decode_round()
        port_pos = layer0["kv_pos"][0].numpy()
    # on the reference's ring K1 reads the stale slot as if it held a
    # position inside the window
    ring = {n: to_torch(t[0]) for n, t in ref.cache["scan"].items()}
    k1, oracle = k1_and_oracle(P + 1, ring["kv_pos"], ring)
    counted = ring["kv_pos"].clone()
    counted[0, P % W] = P
    assert not close(k1, oracle)
    assert close(k1, k1_and_oracle(P + 1, counted, ring)[1])


def test_page_table_manager_matches_reference():
    rng = np.random.default_rng(0)
    mgrs = [M.PageTableManager(M.PagePoolSpec(n_layers=2, num_pages=32,
                                              page_tokens=8, kv_heads=2,
                                              head_dim=16), 8, 8)
            for M in (JKV, TKV)]
    for _ in range(200):
        op, slot, n = rng.integers(0, 4), int(rng.integers(0, 8)), \
            int(rng.integers(1, 40))
        res = []
        for m in mgrs:
            if op == 0 and slot not in m.tables:
                res.append(m.admit(slot, n))
            elif op == 1 and slot in m.tables:
                res.append(m.extend(slot, n))
            elif op == 2:
                res.append(m.release(slot))
            else:
                res.append(m.set_usable(int(n)))
        assert res[0] == res[1]
        assert mgrs[0].tables == mgrs[1].tables
        np.testing.assert_array_equal(mgrs[0].table_array(list(range(8))),
                                      mgrs[1].table_array(list(range(8))))


def test_paged_read_write_and_positions_match_reference():
    rng = np.random.default_rng(1)
    L, P, ptok, KV, hd, B = 2, 10, 4, 2, 8, 3
    pool = rng.normal(size=(L, 2, P, ptok, KV, hd)).astype(np.float32)
    table = np.array([[3, 1, -1], [0, 5, 7], [9, -1, -1]], np.int32)
    lengths = np.array([6, 12, 2], np.int32)
    positions = np.array([5, 11, 1], np.int32)
    kn = rng.normal(size=(B, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, hd)).astype(np.float32)
    pj = JKV.paged_write(jnp.asarray(pool), jnp.asarray(table), 1,
                         jnp.asarray(positions), jnp.asarray(kn),
                         jnp.asarray(vn))
    pt = TKV.paged_write(*to_torch([pool, table]), 1,
                         *to_torch([positions, kn, vn]))
    np.testing.assert_array_equal(to_numpy(pt), np.asarray(pj))
    for kt, kj in zip(TKV.paged_read(pt, torch.from_numpy(table), 1),
                      JKV.paged_read(pj, jnp.asarray(table), 1)):
        np.testing.assert_array_equal(to_numpy(kt), np.asarray(kj))
    np.testing.assert_array_equal(
        to_numpy(TKV.kv_positions(*to_torch([table, lengths]), ptok)),
        np.asarray(JKV.kv_positions(jnp.asarray(table),
                                    jnp.asarray(lengths), ptok)))


def test_paged_pool_roundtrip_matches_dense():
    """paged_write + the paged decode wrapper reproduce dense decode
    attention through a page-table indirection (as in test_serving.py)."""
    rng = np.random.default_rng(2)
    spec = TKV.PagePoolSpec(n_layers=1, num_pages=12, page_tokens=8,
                            kv_heads=2, head_dim=16, dtype=torch.float32)
    pool = spec.alloc("cpu")
    mgr = TKV.PageTableManager(spec, max_slots=3, max_pages_per_seq=4)
    lengths = [11, 19, 5]
    for slot, ln in enumerate(lengths):
        assert mgr.admit(slot, ln)
    table = torch.from_numpy(mgr.table_array([0, 1, 2]))
    dense_k = np.zeros((3, 32, 2, 16), np.float32)
    dense_v = np.zeros((3, 32, 2, 16), np.float32)
    for pos in range(max(lengths)):
        kn = rng.normal(size=(3, 2, 16)).astype(np.float32)
        vn = rng.normal(size=(3, 2, 16)).astype(np.float32)
        p = [min(pos, ln - 1) for ln in lengths]
        TKV.paged_write(pool, table, 0, torch.tensor(p, dtype=torch.int32),
                        torch.from_numpy(kn), torch.from_numpy(vn))
        for s_ in range(3):
            dense_k[s_, p[s_]] = kn[s_]
            dense_v[s_, p[s_]] = vn[s_]
    q = rng.normal(size=(3, 4, 16)).astype(np.float32)
    out = K.paged_decode_attention(torch.from_numpy(q), pool[0, 0],
                                   pool[0, 1], table,
                                   torch.tensor(lengths, dtype=torch.int32))
    kv_pos = np.full((3, 32), -1, np.int32)
    for s_, ln in enumerate(lengths):
        kv_pos[s_, :ln] = np.arange(ln)
    ref = JA.decode_attn_ref(jnp.asarray(q), jnp.asarray(dense_k),
                             jnp.asarray(dense_v), jnp.asarray(kv_pos),
                             jnp.asarray([ln - 1 for ln in lengths],
                                         jnp.int32))
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                               atol=3e-5, rtol=3e-5)
