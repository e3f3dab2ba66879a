"""PyTorch port vs JAX reference, co-location: a round equals a decode step
plus k separate units (bitwise inside torch, within tolerance of the JAX
runner), the predictor and the scheduler are the reference's (same samples
give the same coefficients and the same decisions), and a co-located serve
runs end to end on the CPU with the predictor fit from measured rounds."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.colocation import ColocatedRunner as JRunner  # noqa: E402
from repro.core.predictor import \
    TwoStageLatencyPredictor as JPred  # noqa: E402
from repro.core.scheduler import QoSScheduler as JSched  # noqa: E402
from repro.core.scheduler import SchedulerConfig as JSchedCfg  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models.config import LoRAConfig as JLoRAConfig  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import peft as JP  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.core.predictor import TwoStageLatencyPredictor  # noqa: E402
from repro_torch.core.scheduler import (QoSScheduler,  # noqa: E402
                                        SchedulerConfig)
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K1  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.config import LoRAConfig, ModelConfig  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.request import Phase, Request  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.training.data import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticCorpus)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TINY = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, d_ff=96, vocab_size=128)


def _clone(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                    tree)


def _f32(t):
    return np.asarray(to_numpy(t), np.float32)


@pytest.fixture(scope="module")
def tiny():
    """f32 weights and a JAX ft_state (B drawn, so the units' grads are not
    0), with the JAX runner's round of k = 4 units over them."""
    jcfg = JModelConfig(**TINY, lora=JLoRAConfig(rank=4))
    tcfg = ModelConfig(**TINY, lora=LoRAConfig(rank=4))
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pc = JP.PeftConfig(micro_batch=2, seq_len=8, accum=1)
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(
        jdata.DataConfig(128, 8, 2)).batches(), 2).stacked()
    ft0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1), staged)
    rng = np.random.default_rng(3)
    for v in ft0["adapters"]["scan"].values():
        v["b"] = jnp.asarray(rng.normal(size=v["b"].shape).astype(np.float32)
                             * 0.05)
    ft0 = jax.tree.map(np.asarray, ft0)
    # a prefilled cache: slot b holds positions 0..6, as the paged decode
    # adapter assumes of an engine's cache
    prompts = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    _, cache0 = JMD.prefill(params, jcfg, {"tokens": jnp.asarray(prompts)},
                            JMD.init_cache(jcfg, 3, 32, dtype=jnp.float32))
    cache0 = jax.tree.map(np.asarray, cache0)
    tok = np.array([1, 2, 3], np.int32)
    pos = np.array([4, 5, 6], np.int32)
    runner = JRunner(jcfg, params, jcfg, params, pc, k_max=4, donate=False)
    out = jax.tree.map(np.asarray, runner.run_round(4, tok, pos, cache0, ft0))
    return tcfg, params, ft0, cache0, tok, pos, out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_colocated_round_equals_decode_plus_units(tiny, use_kernels):
    tcfg, params_j, ft0_j, cache0_j, tok, pos, (lg_j, cache_j, ft_j) = tiny
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=8, accum=1)
    ft0, cache0 = to_torch(ft0_j), to_torch(cache0_j)
    tok_t, pos_t = torch.from_numpy(tok), torch.from_numpy(pos)

    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=4,
                               use_kernels=use_kernels)
    k1, k2 = K1.PLAIN_CALLS, K2.PLAIN_CALLS
    lg_f, cache_f, ft_f = runner.run_round(4, tok_t, pos_t, _clone(cache0),
                                           _clone(ft0))
    # decode: one K1 call per layer; units EMBED, FWD x 2, HEAD: 7 each FWD
    assert K1.PLAIN_CALLS - k1 == (2 if use_kernels else 0)
    assert K2.PLAIN_CALLS - k2 == (14 if use_kernels else 0)

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
    assert ft_f["unit_idx"] == 4

    # against the JAX runner: f32 decode to 2e-4; the units' bf16 stream
    # (HEAD's loss and dx) to bf16 noise
    np.testing.assert_allclose(_f32(lg_f), lg_j, atol=2e-4, rtol=2e-4)
    for name in ("k", "v", "kv_pos"):
        np.testing.assert_allclose(_f32(cache_f["scan"][name]),
                                   cache_j["scan"][name], atol=2e-4,
                                   rtol=2e-4)
    assert float(ft_f["loss"]) == pytest.approx(float(ft_j["loss"]),
                                                rel=1e-2)
    dx, dx_j = _f32(ft_f["x"]), np.asarray(ft_j["x"], np.float32)
    assert np.linalg.norm(dx - dx_j) <= 5e-2 * np.linalg.norm(dx_j)
    res, res_j = _f32(ft_f["residuals"]), np.asarray(ft_j["residuals"],
                                                     np.float32)
    assert np.linalg.norm(res - res_j) <= 2e-2 * np.linalg.norm(res_j)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_colocated_round_equals_decode_plus_units(use_kernels):
    """One co-located round of k = 4 units on mixtral's smoke config (MoE,
    window 64; f32 weights and cache), its slots prefilled past the window
    (70 tokens: the ring holds the last 64): bit for bit a decode step plus
    4 separate units inside torch (K1's wrapper once per layer, K2's 4 per
    FWD unit with the kernels on), and within tolerance of the JAX runner's
    round (its decode on the oracle)."""
    jcfg = jconfigs.smoke_config("mixtral-8x7b")
    tcfg = smoke_config("mixtral-8x7b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        jcfg.vocab_size, 16, 2, seed=4)).batches(), 2).stacked()
    ft0_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                             staged)
    rng = np.random.default_rng(6)
    for v in ft0_j["adapters"]["scan"].values():
        v["b"] = jnp.asarray(rng.normal(size=v["b"].shape).astype(np.float32)
                             * 0.05)
    ft0_j = jax.tree.map(np.asarray, ft0_j)
    prompts = rng.integers(0, jcfg.vocab_size, size=(3, 70)).astype(np.int32)
    _, cache0_j = JMD.prefill(params_j, jcfg,
                              {"tokens": jnp.asarray(prompts)},
                              JMD.init_cache(jcfg, 3, 96, dtype=jnp.float32))
    cache0_j = jax.tree.map(np.asarray, cache0_j)
    assert cache0_j["scan"]["k"].shape[2] == 64
    tok = np.array([1, 2, 3], np.int32)
    pos = np.full((3,), 70, np.int32)
    lg_j, cache_j, ft_j = jax.tree.map(np.asarray, JRunner(
        jcfg, params_j, jcfg, params_j, pc_j, k_max=4, donate=False
    ).run_round(4, tok, pos, cache0_j, ft0_j))

    params, ft0, cache0 = to_torch((params_j, ft0_j, cache0_j))
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    tok_t, pos_t = torch.from_numpy(tok), torch.from_numpy(pos)
    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=4,
                               use_kernels=use_kernels)
    k1, k2 = K1.PLAIN_CALLS, K2.PLAIN_CALLS
    lg_f, cache_f, ft_f = runner.run_round(4, tok_t, pos_t, _clone(cache0),
                                           _clone(ft0))
    # decode: one K1 call per layer; units EMBED, FWD x 2 (q/k/v/o), HEAD
    assert K1.PLAIN_CALLS - k1 == (2 if use_kernels else 0)
    assert K2.PLAIN_CALLS - k2 == (8 if use_kernels else 0)
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

    np.testing.assert_allclose(_f32(lg_f), lg_j, atol=2e-4, rtol=2e-4)
    for name in ("k", "v", "kv_pos"):
        np.testing.assert_allclose(_f32(cache_f["scan"][name]),
                                   cache_j["scan"][name], atol=2e-4,
                                   rtol=2e-4)
    res, res_j = _f32(ft_f["residuals"]), np.asarray(ft_j["residuals"],
                                                     np.float32)
    assert np.linalg.norm(res - res_j) <= 2e-2 * np.linalg.norm(res_j)
    assert float(ft_f["loss"]) == pytest.approx(float(ft_j["loss"]),
                                                rel=1e-2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_colocated_round_equals_decode_plus_units(use_kernels):
    """One co-located round of k = 6 units on deepseek-v3's smoke config
    (an MLA dense layer in "pre", 4 MLA + MoE layers): EMBED with the pre
    layer's adapters, 4 FWD, HEAD. Bit for bit a decode step plus 6
    separate units inside torch (no K1: MLA decode has no kernel; K2's 5
    per EMBED and per FWD unit with the kernels on), and within the bf16
    tolerance (2e-2 of the largest entry) of the JAX runner's round. bf16
    weights and cache, as served: the reference's EMBED_BWD cannot be
    traced on f32 weights (ROADMAP.md §3), and its round traces every
    unit."""
    jcfg = jconfigs.smoke_config("deepseek-v3-671b")
    tcfg = smoke_config("deepseek-v3-671b")
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    pc_j = JP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(
        jcfg.vocab_size, 16, 2, seed=4)).batches(), 2).stacked()
    ft0_j = JP.init_ft_state(jcfg, pc_j, params_j, jax.random.PRNGKey(1),
                             staged)
    rng = np.random.default_rng(6)
    ft0_j["adapters"] = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)
                                 * 0.05) if p[-1].key == "b" else x,
        ft0_j["adapters"])
    ft0_j = jax.tree.map(np.asarray, ft0_j)
    prompts = rng.integers(0, jcfg.vocab_size, size=(3, 20)).astype(np.int32)
    _, cache0_j = JMD.prefill(params_j, jcfg,
                              {"tokens": jnp.asarray(prompts)},
                              JMD.init_cache(jcfg, 3, 48))
    cache0_j = jax.tree.map(np.asarray, cache0_j)
    tok = np.array([1, 2, 3], np.int32)
    pos = np.full((3,), 20, np.int32)
    lg_j, cache_j, ft_j = jax.tree.map(np.asarray, JRunner(
        jcfg, params_j, jcfg, params_j, pc_j, k_max=6, donate=False
    ).run_round(6, tok, pos, cache0_j, ft0_j))

    params, ft0, cache0 = to_torch((params_j, ft0_j, cache0_j))
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    tok_t, pos_t = torch.from_numpy(tok), torch.from_numpy(pos)
    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=6,
                               use_kernels=use_kernels)
    assert [runner.unit_step.kind(u) for u in range(6)] == \
        ["EMBED"] + ["FWD"] * 4 + ["HEAD"]
    k1, k2 = K1.PLAIN_CALLS, K2.PLAIN_CALLS
    lg_f, cache_f, ft_f = runner.run_round(6, tok_t, pos_t, _clone(cache0),
                                           _clone(ft0))
    assert K1.PLAIN_CALLS == k1
    assert K2.PLAIN_CALLS - k2 == (5 * 5 if use_kernels else 0)
    lg_s, cache_s = TMD.decode_step(params, tcfg, tok_t, pos_t,
                                    _clone(cache0), use_kernels=use_kernels)
    ft_s = TP.run_units(TP.make_unit_step(tcfg, pc, params,
                                          use_kernels=use_kernels),
                        _clone(ft0), 6)
    assert torch.equal(lg_f, lg_s)
    for a, b in zip(tree_leaves(cache_f), tree_leaves(cache_s)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ft_f), tree_leaves(ft_s)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)

    def close(got, expect):
        expect = np.asarray(expect, np.float32)
        return np.abs(_f32(got) - expect).max() <= \
            2e-2 * max(np.abs(expect).max(), 1.0)
    assert close(lg_f, lg_j)
    for got, expect in zip(tree_leaves(cache_f), jax.tree.leaves(cache_j)):
        assert close(got, expect)
    # the front (embedding and the pre layer) at 2e-2 relative Frobenius;
    # through the MoE layers, a token whose top-k the two sides' bf16
    # roundings pick differently moves by an expert's output, so the
    # stack is held at the bf16 units' 8e-2 (tests/test_torch_training.py)
    res, res_j = _f32(ft_f["residuals"]), np.asarray(ft_j["residuals"],
                                                     np.float32)
    assert np.linalg.norm(res[0] - res_j[0]) <= \
        2e-2 * np.linalg.norm(res_j[0])
    assert np.linalg.norm(res - res_j) <= 8e-2 * np.linalg.norm(res_j)
    assert float(ft_f["loss"]) == pytest.approx(float(ft_j["loss"]),
                                                rel=1e-2)


SSM_TINY = dict(TINY, family="ssm", d_ff=0, ssm_state=16, ssm_headdim=16,
                ssm_chunk=4)


@pytest.fixture(scope="module")
def tiny_ssm():
    """`tiny` for the SSM family (a 2-layer Mamba2 stack, f32 weights):
    the JAX runner's round of k = 4 units (EMBED, FWD x 2, HEAD) over a
    prefilled state. The reference runner's units run without kernels,
    since it cannot push its K3 through autodiff (ROADMAP.md §3)."""
    jcfg = JModelConfig(**SSM_TINY, lora=JLoRAConfig(rank=4))
    tcfg = ModelConfig(**SSM_TINY, lora=LoRAConfig(rank=4))
    params = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    pc = JP.PeftConfig(micro_batch=2, seq_len=8, accum=1)
    staged = jdata.Prefetcher(jdata.SyntheticCorpus(
        jdata.DataConfig(128, 8, 2)).batches(), 2).stacked()
    ft0 = JP.init_ft_state(jcfg, pc, params, jax.random.PRNGKey(1), staged)
    rng = np.random.default_rng(3)
    for v in ft0["adapters"]["scan"].values():
        v["b"] = jnp.asarray(rng.normal(size=v["b"].shape).astype(np.float32)
                             * 0.05)
    ft0 = jax.tree.map(np.asarray, ft0)
    prompts = rng.integers(0, 128, size=(3, 7)).astype(np.int32)
    _, cache0 = JMD.prefill(params, jcfg, {"tokens": jnp.asarray(prompts)},
                            JMD.init_cache(jcfg, 3, 32, dtype=jnp.float32))
    cache0 = jax.tree.map(np.asarray, cache0)
    tok = np.array([1, 2, 3], np.int32)
    pos = np.array([7, 7, 7], np.int32)
    runner = JRunner(jcfg, params, jcfg, params, pc, k_max=4, donate=False)
    out = jax.tree.map(np.asarray, runner.run_round(4, tok, pos, cache0, ft0))
    return tcfg, params, ft0, cache0, tok, pos, out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_colocated_round_equals_decode_plus_units(tiny_ssm, use_kernels):
    """The mamba2 mirror of test_colocated_round_equals_decode_plus_units:
    bit-equal to an SSM decode step plus 4 separate units inside torch,
    and within tolerance of the JAX runner. LoRA on the SSM family is the
    parallel `ssm_io` adapter (plain matmuls) and the units keep the
    differentiable scan, so no kernel is called with the kernels on."""
    tcfg, params_j, ft0_j, cache0_j, tok, pos, (lg_j, cache_j, ft_j) = \
        tiny_ssm
    params = to_torch(params_j)
    pc = TP.PeftConfig(micro_batch=2, seq_len=8, accum=1)
    ft0, cache0 = to_torch(ft0_j), to_torch(cache0_j)
    tok_t, pos_t = torch.from_numpy(tok), torch.from_numpy(pos)

    runner = C.ColocatedRunner(tcfg, params, tcfg, params, pc, k_max=4,
                               use_kernels=use_kernels)
    calls = (K1.PLAIN_CALLS, K2.PLAIN_CALLS, K3.PLAIN_CALLS)
    lg_f, cache_f, ft_f = runner.run_round(4, tok_t, pos_t, _clone(cache0),
                                           _clone(ft0))
    assert (K1.PLAIN_CALLS, K2.PLAIN_CALLS, K3.PLAIN_CALLS) == calls
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
    assert ft_f["unit_idx"] == 4

    # against the JAX runner: the f32 decode and its f32 state h to 2e-4,
    # as the dense round; the bf16 conv window to one bf16 rounding; the
    # units' bf16 stream to the dense round's bf16 noise
    np.testing.assert_allclose(_f32(lg_f), lg_j, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_f32(cache_f["scan"]["h"]),
                               cache_j["scan"]["h"], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_f32(cache_f["scan"]["conv"]),
                               np.asarray(cache_j["scan"]["conv"],
                                          np.float32), atol=1e-2, rtol=1e-2)
    assert float(ft_f["loss"]) == pytest.approx(float(ft_j["loss"]),
                                                rel=1e-2)
    dx, dx_j = _f32(ft_f["x"]), np.asarray(ft_j["x"], np.float32)
    assert np.linalg.norm(dx - dx_j) <= 5e-2 * np.linalg.norm(dx_j)
    res, res_j = _f32(ft_f["residuals"]), np.asarray(ft_j["residuals"],
                                                     np.float32)
    assert np.linalg.norm(res - res_j) <= 2e-2 * np.linalg.norm(res_j)


def test_graphs_on_the_cpu_raise():
    """CUDA graphs exist only on the card: the CPU runs eager rounds by
    default, and asking for graphs there raises (nothing falls back)."""
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=12, accum=1)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ServingEngine(cfg, params, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        C.ColocatedRunner(cfg, params, cfg, params, pc, graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        C.make_ft_only_step(cfg, params, pc, units=1, graphs=True)
    eng = ServingEngine(cfg, params, device="cpu")
    assert not eng.graphs
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        eng.precompile()
    assert not C.ColocatedRunner(cfg, params, cfg, params, pc).graphs


def test_variant_clamps_and_ft_only_burst():
    cfg = smoke_config("qwen3-8b")                  # qk_norm on the path
    params = TMD.init_params(cfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=12, accum=1)
    pf = Prefetcher(SyntheticCorpus(
        DataConfig(cfg.vocab_size, 12, 2, seed=1)).batches(), pc.n_stage)
    state = TP.init_ft_state(cfg, pc, params, 0, pf.stacked())
    burst = C.make_ft_only_step(cfg, params, pc, units=3)
    assert burst(state)["unit_idx"] == 3
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=2)
    assert runner.variant(9).args == (2,) and runner.variant(-1).args == (0,)
    runner.precompile()                             # eager: nothing to do


# ------------------------------------------------- predictor, scheduler --
def _samples(seed):
    rng = np.random.default_rng(seed)
    solo = {q: [(bs, s, bs * 1e-4 + 0.01 + bs * 2e-7 * s / q
                 + rng.normal() * 1e-4)
                for bs in (1, 4, 8) for s in (64, 256, 512)]
            for q in (0.5, 1.0)}
    colo = [(1 - k / 6, k / 6, bs, s, 0.012 + bs * 1e-4 + k * 3e-3
             + bs * s * 1e-7 * (1 + k / 6) + rng.normal() * 2e-4)
            for k in (1, 3, 6) for bs in (1, 4, 8) for s in (64, 512)]
    mixed = [(k / 6, bs, s, ct, 0.015 + ct * 2e-5 + k * 3e-3
              + rng.normal() * 1e-4)
             for k in (0, 3) for bs in (1, 8) for s in (64, 512)
             for ct in (64, 256)]
    return solo, colo, mixed


def test_predictor_and_scheduler_match_reference():
    solo, colo, mixed = _samples(0)
    preds = []
    for cls in (JPred, TwoStageLatencyPredictor):
        p = cls(k_max=6)
        p.fit_solo(solo)
        p.fit_colo(colo)
        p.fit_mixed([m for m in mixed if m[0] == 0])
        p.fit_mixed_fused(mixed)
        preds.append(p)
    pj, pt = preds
    for q in pj.solo_coef:
        np.testing.assert_allclose(pt.solo_coef[q], pj.solo_coef[q],
                                   rtol=1e-12, atol=1e-12)
    for name in ("colo_coef", "colo_lr_coef", "mixed_coef",
                 "mixed_fused_coef"):
        np.testing.assert_allclose(getattr(pt, name), getattr(pj, name),
                                   rtol=1e-12, atol=1e-12)
    for f in ("solo_mean_err", "colo_mean_err", "colo_paper_max_err",
              "mixed_max_err", "mixed_fused_mean_err"):
        assert getattr(pt.report, f) == pytest.approx(
            getattr(pj.report, f), rel=1e-12, abs=1e-15)
    for q_ft in (0.0, 0.5, 1.0):
        for form in ("paper", "roofline-max"):
            assert pt.predict_colo(q_ft, 5, 300, form) == pytest.approx(
                pj.predict_colo(q_ft, 5, 300, form), rel=1e-12)
        assert pt.predict_mixed_fused(q_ft, 5, 300, 128) == pytest.approx(
            pj.predict_mixed_fused(q_ft, 5, 300, 128), rel=1e-12)
        assert pt.max_chunk_tokens(q_ft, 5, 300, 0.05, 512) == \
            pj.max_chunk_tokens(q_ft, 5, 300, 0.05, 512)
    assert pt.predict_latency_us() < 1000.0

    # a target that admits some quanta at small batch and context, none at
    # large
    qos = pj.predict_colo(0.5, 4, 200) / 0.95
    sj = JSched(pj, JSchedCfg(qos_s=qos, k_max=6))
    st = QoSScheduler(pt, SchedulerConfig(qos_s=qos, k_max=6))
    lat = np.random.default_rng(1).uniform(0.5, 1.5, size=200) * qos
    i = 0
    for bs in (0, 1, 3, 8):
        for ctx in (32, 200, 900, 5000):
            for ready, avail in ((True, 6), (True, 2), (False, 0)):
                dj = sj.pick(bs, ctx, ft_ready=ready, ft_units_available=avail)
                dt = st.pick(bs, ctx, ft_ready=ready, ft_units_available=avail)
                assert (dt.k, dt.reason) == (dj.k, dj.reason)
                assert dt.predicted_s == pytest.approx(dj.predicted_s,
                                                       rel=1e-12)
                sj.observe(lat[i])
                st.observe(lat[i])
                i += 1
                assert st.margin == sj.margin
    assert {d.reason for d in st.decisions} == {"ok", "qos", "stalled",
                                                "idle"}
    assert st.violations == sj.violations > 0


# ------------------------------------------------------ end to end, CPU --
def test_colocated_serving_end_to_end():
    """Mirrors tests/test_system.py::test_colocated_serving_end_to_end with
    the predictor fit from rounds measured here, and the QoS target set as
    chip_smoke.py sets it: 1.5x the measured median solo round, raised to
    where the fit admits one unit at the profiled corners even with the
    scheduler's margin at its floor (CPU round times are noisy)."""
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, max_slots=3, s_max=96,
                        use_kernels=True, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=16, accum=1)
    pf = Prefetcher(SyntheticCorpus(
        DataConfig(cfg.vocab_size, 16, 2, seed=0)).batches(), pc.n_stage)
    ft_state = TP.init_ft_state(cfg, pc, params, 0, pf.stacked())
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=4,
                               use_kernels=True)
    solo, colo, ft_state = C.profile_rounds(
        runner, eng.cache, ft_state, batch_sizes=(1, 3), contexts=(8, 40),
        ks=(2, 4), repeats=1)
    assert len(solo[1.0]) == 4 and len(colo) == 8
    pred = C.fit_predictor(4, solo, colo)
    qos = 1.5 * float(np.median([s for *_, s in solo[1.0]]))
    admit_one = max(pred.predict_colo(1 / 4, bs, ctx) for bs in (1, 3)
                    for ctx in (8, 40)) / SchedulerConfig.margin_floor
    sched = QoSScheduler(pred, SchedulerConfig(qos_s=max(qos, admit_one),
                                               k_max=4))
    it0, units0 = ft_state["iter"], ft_state["unit_idx"]

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=0.0, prompt_len=int(rng.integers(6, 14)),
                    max_new_tokens=5) for i in range(5)]
    k2 = K2.PLAIN_CALLS
    m, ft_state = C.run_colocated_trace(eng, runner, sched, ft_state, reqs,
                                        max_rounds=200)
    assert all(r.phase == Phase.DONE for r in reqs)
    assert m.ft_units > 0, "no finetune units ran"
    assert len(sched.decisions) == m.decode_rounds
    assert sum(d.k for d in sched.decisions) == m.ft_units
    assert ft_state["iter"] > it0 or ft_state["unit_idx"] != units0
    assert K2.PLAIN_CALLS > k2          # the adapted projections went through


def test_serve_entry_point_colocates_mamba2_on_cpu():
    m = serve.main(["--smoke", "--device", "cpu", "--colocate",
                    "--use-kernels", "--arch", "mamba2-780m", "--requests",
                    "3", "--slots", "2", "--s-max", "64", "--k-max", "2",
                    "--qos-s", "10"])
    assert m.prefills == 3 and m.decode_rounds > 0
    assert m.ft_units == 2 * m.decode_rounds


def test_serve_entry_point_colocates_on_cpu():
    m = serve.main(["--smoke", "--device", "cpu", "--colocate",
                    "--use-kernels", "--requests", "3", "--slots", "2",
                    "--s-max", "64", "--k-max", "2", "--qos-s", "10"])
    assert m.prefills == 3 and m.decode_rounds > 0
    assert m.ft_units == 2 * m.decode_rounds     # a 10 s target admits k_max


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("colocate", [False, True])
def test_serve_entry_point_runs_the_windowed_models_on_cpu(arch, colocate):
    """`launch/serve.py --arch mixtral-8x7b | h2o-danube-1.8b --smoke
    --device cpu --use-kernels [--colocate]`: s_max 96 against the smoke
    window of 64, so profiling decodes on a wrapped ring; K1's wrapper
    once per layer per round."""
    k1 = K1.PLAIN_CALLS
    argv = ["--smoke", "--device", "cpu", "--use-kernels", "--arch", arch,
            "--requests", "3", "--slots", "2", "--s-max", "96"]
    if colocate:
        argv += ["--colocate", "--k-max", "2", "--qos-s", "10"]
    m = serve.main(argv)
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K1.PLAIN_CALLS - k1 >= 2 * m.decode_rounds
    if colocate:
        assert m.ft_units == 2 * m.decode_rounds


@pytest.mark.parametrize("colocate", [False, True])
def test_serve_entry_point_runs_deepseek_on_cpu(colocate):
    """`launch/serve.py --arch deepseek-v3-671b --smoke --device cpu
    --use-kernels [--colocate]`: MLA decode runs no K1; co-located, the
    units run K2's wrapper on the "pre" and scanned layers' adapters."""
    k1, k2 = K1.PLAIN_CALLS, K2.PLAIN_CALLS
    argv = ["--smoke", "--device", "cpu", "--use-kernels", "--arch",
            "deepseek-v3-671b", "--requests", "3", "--slots", "2",
            "--s-max", "64"]
    if colocate:
        argv += ["--colocate", "--k-max", "2", "--qos-s", "10"]
    m = serve.main(argv)
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K1.PLAIN_CALLS == k1
    assert (K2.PLAIN_CALLS > k2) == colocate
    if colocate:
        assert m.ft_units == 2 * m.decode_rounds
