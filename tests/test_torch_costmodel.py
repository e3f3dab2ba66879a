"""The port's roofline cost model and `fit_from_costmodel` against the JAX
package's: on the reference's TPU spec and constants (imported from
`repro.hw` and `repro.core.costmodel`, the port carries neither) every
method returns the reference's numbers, seeded noise included, and the
predictor fit from it has the reference's coefficients. On the port's own
H100 spec, rounds grow with batch, context and k."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import hw as JHW  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.core import predictor as JPR  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import hw as THW  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core import predictor as TPR  # noqa: E402

ARCHS = ["llama3-8b", "mamba2-780m", "mixtral-8x7b", "h2o-danube-1.8b"]
WIDTHS = ["get_config", "smoke_config"]


def _tpu_instance() -> TCM.InstanceSpec:
    """The reference's default instance (TPU v5e, tp 8, its constants) in
    the port's types."""
    consts = TCM.CostConstants(
        mxu_eff=JCM.MXU_EFF, bw_eff=JCM.BW_EFF, overlap_eff=JCM.OVERLAP_EFF,
        step_overhead_s=JCM.STEP_OVERHEAD_S,
        per_layer_overhead_s=JCM.PER_LAYER_OVERHEAD_S,
        unit_overhead_s=JCM.UNIT_OVERHEAD_S,
        bw_sat_quantum=JCM.BW_SAT_QUANTUM)
    ref = JCM.InstanceSpec()
    assert ref.chip == JHW.TPU_V5E
    return TCM.InstanceSpec(
        chip=THW.ChipSpec(**dataclasses.asdict(JHW.TPU_V5E)), tp=ref.tp,
        consts=consts)


def _pair(arch, width, seed=0):
    jcm = JCM.CostModel(getattr(jconfigs, width)(arch), JCM.InstanceSpec(),
                        seed=seed)
    tcm = TCM.CostModel(getattr(tconfigs, width)(arch), _tpu_instance(),
                        seed=seed)
    return jcm, tcm


# every method, in one order (the noisy ones draw from the seeded rng, so
# the order is part of what is compared)
CALLS = [
    ("decode_work", lambda m: dataclasses.astuple(m.decode_work(8, 300.0))),
    ("decode_work long", lambda m: dataclasses.astuple(
        m.decode_work(3, 5000.0))),
    ("decode_solo", lambda m: m.decode_solo(16, 256)),
    ("decode_solo q 0.3", lambda m: m.decode_solo(4, 512, quantum=0.3)),
    ("decode_solo q 0", lambda m: m.decode_solo(64, 64, quantum=0.0)),
    ("decode_solo quiet", lambda m: m.decode_solo(8, 128, noisy=False)),
    ("colocated_round", lambda m: m.colocated_round(16, 256, 3, 2, 1024)),
    ("colocated_round k 0", lambda m: m.colocated_round(4, 128, 0, 2, 1024)),
    ("colocated_round window", lambda m: m.colocated_round(
        8, 512, 5, 2, 1024, unit_weights_resident=False)),
    ("colocated_round quiet", lambda m: m.colocated_round(
        64, 512, 9, 4, 512, noisy=False)),
    ("chunk_work", lambda m: dataclasses.astuple(m.chunk_work(256, 128.0))),
    ("mixed_round_latency", lambda m: m.mixed_round_latency(
        16, 256, 128, chunk_ctx=256)),
    ("mixed_round_latency k", lambda m: m.mixed_round_latency(
        4, 512, 64, chunk_ctx=512, k_units=5, micro_batch=2, seq_len=1024)),
    ("mixed_round_latency bs 0", lambda m: m.mixed_round_latency(0, 0, 512)),
    ("mixed_round_latency no chunk", lambda m: m.mixed_round_latency(
        8, 300, 0, noisy=False)),
    ("prefill_latency", lambda m: m.prefill_latency(500)),
    ("prefill_latency bs", lambda m: m.prefill_latency(4096, bs=3)),
    ("prefill_batch_latency", lambda m: m.prefill_batch_latency(
        [17, 300, 4500])),
    ("prefill_batch_latency empty", lambda m: m.prefill_batch_latency([])),
    ("unit_work fwd", lambda m: dataclasses.astuple(m.unit_work(2, 1024))),
    ("unit_work bwd", lambda m: dataclasses.astuple(
        m.unit_work(2, 1024, backward=True))),
    ("avg_unit_work", lambda m: dataclasses.astuple(m.avg_unit_work(4, 512))),
    ("unit_solo", lambda m: m.unit_solo(2, 1024)),
    ("unit_solo bwd", lambda m: m.unit_solo(2, 1024, backward=True)),
    ("layer_swap_time", lambda m: m.layer_swap_time(2, 1024)),
    ("checkpoint_time", lambda m: m.checkpoint_time()),
    ("adapter_load_time", lambda m: m.adapter_load_time(3e7)),
    ("adapter_load_time setup", lambda m: m.adapter_load_time(
        1e6, setup_s=0.0)),
    ("kv_migration_time", lambda m: m.kv_migration_time(700, 25e9)),
    ("kv_migration_time setup", lambda m: m.kv_migration_time(
        5000, 0.0, setup_s=1e-3)),
    ("decode_utilization", lambda m: m.decode_utilization(16, 256)),
    ("_noise", lambda m: m._noise()),
]


def _close(got, expect):
    got, expect = np.atleast_1d(got), np.atleast_1d(expect)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=0)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_costmodel_equals_reference_on_the_tpu_spec(arch, width):
    jcm, tcm = _pair(arch, width, seed=3)
    for name, call in CALLS:
        got, expect = call(tcm), call(jcm)
        try:
            _close(got, expect)
        except AssertionError as e:
            raise AssertionError(f"{name}: {got} vs {expect}") from e
    # the two rngs drew the same numbers in the same order
    assert tcm.rng.random() == jcm.rng.random()


@pytest.mark.parametrize("arch", ARCHS)
def test_noise_off_and_zero_sigma_equal_reference(arch):
    jcm = JCM.CostModel(jconfigs.get_config(arch), JCM.InstanceSpec(),
                        noise_sigma=0.0)
    tcm = TCM.CostModel(tconfigs.get_config(arch), _tpu_instance(),
                        noise_sigma=0.0)
    for name, call in CALLS:
        _close(call(tcm), call(jcm))


def _coefficients(pred):
    solo = [pred.solo_coef[q] for q in sorted(pred.solo_coef)]
    return (sorted(pred.solo_coef), solo, pred.colo_coef, pred.colo_lr_coef,
            pred.mixed_coef, pred.mixed_fused_coef)


@pytest.mark.parametrize("k_max", [10, 6, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_fit_from_costmodel_coefficients_equal_reference(arch, k_max):
    jcm, tcm = _pair(arch, "get_config")
    jp = JPR.TwoStageLatencyPredictor(k_max=k_max)
    tp = TPR.TwoStageLatencyPredictor(k_max=k_max)
    jrep = jp.fit_from_costmodel(jcm)
    trep = tp.fit_from_costmodel(tcm)
    jc, tc = _coefficients(jp), _coefficients(tp)
    assert tc[0] == jc[0]
    for got, expect in zip(tc[1:], jc[1:]):
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                                   rtol=1e-12, atol=0)
    for f in ("solo_samples", "colo_samples", "mixed_samples",
              "mixed_fused_samples"):
        assert getattr(trep, f) == getattr(jrep, f)
    for f in ("solo_mean_err", "solo_max_err", "colo_mean_err",
              "colo_max_err", "colo_paper_mean_err", "mixed_mean_err",
              "mixed_fused_max_err"):
        _close(getattr(trep, f), getattr(jrep, f))
    assert TPR.PROFILE_BS == JPR.PROFILE_BS
    assert TPR.PROFILE_SEQLENS == JPR.PROFILE_SEQLENS
    for args in ((0.3, 16, 256), (0.5, 4, 500), (0.0, 64, 64)):
        _close(tp.predict_colo(*args), jp.predict_colo(*args))


def test_h100_is_the_default_instance():
    inst = TCM.InstanceSpec()
    assert inst.chip is THW.H100_SXM is THW.DEFAULT_CHIP and inst.tp == 1
    assert inst.consts is TCM.H100_CONSTANTS
    assert not hasattr(THW, "TPU_V5E")
    c = TCM.H100_CONSTANTS
    assert 0 < c.mxu_eff <= 1 and 0 < c.bw_eff <= 1
    assert 0 <= c.overlap_eff <= 1 and 0 < c.bw_sat_quantum <= 1
    assert min(c.step_overhead_s, c.per_layer_overhead_s,
               c.unit_overhead_s) >= 0
    # llama3-8b's LoRA state: 41,943,040 trainable parameters x (bf16
    # weight + two f32 moments) over PCIe Gen5 x16's 64 GB/s
    cfg = tconfigs.get_config("llama3-8b")
    assert cfg.lora_param_count() == 41_943_040
    assert TCM.CostModel(cfg).checkpoint_time() == \
        41_943_040 * 10.0 / THW.H100_SXM.host_dma_bw


@pytest.mark.parametrize("arch", ARCHS)
def test_h100_rounds_grow_with_batch_context_and_k(arch):
    cm = TCM.CostModel(tconfigs.get_config(arch))
    solo = [cm.decode_solo(bs, 256, noisy=False) for bs in (1, 4, 16, 64)]
    assert all(a < b for a, b in zip(solo, solo[1:])), solo
    ctx = [cm.decode_solo(8, c, noisy=False)
           for c in (64, 256, 1024, 4096, 16384)]
    assert all(a <= b for a, b in zip(ctx, ctx[1:])), ctx
    colo = [cm.colocated_round(8, 256, k, 2, 1024, noisy=False)
            for k in range(7)]
    assert all(a < b for a, b in zip(colo, colo[1:])), colo
    assert colo[0] >= cm.decode_solo(8, 256, noisy=False)
