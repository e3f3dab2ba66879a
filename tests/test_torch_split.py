"""The SM split of the co-located rounds on the CPU: its size
(`partition.split_sizes`), which the card's driver rounds to its SM
granularity; asking for a split off the card raises (nothing falls back to
sequential rounds without a word); the CPU's runner runs sequential eager
rounds. The split itself, its probe and the overlapped rounds run on the
card
(`tests/test_torch_gpu.py`, `chip_smoke.py` phase 7b)."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.core import partition as SP  # noqa: E402
from repro_torch.core.costmodel import H100_CONSTANTS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402


@pytest.mark.parametrize("sms,granule,quantum", [
    (132, 8, 0.45),      # the H100: 59.4 rounds up to 64
    (132, 8, 64 / 132),  # 64 exactly: no rounding
    (132, 8, 0.01),      # below one granule: one granule
    (132, 8, 0.99),      # past the largest split: the units keep a granule
    (132, 8, 1.0),
    (132, 1, 0.45),      # granule 1: ceil only
    (16, 8, 0.3),        # the smallest device two granules make
    (20, 8, 0.75),       # clamped; the remainder goes to the units
    (144, 2, 0.5)])
def test_split_sizes(sms, granule, quantum):
    """Decode's side is ceil(quantum x sms) rounded up to the granularity,
    unless that leaves the units less than a granule: then it is the
    largest multiple that leaves them one. Both sides hold at least a
    granule and together the whole device."""
    decode, units = SP.split_sizes(sms, granule, quantum)
    assert decode + units == sms
    assert decode % granule == 0
    assert decode >= granule and units >= granule
    want = math.ceil(math.ceil(round(quantum * sms, 9)) / granule) * granule
    largest = (sms - granule) // granule * granule
    assert decode == min(max(want, granule), largest)
    if want <= largest:
        assert decode - granule < quantum * sms <= decode


def test_split_of_the_h100():
    """0.45 of 132 SMs is 59.4, rounded up to the driver's granule of 8 on
    the H100: decode 64 SMs, the units 68."""
    assert SP.split_sizes(132, 8, 0.45) == (64, 68)
    assert SP.split_sizes(132, 8, H100_CONSTANTS.bw_sat_quantum)[0] >= \
        math.ceil(H100_CONSTANTS.bw_sat_quantum * 132)


@pytest.mark.parametrize("sms,granule,quantum", [
    (8, 8, 0.5), (15, 8, 0.5), (132, 0, 0.45), (132, 8, 0.0),
    (132, 8, 1.5), (132, 8, -0.1)])
def test_split_sizes_refuse(sms, granule, quantum):
    with pytest.raises(ValueError):
        SP.split_sizes(sms, granule, quantum)


def test_split_off_the_card_raises():
    """A split is asked for off the card: the runner, `resolve`, `Split`
    and the SM count raise; nothing runs sequential rounds in its place."""
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    pc = TP.PeftConfig(micro_batch=2, seq_len=12, accum=1)
    with pytest.raises(ValueError, match="an SM split needs a CUDA device"):
        C.ColocatedRunner(cfg, params, cfg, params, pc, split=True)
    with pytest.raises(ValueError, match="an SM split needs a CUDA device"):
        SP.resolve(True, "cpu")
    with pytest.raises(ValueError, match="an SM split needs a CUDA device"):
        SP.Split("cpu", 8)
    with pytest.raises(ValueError, match="an SM split needs a CUDA device"):
        SP.split_for("cpu")
    assert SP.resolve(None, "cpu") is False
    assert SP.resolve(False, "cpu") is False
    assert SP.resolve(None, "cuda") is True
    assert SP.resolve(False, "cuda") is False
    for split in (None, False):
        runner = C.ColocatedRunner(cfg, params, cfg, params, pc, split=split)
        assert runner.split is None and not runner.graphs


def test_the_partition_source_is_built():
    """`csrc/sm_partition.cu` is one of the sources `build_all` compiles
    beside the kernels'."""
    assert "sm_partition" in build._sources()
    assert set(build._sources()) >= {"decode_attention", "lora_matmul",
                                     "ssd_scan"}
