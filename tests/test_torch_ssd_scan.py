"""The SSD chunked scan (K3) of the port against the JAX package: its plain
version (what the wrapper runs for CPU tensors) against the reference's
`models/ssm.py::ssd_chunked`, the sequential recurrence
`kernels/ref.py::ssd_sequential_ref` and the Pallas kernel through
`kernels/ops.py::ssd_scan` (interpret mode on the CPU), at
`tests/test_kernels.py`'s 2e-3: the chunked form reassociates the
recurrence's sums and products. Inputs are made with numpy from a seed."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import ssd_sequential_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

TOL = 2e-3
_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


def _inputs(B, S, nh, hd, ds, seed=0, h0=False, dtype=np.float32):
    """test_kernels.py's distributions: dt = softplus(N(0, 1)),
    A = -exp(0.3 N(0, 1)); xs, Bt, Ct (and h0) scaled normals."""
    rng = np.random.default_rng(seed)
    out = {
        "xs": (rng.normal(size=(B, S, nh, hd)) * 0.5).astype(dtype),
        "dt": np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(
            np.float32),
        "A": (-np.exp(rng.normal(size=(nh,)) * 0.3)).astype(np.float32),
        "Bt": (rng.normal(size=(B, S, ds)) * 0.3).astype(dtype),
        "Ct": (rng.normal(size=(B, S, ds)) * 0.3).astype(dtype),
    }
    out["h0"] = (rng.normal(size=(B, nh, hd, ds)) * 0.2).astype(np.float32) \
        if h0 else None
    return out


def _close(t, j):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=TOL, rtol=TOL)


def _port(a, chunk):
    t = to_torch(a)
    return K3.ssd_scan(t["xs"], t["dt"], t["A"], t["Bt"], t["Ct"], chunk,
                       h0=t["h0"])


def _jax(a):
    return {k: None if v is None else jnp.asarray(v) for k, v in a.items()}


CASES = [  # B, S, nh, hd, ds, chunk, h0
    (2, 32, 8, 16, 32, 8, False),        # test_ssd_scan_kernel's shapes
    (1, 50, 4, 8, 16, 16, False),        # ragged tail chunk
    (2, 64, 16, 32, 64, 32, False),
    (1, 24, 4, 8, 16, 8, True),          # test_ssd_scan_with_initial_state
    (2, 71, 4, 16, 16, 256, True),       # c = S = 71, one chunk
    (1, 45, 2, 8, 16, 19, True),         # c 19: 3 chunks, ragged tail of 7
]


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,h0", CASES)
def test_plain_matches_chunked_sequential_and_pallas(B, S, nh, hd, ds, chunk,
                                                     h0):
    a = _inputs(B, S, nh, hd, ds, seed=S + chunk, h0=h0)
    before = K3.PLAIN_CALLS
    y, hT = _port(a, chunk)
    assert K3.PLAIN_CALLS == before + 1
    assert y.shape == (B, S, nh, hd) and y.dtype == torch.float32
    assert hT.shape == (B, nh, hd, ds) and hT.dtype == torch.float32
    j = _jax(a)
    args = (j["xs"], j["dt"], j["A"], j["Bt"], j["Ct"])
    for yr, hr in (j_ssd_chunked(*args, chunk, h0=j["h0"]),
                   ssd_sequential_ref(*args, h0=j["h0"]),
                   jops.ssd_scan(*args, chunk, h0=j["h0"])):
        _close(y, yr)
        _close(hT, hr)


def test_bf16_inputs_match_reference():
    """xs/Bt/Ct in bf16 and dt in f32, as `ssm_prefill` feeds the scan;
    both sides widen the same bf16 values to f32."""
    a = _inputs(2, 40, 4, 16, 32, seed=5, h0=True)
    for k in ("xs", "Bt", "Ct"):
        a[k] = np.asarray(jnp.asarray(a[k], jnp.bfloat16))
    y, hT = _port(a, 16)
    assert to_torch(a)["xs"].dtype == torch.bfloat16
    j = _jax(a)
    yr, hr = j_ssd_chunked(j["xs"], j["dt"], j["A"], j["Bt"], j["Ct"], 16,
                           h0=j["h0"])
    _close(y, yr)
    _close(hT, hr)


def test_ops_adapter_and_model_scan_agree():
    """`ops.ssd_scan` (K3 as the model calls it) and `ssm.ssd_chunked`
    (the training path's plain scan) are the same function on the CPU, bit
    for bit."""
    t = to_torch(_inputs(1, 30, 4, 8, 16, seed=9, h0=True))
    args = (t["xs"], t["dt"], t["A"], t["Bt"], t["Ct"], 8)
    for got, expect in zip(kops.ssd_scan(*args, h0=t["h0"]),
                           TSSM.ssd_chunked(*args, h0=t["h0"])):
        assert torch.equal(got, expect)


def test_decay_is_masked_before_exp():
    """A steep decay (cum_i - cum_j ~ +2000 for j > i) must not overflow
    into inf * 0 = nan in the masked upper triangle."""
    a = _inputs(1, 32, 2, 8, 16, seed=3)
    a["dt"] = np.full_like(a["dt"], 8.0)
    a["A"] = np.full_like(a["A"], -16.0)
    y, hT = _port(a, 32)
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    j = _jax(a)
    yr, hr = ssd_sequential_ref(j["xs"], j["dt"], j["A"], j["Bt"], j["Ct"])
    _close(y, yr)
    _close(hT, hr)


def test_scan_refuses_a_gradient():
    """K3 is forward-only: asking it for a gradient raises on any device,
    naming ROADMAP, and never falls back; under no_grad it runs."""
    t = to_torch(_inputs(1, 16, 2, 8, 16, seed=4))
    xs = t["xs"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ROADMAP"):
        kops.ssd_scan(xs, t["dt"], t["A"], t["Bt"], t["Ct"], 8)
    with pytest.raises(RuntimeError, match="forward-only"):
        K3.ssd_scan(t["xs"], t["dt"], t["A"].requires_grad_(), t["Bt"],
                    t["Ct"], 8)
    with torch.no_grad():
        y, _ = kops.ssd_scan(xs, t["dt"], t["A"], t["Bt"], t["Ct"], 8)
    assert not y.requires_grad
    # the training path's plain scan is differentiable
    y, _ = TSSM.ssd_chunked(xs, t["dt"], t["A"].detach(), t["Bt"], t["Ct"], 8)
    y.sum().backward()
    assert torch.isfinite(xs.grad).all() and xs.grad.abs().sum() > 0


def test_wrapper_rejects_bad_inputs():
    t = to_torch(_inputs(1, 16, 2, 8, 16, seed=6))
    with pytest.raises(ValueError, match="shape mismatch"):
        K3.ssd_scan(t["xs"], t["dt"][:, :8], t["A"], t["Bt"], t["Ct"], 8)
    with pytest.raises(ValueError, match="expected"):
        K3.ssd_scan(t["xs"][0], t["dt"], t["A"], t["Bt"], t["Ct"], 8)
    with pytest.raises(ValueError, match="unsupported device"):
        K3.ssd_scan(*(v.to("meta") for k, v in t.items() if k != "h0"), 8)


# ------------------------------------------- the kernel's route and plan --
def _conv_slices(B, S, nh, hd, ds, dtype, offset=0):
    """xs, Bt and Ct as `ssm_prefill` hands them to the scan: strided views
    of one (B, S, nh*hd + 2*ds) conv output, `offset` elements into it."""
    w = nh * hd + 2 * ds
    conv = torch.zeros(B * S * w + offset, dtype=dtype)[offset:].view(B, S, w)
    return (conv[..., :nh * hd].reshape(B, S, nh, hd),
            conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:])


@pytest.mark.parametrize("B,S,nh,hd,ds,dtype,offset,path", [
    (1, 512, 48, 64, 128, torch.bfloat16, 0, "tc"),    # mamba2-780m prefill
    (2, 71, 48, 64, 128, torch.bfloat16, 0, "tc"),
    (2, 200, 4, 32, 64, torch.bfloat16, 0, "tc"),      # below the tile
    (1, 512, 48, 64, 128, torch.float32, 0, "f32"),    # f32 inputs
    (2, 200, 2, 40, 100, torch.bfloat16, 0, "f32"),    # Ct 360 B in: unaligned
    (1, 64, 4, 64, 128, torch.bfloat16, 4, "f32"),     # base 8 B off
    (1, 64, 4, 36, 128, torch.bfloat16, 0, "f32"),     # head stride 72 B
])
def test_k3_path_routes_by_dtype_and_alignment(B, S, nh, hd, ds, dtype,
                                               offset, path):
    """bf16 slices of the conv output at mamba2 width go to the tensor-core
    kernel; f32, and bf16 rows that 16-byte copies cannot read, to the FMA
    kernel."""
    assert K3._k3_path(*_conv_slices(B, S, nh, hd, ds, dtype, offset)) == \
        path


def test_cpu_call_launches_nothing():
    t = to_torch(_inputs(1, 40, 4, 16, 32, seed=8, h0=True))
    for k in ("xs", "Bt", "Ct"):
        t[k] = t[k].to(torch.bfloat16)
    before = (K3.LAUNCHES, K3.LAUNCHES_TC, K3.LAUNCHES_F32, K3.PLAIN_CALLS)
    K3.ssd_scan(t["xs"], t["dt"], t["A"], t["Bt"], t["Ct"], 16, h0=t["h0"])
    assert (K3.LAUNCHES, K3.LAUNCHES_TC, K3.LAUNCHES_F32, K3.PLAIN_CALLS) == \
        before[:3] + (before[3] + 1,)


# ------------------- the tensor-core kernel's arithmetic, emulated here --
# `chip_smoke.py::ssd_split_emulation`, which the card run also holds K3
# against


def _f64_witness(xs, dt, A, Bt, Ct, h0=None):
    """The SSD recurrence token by token in float64: no cumsum, no chunks."""
    B, S, nh, hd = xs.shape
    x, d, b, c = xs.double(), dt.double(), Bt.double(), Ct.double()
    a = torch.exp(d * A.double())
    h = torch.zeros((B, nh, hd, Bt.shape[-1]), dtype=torch.float64) \
        if h0 is None else h0.double()
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + \
            (d[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bs,bhps->bhp", c[:, t], h))
    return torch.stack(ys, dim=1), h


def _prefill_inputs(B, S, nh, hd, ds, seed, h0):
    """As `chip_smoke.py::k3_inputs` makes them: xs/Bt/Ct bf16 slices of
    silu(N(0, 1)), dt = softplus(N(0, 1)), A = -linspace(1, 16), h0 zeros
    (None) or N(0, 0.2)."""
    rng = np.random.default_rng(seed)
    conv = torch.nn.functional.silu(torch.from_numpy(
        rng.normal(size=(B, S, nh * hd + 2 * ds)).astype(np.float32))
        ).to(torch.bfloat16)
    xs = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bt, Ct = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(B, S, nh)).astype(np.float32)))
    A = -torch.linspace(1.0, 16.0, nh)
    h = torch.from_numpy((rng.normal(size=(B, nh, hd, ds)) * 0.2).astype(
        np.float32)) if h0 else None
    return xs, dt, A, Bt, Ct, h


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,h0", [
    (1, 512, 48, 64, 128, 256, False),   # mamba2-780m, one layer's prefill
    (2, 300, 6, 64, 128, 256, True),     # ragged last chunk, random h0
    (1, 71, 4, 40, 100, 32, True),       # 3 chunks, below the tile
])
def test_tc_split_precision_emulation_matches_f64_witness(B, S, nh, hd, ds,
                                                          chunk, h0):
    """The tensor-core kernel's rounding, emulated, is within K3's 2e-3 of
    the f64 recurrence; at full width one bf16 rounding of the f32 operands
    in place of the hi + lo split is not (the reason for the split)."""
    xs, dt, A, Bt, Ct, h = _prefill_inputs(B, S, nh, hd, ds, seed=S, h0=h0)
    yw, hw = _f64_witness(xs, dt, A, Bt, Ct, h0=h)
    y, hT = chip_smoke.ssd_split_emulation(xs, dt, A, Bt, Ct, chunk, h0=h)
    torch.testing.assert_close(y.double(), yw, atol=TOL, rtol=TOL)
    torch.testing.assert_close(hT.double(), hw, atol=TOL, rtol=TOL)
    if S == 512:
        y1, _ = chip_smoke.ssd_split_emulation(xs, dt, A, Bt, Ct, chunk, h0=h,
                                               one_rounding=True)
        assert not torch.allclose(y1.double(), yw, atol=TOL, rtol=TOL)
