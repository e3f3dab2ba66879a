"""The port's RG-LRU block (`models/rglru.py`) against the JAX package's on
the smoke config of recurrentgemma-2b: `_gates`, `rglru_forward` (output
and new state, from no state, a zero state and a random one; prompts
shorter than the conv's 3 rows of state), `rglru_decode` (output and
state), in f32 and bf16; the doubling scan against the step-by-step
recurrence, on decays down to the smallest the gates can give and over
lengths that are and are not powers of two; and its gradient against the
loop's. Weights come from the reference's init through interop; inputs
are made with numpy from a seed."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import rglru as TRG  # noqa: E402

# f32: the same ops in other orders (the doubling scan against XLA's
# associative scan, einsum contraction order); bf16: both sides round at
# the same points, but a rounding may fall the other way (tests/
# test_kernels.py's bf16 tolerance)
TOL = {jnp.float32: 2e-4, jnp.bfloat16: 3e-2}
ARCH = "recurrentgemma-2b"


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _setup(dtype, B=2, S=11, seed=0):
    jcfg = jconfigs.smoke_config(ARCH)
    p_j = JRG.rglru_init(jax.random.PRNGKey(seed), jcfg, dtype)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32),
                    dtype)
    w = jcfg.rglru_width or jcfg.d_model
    state = {"h": jnp.asarray(rng.normal(size=(B, w)) * 0.5, jnp.float32),
             "conv": jnp.asarray(rng.normal(size=(B, 3, w)) * 0.5,
                                 jnp.bfloat16)}
    return jcfg, tconfigs.smoke_config(ARCH), p_j, x, state


def test_init_names_and_shapes_match_reference():
    """The port's init has the reference's tree: names, shapes, dtypes,
    stacked or not (so `interop.to_torch` maps one onto the other)."""
    jcfg, tcfg, p_j, _, _ = _setup(jnp.bfloat16)
    for n_layers in (0, 3):
        p_t = TRG.rglru_init(torch.Generator().manual_seed(0), tcfg,
                             n_layers)
        assert p_t.keys() == p_j.keys()
        for k, v in p_j.items():
            lead = (n_layers,) if n_layers else ()
            assert tuple(p_t[k].shape) == lead + v.shape, k
            assert str(p_t[k].dtype).endswith(str(v.dtype)), k
    s_t = TRG.make_rglru_state(tcfg, 2)
    s_j = JRG.make_rglru_state(jcfg, 2)
    for k in s_j:
        assert tuple(s_t[k].shape) == s_j[k].shape
        assert str(s_t[k].dtype).endswith(str(s_j[k].dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gates_match_reference(dtype):
    """a and sqrt(1 - a^2) i x, f32 both, on inputs large enough that the
    recurrence gate saturates (a down to exp(-8 softplus(4)))."""
    _, _, p_j, x, _ = _setup(dtype)
    xb = x * 4
    a_j, bx_j = JRG._gates(p_j, xb)
    a_t, bx_t = TRG._gates(to_torch(p_j), to_torch(xb))
    assert a_t.dtype == bx_t.dtype == torch.float32
    _close(a_t, a_j, 2e-5)
    _close(bx_t, bx_j, TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("state", ["none", "zeros", "random"])
@pytest.mark.parametrize("S", [1, 2, 11, 16])
def test_forward_matches_reference(dtype, state, S):
    """Output and, with a state, the new state (h: the scan's last row;
    conv: the last 3 rows of the padded input, whatever the length)."""
    jcfg, tcfg, p_j, x, st = _setup(dtype, S=S)
    if state == "zeros":
        st = JRG.make_rglru_state(jcfg, x.shape[0])
    st = None if state == "none" else st
    out_j, new_j = JRG.rglru_forward(p_j, x, jcfg, state=st)
    out_t, new_t = TRG.rglru_forward(to_torch(p_j), to_torch(x), tcfg,
                                     state=to_torch(st))
    _close(out_t, out_j, TOL[dtype])
    if st is None:
        assert new_t is None and new_j is None
        return
    _close(new_t["h"], new_j["h"], TOL[dtype])
    assert new_t["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(new_t["conv"]).view(np.uint16),
                                  np.asarray(new_j["conv"]).view(np.uint16))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_matches_reference(dtype):
    jcfg, tcfg, p_j, x, st = _setup(dtype, S=1)
    out_j, new_j = JRG.rglru_decode(p_j, x, st, jcfg)
    out_t, new_t = TRG.rglru_decode(to_torch(p_j), to_torch(x),
                                    to_torch(st), tcfg)
    _close(out_t, out_j, TOL[dtype])
    _close(new_t["h"], new_j["h"], TOL[dtype])
    np.testing.assert_array_equal(to_numpy(new_t["conv"]).view(np.uint16),
                                  np.asarray(new_j["conv"]).view(np.uint16))


def test_prefill_then_decode_continues_the_forward():
    """A prefill with a state, then decode steps from its state, give the
    forward's rows over the whole sequence (f32; the conv state is bf16,
    as in the reference, so within the bf16 tolerance)."""
    jcfg, tcfg, p_j, x, _ = _setup(jnp.float32, S=12)
    p = to_torch(p_j)
    xt = to_torch(x)
    full, _ = TRG.rglru_forward(p, xt, tcfg)
    state = TRG.make_rglru_state(tcfg, 2)
    head, state = TRG.rglru_forward(p, xt[:, :7], tcfg, state=state)
    rows = [head]
    for t in range(7, 12):
        out, state = TRG.rglru_decode(p, xt[:, t:t + 1], state, tcfg)
        rows.append(out)
    torch.testing.assert_close(torch.cat(rows, dim=1), full, atol=3e-2,
                               rtol=3e-2)
    torch.testing.assert_close(head, full[:, :7], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_doubling_scan_matches_the_loop(S):
    """h_t = a_t h_{t-1} + b_t: the log-depth scan against one step at a
    time, f32 at 2e-5, with decays from ~1 down to exp(-32) (the gates'
    range: -8 softplus(4) per step), so that prefix products underflow."""
    rng = np.random.default_rng(S)
    a = torch.from_numpy(np.exp(-rng.uniform(0, 32.1, size=(3, S, 40))
                                ).astype(np.float32))
    a[:, :, :8] = 1.0 - 1e-7 * torch.rand((3, S, 8))       # long memory
    b = torch.from_numpy(rng.normal(size=(3, S, 40)).astype(np.float32))
    torch.testing.assert_close(TRG.linear_scan(a, b),
                               TRG.linear_scan_loop(a, b), atol=2e-5,
                               rtol=2e-5)


def test_doubling_scan_gradient_matches_the_loop():
    rng = np.random.default_rng(1)
    a0 = torch.from_numpy(rng.uniform(0.05, 1.0, size=(2, 37, 16)
                                      ).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(size=(2, 37, 16)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, 37, 16)).astype(np.float32))
    grads = []
    for scan in (TRG.linear_scan, TRG.linear_scan_loop):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        (scan(a, b) * dy).sum().backward()
        grads.append((a.grad, b.grad))
    for got, expect in zip(*grads):
        torch.testing.assert_close(got, expect, atol=2e-4, rtol=2e-4)
