"""The port's Mamba2 mixer (`models/ssm.py`) against the JAX package's on
the smoke config of mamba2-780m: `ssm_prefill` (output and final state,
from a zero and from a random state, with the scan plain and through K3's
wrapper) and `ssm_decode` (output and state), in f32 and bf16; then the
whole SSM model's greedy decode against its teacher-forced forward, as
`tests/test_attention.py::test_decode_consistency_ssm` checks the
reference. Weights come from the reference's init through interop; inputs
are made with numpy from a seed."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

# f32: both sides compute the same f32 ops in other orders (einsum
# contraction order, cumsum; measured <= 7.2e-7 on outputs of size ~3.6);
# bf16: both sides round at the same points (measured: equal bits), but a
# rounding of an element to bf16 may fall the other way on another
# platform (2^-8 relative), so the repo's bf16 kernel tolerance
TOL = {jnp.float32: 1e-4, jnp.bfloat16: 2e-2}
ARCH = "mamba2-780m"
B, S = 2, 13                       # chunk 8: two chunks, a ragged tail of 5


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _setup(dtype, seed=0):
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    p_j = JSSM.ssm_init(jax.random.PRNGKey(seed), jcfg, dtype)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32),
                    dtype)
    state = JSSM.make_ssm_state(jcfg, B)
    state = {"h": jnp.asarray(rng.normal(size=state["h"].shape) * 0.2,
                              jnp.float32),
             "conv": jnp.asarray(rng.normal(size=state["conv"].shape) * 0.5,
                                 jnp.bfloat16)}
    return jcfg, tcfg, p_j, x, state


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_prefill_matches_reference(dtype, use_kernel, with_state):
    jcfg, tcfg, p_j, x, state = _setup(dtype)
    if not with_state:
        state = {k: jnp.zeros_like(v) for k, v in state.items()}
    out_j, st_j = JSSM.ssm_prefill(p_j, x, jcfg, state=state)
    before = K3.PLAIN_CALLS
    out_t, st_t = TSSM.ssm_prefill(to_torch(p_j), to_torch(x), tcfg,
                                   state=to_torch(state),
                                   use_kernel=use_kernel)
    assert K3.PLAIN_CALLS - before == int(use_kernel)
    assert out_t.dtype == to_torch(x).dtype
    assert st_t["h"].dtype == torch.float32
    assert st_t["conv"].dtype == torch.bfloat16
    _close(out_t, out_j, TOL[dtype])
    _close(st_t["h"], st_j["h"], TOL[dtype])
    _close(st_t["conv"], st_j["conv"], TOL[dtype])


def test_ssm_prefill_without_state_returns_none():
    jcfg, tcfg, p_j, x, _ = _setup(jnp.float32, seed=1)
    out_j, _ = JSSM.ssm_prefill(p_j, x, jcfg)
    out_t, st_t = TSSM.ssm_prefill(to_torch(p_j), to_torch(x), tcfg)
    assert st_t is None
    _close(out_t, out_j, TOL[jnp.float32])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssm_decode_matches_reference(dtype):
    jcfg, tcfg, p_j, x, state = _setup(dtype, seed=2)
    x1 = x[:, :1]
    out_j, st_j = JSSM.ssm_decode(p_j, x1, state, jcfg)
    out_t, st_t = TSSM.ssm_decode(to_torch(p_j), to_torch(x1),
                                  to_torch(state), tcfg)
    assert out_t.shape == (B, 1, tcfg.d_model)
    _close(out_t, out_j, TOL[dtype])
    _close(st_t["h"], st_j["h"], TOL[dtype])
    _close(st_t["conv"], st_j["conv"], TOL[dtype])
    assert st_t["h"].dtype == torch.float32
    assert st_t["conv"].dtype == torch.bfloat16


def test_init_and_state_layouts_match_reference():
    jcfg, tcfg = jconfigs.smoke_config(ARCH), tconfigs.smoke_config(ARCH)
    p_j = JSSM.ssm_init(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    p_t = {k: v[0] for k, v in TSSM.ssm_init(gen, tcfg, 1).items()}
    assert p_t.keys() == p_j.keys()
    for k, v in p_j.items():
        assert tuple(p_t[k].shape) == v.shape
        assert str(p_t[k].dtype).split(".")[-1] == str(v.dtype)
    for k in ("A_log", "dt_bias", "D", "conv_b", "gate_norm"):
        _close(p_t[k], p_j[k], 1e-6)
    # the reference's scales: in_proj ~ d^-0.5, out_proj ~ dinner^-0.5
    assert abs(p_t["in_proj"].float().std() * tcfg.d_model ** 0.5 - 1) < 0.1
    assert abs(p_t["out_proj"].float().std() * tcfg.ssm_dinner ** 0.5 - 1) \
        < 0.1
    stacked = TSSM.ssm_init(gen, tcfg, 3)
    assert stacked["in_proj"].shape == (3,) + tuple(p_j["in_proj"].shape)
    assert not torch.equal(stacked["in_proj"][0], stacked["in_proj"][1])
    # the state: h is f32 and conv bf16 whatever cache dtype is asked for
    cache_j = JMD.init_cache(jcfg, 3, 16, dtype=jnp.float32)
    cache_t = TMD.init_cache(tcfg, 3, 16, dtype=torch.float32, device="cpu")
    assert jax.tree.structure(cache_j) == \
        jax.tree.structure(to_numpy(cache_t))
    for name in ("h", "conv"):
        assert tuple(cache_t["scan"][name].shape) == \
            cache_j["scan"][name].shape
        assert to_numpy(cache_t["scan"][name]).dtype == \
            cache_j["scan"][name].dtype


SSM_CFG = dict(name="t", family="ssm", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
               ssm_state=16, ssm_headdim=16, ssm_chunk=4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_matches_forward_ssm(use_kernels):
    """Greedy decode gives the teacher-forced forward's logits (the port of
    test_attention.py's check, at its 5e-2 on bf16 weights): prefill of 10
    tokens, then two decode steps."""
    cfg = TConfig(**SSM_CFG)
    params = to_torch(JMD.init_params(JConfig(**SSM_CFG),
                                      jax.random.PRNGKey(0)))
    Bq, Sq = 2, 10
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(Bq, Sq + 4)).astype(np.int32))
    full, _ = TMD.forward(params, cfg, {"tokens": tokens})
    cache = TMD.init_cache(cfg, Bq, Sq + 8, device="cpu")
    last, cache = TMD.prefill(params, cfg, {"tokens": tokens[:, :Sq]}, cache,
                              use_kernels=use_kernels)
    torch.testing.assert_close(last.float(), full[:, Sq - 1].float(),
                               atol=5e-2, rtol=5e-2)
    for t in range(Sq, Sq + 2):
        pos = torch.full((Bq,), t, dtype=torch.int32)
        logits, cache = TMD.decode_step(params, cfg, tokens[:, t], pos, cache,
                                        use_kernels=use_kernels)
        torch.testing.assert_close(logits.float(), full[:, t].float(),
                                   atol=5e-2, rtol=5e-2)


def test_serve_entry_point_serves_mamba2_on_cpu():
    """`launch/serve.py --arch mamba2-780m --smoke --use-kernels` serves
    end to end, each prefill through K3's wrapper (its plain version on
    the CPU), and releases every request's pages."""
    before = K3.PLAIN_CALLS
    m = serve.main(["--arch", "mamba2-780m", "--smoke", "--requests", "3",
                    "--device", "cpu", "--use-kernels"])
    assert m.prefills == 3 and m.decode_rounds > 0
    assert K3.PLAIN_CALLS - before == \
        3 * tconfigs.smoke_config(ARCH).num_layers
