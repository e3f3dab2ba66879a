"""PyTorch port vs JAX reference, whole model: prefill logits and cache
contents, then 8 greedy decode steps (same tokens, logits within 2e-4) with
the port's kernel paths on and off, on the smoke configs of the paper's two
models, of mamba2-780m (whose cache is the SSM state; its prefill runs
the SSD scan's wrapper with the kernels on, its decode has no kernel), of
mixtral-8x7b (MoE, sliding window) and of h2o-danube-1.8b (sliding window);
the last two also with prompts longer than their smoke window of 64, so
that the prefill keeps the last 64 tokens of a wrapped ring and decode
reads it through K1's wrapper. f32 weights carried over from the JAX init
by interop."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

TOL = 2e-4
B, S, S_MAX, STEPS = 2, 12, 128, 8


def _close(t, j):
    np.testing.assert_allclose(np.asarray(to_numpy(t), np.float32),
                               np.asarray(j, np.float32), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2.5-7b", "mamba2-780m",
                                  "mixtral-8x7b", "h2o-danube-1.8b"])
def test_prefill_and_greedy_decode_match_reference(arch):
    _prefill_and_greedy_decode(arch, S, S_MAX)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("prompt", [64, 100])
def test_prompts_past_the_window_match_reference(arch, prompt):
    """A prompt of the window's length and one past it (the ring's split
    write at 100 % 64), then 8 decode steps that wrap the ring again."""
    _prefill_and_greedy_decode(arch, prompt, 160)


def _prefill_and_greedy_decode(arch, seq, s_max):
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    params_j = JMD.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params_t = to_torch(params_j)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(B, seq)).astype(np.int32)
    ssm = jcfg.family == "ssm"

    cache_j = JMD.init_cache(jcfg, B, s_max, dtype=jnp.float32)
    logits_j, cache_j = jax.jit(lambda p, b, c: JMD.prefill(p, jcfg, b, c))(
        params_j, {"tokens": jnp.asarray(tokens)}, cache_j)
    caches_t = {}
    for use_kernels in (False, True):
        cache_t = TMD.init_cache(tcfg, B, s_max, dtype=torch.float32,
                                 device="cpu")
        before = K3.PLAIN_CALLS
        logits_t, caches_t[use_kernels] = TMD.prefill(
            params_t, tcfg, {"tokens": torch.from_numpy(tokens)}, cache_t,
            use_kernels=use_kernels)
        assert K3.PLAIN_CALLS - before == \
            (tcfg.num_layers if use_kernels and ssm else 0)
        _close(logits_t, logits_j)
        assert cache_t["scan"].keys() == cache_j["scan"].keys()
        for name, t in cache_t["scan"].items():
            _close(t, cache_j["scan"][name])

    decode_j = jax.jit(lambda p, t, q, c: JMD.decode_step(p, jcfg, t, q, c))
    tok = np.array(jnp.argmax(logits_j, axis=-1), np.int32)
    for step in range(STEPS):
        pos = np.full((B,), seq + step, np.int32)
        logits_j, cache_j = decode_j(params_j, jnp.asarray(tok),
                                     jnp.asarray(pos), cache_j)
        next_j = np.array(jnp.argmax(logits_j, axis=-1), np.int32)
        for use_kernels, cache in caches_t.items():
            before = K.PLAIN_CALLS
            logits_t, _ = TMD.decode_step(
                params_t, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
                cache, use_kernels=use_kernels)
            assert K.PLAIN_CALLS - before == \
                (tcfg.num_layers if use_kernels and not ssm else 0)
            _close(logits_t, logits_j)
            np.testing.assert_array_equal(
                logits_t.argmax(dim=-1).numpy(), next_j)
        tok = next_j
    for cache in caches_t.values():
        for name, t in cache["scan"].items():
            _close(t, cache_j["scan"][name])
