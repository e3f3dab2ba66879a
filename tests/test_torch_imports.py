"""Hygiene of the port: it imports neither JAX nor the JAX package, its
entry points refuse to run without a card unless asked for the CPU, every
shipped config runs with and without an int8 KV cache, and interop round
trips are exact."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_registry_resolves_only_port_policies():
    """The port's policy registry fills itself from the port's policies
    (`_ensure_builtins`), never from the reference's."""
    from repro_torch.core import api
    for kind in api.KINDS:
        names = api.available_policies(kind)
        assert names, kind
        for name in names:
            cls = api.resolve_policy(kind, name)
            assert cls.__module__.startswith("repro_torch"), (kind, name)


def test_port_configs_match_reference():
    """The port's copies of the configs equal the reference's, field by
    field (repr covers every field, the LoRA config included)."""
    for name in jconfigs._MODULES:
        assert repr(tconfigs.get_config(name)) == \
            repr(jconfigs.get_config(name))
        assert repr(tconfigs.smoke_config(name)) == \
            repr(jconfigs.smoke_config(name))


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMD.init_params(cfg)
    params = TMD.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    m = serve.main(["--smoke", "--requests", "2", "--device", "cpu",
                    "--use-kernels"])
    assert m.prefills == 2 and m.decode_rounds > 0
    for mode in ([], ["--layer-units"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--smoke", "--steps", "1"] + mode)
        out = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                          "16", "--device", "cpu", "--use-kernels"] + mode)
        assert out["opt"]["t"] == 1


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", sorted(tconfigs._MODULES))
def test_every_family_runs(arch, kv_quant):
    """Every shipped config's smoke sibling, with and without kv_quant:
    a prefill of 16 tokens (after the stub patches or with the stub
    encoder frames where the model has them) and one decode step through
    the kernels' wrappers give finite logits."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), kv_quant=kv_quant)
    params = TMD.init_params(cfg, device="cpu")
    enc_len = 4 if cfg.enc_layers else 0
    cache = TMD.init_cache(cfg, 2, 96, enc_len=enc_len, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen)}
    if cfg.enc_layers:
        batch["enc_frames"] = torch.randn((2, enc_len, cfg.d_model),
                                          generator=gen)
    front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    if front:
        batch["frontend"] = torch.randn((2, front, cfg.d_model),
                                        generator=gen)
    logits, _ = TMD.prefill(params, cfg, batch, cache, use_kernels=True)
    logits2, _ = TMD.decode_step(
        params, cfg, logits.argmax(-1).to(torch.int32),
        torch.full((2,), front + 16, dtype=torch.int32), cache,
        use_kernels=True)
    for lg in (logits, logits2):
        assert lg.shape == (2, cfg.vocab_size)
        assert torch.isfinite(lg.float()).all()


def test_deepseek_runs():
    """MLA, the leading dense stack and the MTP head (ROADMAP.md §1 item
    5.3): the smoke config prefills, its dense layer's cache in "pre"."""
    cfg = tconfigs.smoke_config("deepseek-v3-671b")
    params = TMD.init_params(cfg, device="cpu")
    assert "mtp" in params and len(params["pre"]) == cfg.first_dense_layers
    cache = TMD.init_cache(cfg, 2, 96, device="cpu")
    logits, _ = TMD.prefill(params, cfg, {"tokens": torch.zeros(
        (2, 80), dtype=torch.int32)}, cache)
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    assert (cache["pre"][0]["kv_pos"][:, :80] >= 0).all()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b"])
def test_windowed_and_moe_families_run(arch):
    cfg = tconfigs.smoke_config(arch)
    params = TMD.init_params(cfg, device="cpu")
    cache = TMD.init_cache(cfg, 2, 160, device="cpu")
    assert cache["scan"]["k"].shape[2] == cfg.window == 64
    logits, _ = TMD.prefill(params, cfg, {"tokens": torch.zeros(
        (2, 80), dtype=torch.int32)}, cache)
    assert logits.shape == (2, cfg.vocab_size)


def _assert_same_bits(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_bits(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_bits(x, y)
    else:
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_interop_round_trips_are_exact():
    cfg = jconfigs.smoke_config("llama3-8b")
    params = jax.tree.map(np.asarray, JMD.init_params(cfg,
                                                      jax.random.PRNGKey(0)))
    cache = jax.tree.map(np.asarray, JMD.init_cache(cfg, 2, 16))
    for tree in (params, cache):
        back = to_numpy(to_torch(tree))
        _assert_same_bits(tree, back)
    t = to_torch(params)
    assert t["scan"]["attn"]["wq"].dtype == torch.bfloat16
    assert t["scan"]["attn"]["wq"].shape == params["scan"]["attn"]["wq"].shape
    assert t["pre"] == [] and t["post"] == []
    tc = TMD.init_cache(tconfigs.smoke_config("llama3-8b"), 2, 16,
                        device="cpu")
    _assert_same_bits(cache, to_numpy(tc))
