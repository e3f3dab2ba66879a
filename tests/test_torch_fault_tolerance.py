"""The port's checkpoint manager and straggler mitigation, mirroring
`tests/test_fault_tolerance.py` (the elastic restore onto a mesh is not
ported), plus: checkpoints cross between the reference's manager and the
port's bit for bit, both ways, in the same files; an asynchronous save
keeps the values of the moment it was called, whatever the caller then
writes in place; and a save waits for the one in flight."""

import json
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed import fault_tolerance as FT  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    CheckpointManager, StragglerConfig, StragglerMitigator)
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.models import model as MD  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _tree(seed=0):
    """Adapters (f32), a bf16 and an int32 tensor, a host int (a step
    counter) and a list and a tuple, as the port's trees hold them."""
    gen = torch.Generator().manual_seed(seed)
    return {"adapters": MD.init_adapters(smoke_config("qwen3-8b"), seed,
                                         device="cpu"),
            "w": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
            "idx": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "t": 7,
            "rest": [torch.randn((4,), generator=gen),
                     (torch.zeros((), dtype=torch.bfloat16), 3)]}


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, int):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8))


def _plus(tree, n):
    return tree_map(lambda t: t + n, tree)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, tree)
    out = mgr.restore(tree)
    _same_bits(tree, out)
    assert isinstance(out["rest"][1], tuple)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["step"] == 1 and set(manifest) == {"step", "leaves",
                                                       "time"}
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["w"]["shape"] == [3, 5]
    assert manifest["leaves"]["t"] == {"file": "leaf_00016.npy", "shape": [],
                                       "dtype": "int32"}
    raw = np.load(tmp_path / "step_1" / manifest["leaves"]["w"]["file"])
    assert raw.dtype == np.uint8 and raw.shape == (3, 5, 2)


def test_checkpoint_async_and_gc(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _plus(tree, step), blocking=False)
        mgr.wait()
    assert mgr.steps() == [3, 4]          # keep=2 garbage collection
    out = mgr.restore(tree, step=4)
    _same_bits(out, _plus(tree, 4))


def test_checkpoint_atomicity(tmp_path):
    """A torn write (missing manifest) must be invisible to restore."""
    tree = _tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    torn = tmp_path / "step_2"
    torn.mkdir()
    (torn / "leaf_00000.npy").write_bytes(b"garbage")   # no manifest
    assert mgr.latest_step() == 1
    mgr.restore(tree)                                    # must not raise


def test_checkpoint_restore_missing(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())


def test_checkpoint_gc_keep_zero(tmp_path):
    """keep=0 means retain nothing: every completed save is collected."""
    tree = {"x": torch.arange(4)}
    mgr = CheckpointManager(tmp_path, keep=0)
    for step in (1, 2):
        mgr.save(step, tree)
    assert mgr.steps() == []
    assert mgr.latest_step() is None


def test_checkpoint_negative_keep_rejected(tmp_path):
    with pytest.raises(ValueError, match="keep must be >= 0"):
        CheckpointManager(tmp_path, keep=-1)


def test_restore_follows_the_template_dtype_and_kind(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"a": torch.ones(3, dtype=torch.bfloat16), "t": 9})
    out = mgr.restore({"a": torch.zeros(3, dtype=torch.float32),
                       "t": torch.zeros((), dtype=torch.int64)})
    assert out["a"].dtype == torch.float32 and torch.equal(out["a"],
                                                           torch.ones(3))
    assert out["t"].dtype == torch.int64 and int(out["t"]) == 9
    mgr.save(6, {"a": torch.ones(3), "t": 9})
    out = mgr.restore({"a": np.zeros(3, np.float32), "t": 0})
    assert out["t"] == 9 and isinstance(out["t"], int)
    assert isinstance(out["a"], np.ndarray) and out["a"].dtype == np.float32


# ------------------------------------------- across the two managers ------
def _reference_state(seed=0):
    """The reference's {"adapters", "opt"} state (f32 adapters, AdamW with
    an int32 step) plus a bf16 leaf, stepped so that nothing is zero."""
    cfg = jconfigs.smoke_config("llama3-8b")
    ad = JMD.init_adapters(cfg, jax.random.PRNGKey(seed))
    opt = jopt.adamw_init(ad)
    grads = jax.tree.map(lambda a: a * 0.5 + 0.25, ad)
    ad, opt = jopt.adamw_update(jopt.AdamWConfig(lr=1e-2), grads, opt, ad)
    w = JMD.init_params(cfg, jax.random.PRNGKey(seed))["embed"]
    return {"adapters": ad, "opt": opt, "w": w}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


def test_reference_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    state = _reference_state()
    JFT.CheckpointManager(tmp_path / "ref").save(2, state)
    template = to_torch(jax.tree.map(np.asarray, state))
    assert isinstance(template["opt"]["t"], int)
    template = tree_map(lambda t: torch.zeros_like(t)
                        if isinstance(t, torch.Tensor) else 0, template)
    out = CheckpointManager(tmp_path / "ref").restore(template)
    _same_bits(out, to_torch(jax.tree.map(np.asarray, state)))
    assert out["opt"]["t"] == 1 and out["w"].dtype == torch.bfloat16
    # the port writes the same files for the same tree
    CheckpointManager(tmp_path / "port").save(2, out)
    assert _files(tmp_path / "port" / "step_2") == \
        _files(tmp_path / "ref" / "step_2")
    mp, mr = (json.loads((tmp_path / d / "step_2" / "manifest.json")
                         .read_text()) for d in ("port", "ref"))
    assert mp["leaves"] == mr["leaves"] and mp["step"] == mr["step"]


def test_port_checkpoint_restores_into_the_reference_bit_for_bit(tmp_path):
    state = to_torch(jax.tree.map(np.asarray, _reference_state(seed=1)))
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, state, blocking=False)
    mgr.wait()
    template = _reference_state(seed=2)
    out = JFT.CheckpointManager(tmp_path).restore(template)
    expect = to_numpy(state)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(expect)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))
    assert np.asarray(out["opt"]["t"]).dtype == np.int32


# ------------------------------------------- snapshots and ordering --------
def _gated(manager_cls):
    """`manager_cls` whose asynchronous writes start only once `gate` is
    set (blocking writes are not held)."""
    class Gated(manager_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gate = threading.Event()

        def _write_guarded(self, step, tree):
            assert self.gate.wait(timeout=30)
            super()._write_guarded(step, tree)
    return Gated


_GatedManager = _gated(CheckpointManager)


def test_async_save_keeps_the_values_before_an_in_place_update(tmp_path):
    """The caller's next step writes the tensors in place (as the unit
    engine's AdamW and CUDA graph replays do) before the write begins: the
    checkpoint still holds the values of the moment `save` was called."""
    tree = _tree()
    before = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                      else t, tree)
    mgr = _GatedManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t.add_(1)
    mgr.gate.set()
    mgr.wait()
    _same_bits(mgr.restore(tree), before)
    assert not torch.equal(tree["w"], before["w"])


def test_save_waits_for_the_save_in_flight(tmp_path):
    """A blocking save of the step an async save is still writing commits
    after it, so the later call's values win. The reference's blocking
    save does not wait: held the same way, its async write of the earlier
    values lands last and step 4 holds them (unheld, both write one
    temporary directory at once)."""
    old, new = _tree(0), _tree(1)
    mgr = _GatedManager(tmp_path / "port")
    mgr.save(4, old, blocking=False)
    opener = threading.Timer(0.2, mgr.gate.set)
    opener.start()
    mgr.save(4, new)
    opener.join(timeout=30)
    assert not opener.is_alive()
    assert mgr.steps() == [4]
    _same_bits(mgr.restore(new), new)
    assert not list((tmp_path / "port").glob(".tmp_*"))

    old, new = ({k: t[k] for k in ("adapters", "w", "t")} for t in (old, new))
    ref = _gated(JFT.CheckpointManager)(tmp_path / "ref")
    ref.save(4, to_numpy(old), blocking=False)
    ref.save(4, to_numpy(new))            # commits at once, not waiting
    ref.gate.set()
    ref.wait()
    stale = CheckpointManager(tmp_path / "ref").restore(new)
    _same_bits(stale, old)


def test_a_0d_bf16_leaf_crosses_only_from_the_port(tmp_path):
    """The reference's byte view of a 0-d bf16 array raises, so it cannot
    save one; the port's (a flat view) can, and the reference reads it."""
    tree = {"s": torch.tensor(1.5, dtype=torch.bfloat16), "t": 2}
    CheckpointManager(tmp_path / "port").save(1, tree)
    out = JFT.CheckpointManager(tmp_path / "port").restore(to_numpy(tree))
    assert out["s"].shape == () and out["s"].dtype.name == "bfloat16"
    assert float(out["s"]) == 1.5 and int(out["t"]) == 2
    with pytest.raises(ValueError):
        JFT.CheckpointManager(tmp_path / "ref").save(1, to_numpy(tree))


def test_snapshot_copies_cpu_tensors():
    t = torch.arange(4.0)
    snap = FT.snapshot({"t": t, "n": 2})
    t.add_(1)
    assert torch.equal(snap["t"], torch.arange(4.0)) and snap["n"] == 2
    assert snap["t"].data_ptr() != t.data_ptr()


# --------------------------------------------------------- stragglers -----
def test_straggler_mitigator():
    m = StragglerMitigator(StragglerConfig(window=16, deadline_factor=2.0,
                                           cooloff_rounds=4))
    for _ in range(20):
        assert not m.observe(0.010)
    assert m.observe(0.050)               # 5x median -> overrun
    assert m.suppress_quantum
    for _ in range(4):
        m.observe(0.010)
    assert not m.suppress_quantum         # cooloff expired
    assert m.overruns == 1


def test_straggler_deadline_robust_to_noise():
    m = StragglerMitigator(StragglerConfig(window=32, deadline_factor=2.5))
    rng = np.random.default_rng(0)
    overruns = sum(m.observe(float(t))
                   for t in rng.normal(0.02, 0.002, size=200))
    assert overruns == 0                  # 10% noise never trips a 2.5x gate


def test_straggler_expected_gate_matches_reference():
    rng = np.random.default_rng(1)
    rounds = rng.lognormal(np.log(0.02), 0.6, size=300)
    expected = rng.choice([0.0, 0.01, 0.02, 0.05], size=300)
    ours = StragglerMitigator(StragglerConfig(window=24, cooloff_rounds=5))
    ref = JFT.StragglerMitigator(JFT.StragglerConfig(window=24,
                                                     cooloff_rounds=5))
    for r, e in zip(rounds, expected):
        e = float(e) or None
        assert ours.observe(float(r), e) == ref.observe(float(r), e)
        assert ours.suppress_quantum == ref.suppress_quantum
    assert ours.overruns == ref.overruns > 0


def test_deepseek_state_crosses_between_the_packages_bit_for_bit(tmp_path):
    """deepseek-v3's finetune state (adapters with a "pre" list of the
    dense layer's q/o/gate/up/down, AdamW's m, v and t) written by the
    reference restores into the port bit for bit, and the port writes the
    same files and manifest for it, which the reference restores."""
    cfg = jconfigs.smoke_config("deepseek-v3-671b")
    ad = JMD.init_adapters(cfg, jax.random.PRNGKey(3))
    opt = jopt.adamw_init(ad)
    grads = jax.tree.map(lambda a: a * 0.5 + 0.25, ad)
    ad, opt = jopt.adamw_update(jopt.AdamWConfig(lr=1e-2), grads, opt, ad)
    state = {"adapters": ad, "opt": opt}
    assert len(ad["pre"]) == 1 and set(ad["pre"][0]) == \
        {"q", "o", "gate", "up", "down"}
    JFT.CheckpointManager(tmp_path / "ref").save(4, state)
    expect = to_torch(jax.tree.map(np.asarray, state))
    template = tree_map(lambda t: torch.zeros_like(t)
                        if isinstance(t, torch.Tensor) else 0, expect)
    out = CheckpointManager(tmp_path / "ref").restore(template)
    _same_bits(out, expect)
    CheckpointManager(tmp_path / "port").save(4, out)
    assert _files(tmp_path / "port" / "step_4") == \
        _files(tmp_path / "ref" / "step_4")
    mp, mr = (json.loads((tmp_path / d / "step_4" / "manifest.json")
                         .read_text()) for d in ("port", "ref"))
    assert mp["leaves"] == mr["leaves"]
    assert any(k.startswith("adapters/pre/0/") for k in mp["leaves"])
    back = JFT.CheckpointManager(tmp_path / "port").restore(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_0d_numpy_leaf_keeps_its_shape(tmp_path):
    """The simulator's `FinetuneCheckpointer` commits {"units_done":
    np.asarray(n)}: restored with a None template it comes back a 0-d
    array, as the reference's restore gives it (a 1-d one would make
    `int()` of it deprecated)."""
    for mod in (FT, JFT):
        mgr = mod.CheckpointManager(tmp_path / mod.__name__)
        mgr.save(1, {"units_done": np.asarray(1234)})
        got = mgr.restore({"units_done": None})["units_done"]
        assert np.shape(got) == () and int(got) == 1234
