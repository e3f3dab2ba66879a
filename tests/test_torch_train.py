"""The port's finetune entry point (`launch/train.py`) on the CPU at smoke
width, in both modes, with checkpoint/restart: a run interrupted and
resumed equals one that was not, bit for bit, where the reference's
resumed run retrains from batch 0; `--layer-units --resume` starts from
the restored state and saves nothing; K2's launches per step by its
counter; and `serve.py --predictor costmodel`, the counterpart of
`tests/test_system.py::test_colocated_serving_end_to_end`."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as JTR  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed.fault_tolerance import \
    CheckpointManager  # noqa: E402
from repro_torch.kernels import lora_matmul as K2  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32"]


def _bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x == y if isinstance(x, int) else torch.equal(x, y)
        for x, y in zip(la, lb))


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".npy"}


def test_one_shot_mode_trains_and_checkpoints(tmp_path):
    out = train.main(SMALL + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "2"])
    assert out["opt"]["t"] == 4
    assert CheckpointManager(tmp_path).steps() == [2, 4]
    b = [v["b"] for v in out["adapters"]["scan"].values()]
    assert all(torch.isfinite(x).all() for x in b)
    assert any(bool((x != 0).any()) for x in b)     # B has moved off 0
    saved = CheckpointManager(tmp_path).restore(out)
    assert _bits_equal(saved, out)


def test_layer_units_mode_trains(tmp_path):
    out = train.main(SMALL + ["--steps", "2", "--layer-units", "--ckpt-dir",
                              str(tmp_path)])
    assert out["iter"] == 2 and out["opt"]["t"] == 2
    assert out["unit_idx"] == 0 and out["consumed"] == 0
    assert np.isfinite(float(out["last_loss"]))
    assert CheckpointManager(tmp_path).steps() == []  # the mode saves none


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    whole = train.main(SMALL + ["--steps", "5", "--ckpt-dir",
                                str(tmp_path / "a"), "--ckpt-every", "2"])
    train.main(SMALL + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                        "--ckpt-every", "2"])
    assert CheckpointManager(tmp_path / "b").steps() == [2, 3]
    resumed = train.main(SMALL + ["--steps", "5", "--ckpt-dir",
                                  str(tmp_path / "b"), "--ckpt-every", "2",
                                  "--resume"])
    assert _bits_equal(resumed, whole)
    assert resumed["opt"]["t"] == 5
    assert _files(tmp_path / "a" / "step_5") == \
        _files(tmp_path / "b" / "step_5")


def _first_tokens(n_batches):
    """The first row's first 8 tokens of each of the corpus's first
    batches, at SMALL's shape."""
    it = SyntheticCorpus(DataConfig(smoke_config("llama3-8b").vocab_size, 32,
                                    2)).batches()
    return [next(it)["tokens"][0, :8].tolist() for _ in range(n_batches)]


def test_reference_resume_retrains_from_batch_0(tmp_path, monkeypatch,
                                                capsys):
    """Both entry points with their train step replaced by one that reports
    the batch it was given (as its loss) and changes nothing: the
    reference's resumed step 2 trains on batch 0, the port's on batch 2."""
    def reporting_step(cfg, opt_cfg, **kw):
        def step(params, adapters, opt, batch):
            loss = jnp.sum(batch["tokens"][0, :8]).astype(jnp.float32)
            return adapters, opt, {"loss": loss, "ce": loss}
        return step

    batches = _first_tokens(3)
    sums = [float(sum(b)) for b in batches]
    assert len(set(sums)) == 3
    monkeypatch.setattr(JTR.P, "make_train_step", reporting_step)
    for steps, extra in (("2", []), ("3", ["--resume"])):
        # --ckpt-every above --steps: the reference's async save of the last
        # step races its own blocking save of it (ROADMAP.md §3)
        monkeypatch.setattr(sys, "argv", ["train"] + SMALL[:1] + SMALL[3:] + [
            "--steps", steps, "--ckpt-dir", str(tmp_path / "ref"),
            "--ckpt-every", "100"] + extra)
        JTR.main()
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    got = {int(f[1]): float(f[3]) for f in lines}
    assert list(got) == [0, 1, 2]
    assert got[0] == sums[0] and got[1] == sums[1]
    assert got[2] == sums[0] != sums[2]     # the resumed step saw batch 0

    seen = []

    def recording_step(cfg, opt_cfg, **kw):
        def step(params, adapters, opt, batch):
            seen.append(batch["tokens"][0, :8].tolist())
            return adapters, opt, {"loss": torch.zeros(()),
                                   "ce": torch.zeros(())}
        return step

    monkeypatch.setattr(train.P, "make_train_step", recording_step)
    for steps, extra in (("2", []), ("3", ["--resume"])):
        train.main(SMALL + ["--steps", steps, "--ckpt-dir",
                            str(tmp_path / "port"), "--ckpt-every", "100"]
                   + extra)
    assert seen == batches                   # the resumed step saw batch 2


def test_layer_units_resume_starts_from_the_restored_state(tmp_path):
    """The repair: the units' state takes the restored adapters, AdamW
    moments and step count (the reference restores them and then builds a
    fresh state), and its ring starts at the batch the resumed step
    trains on; the mode saves no checkpoint."""
    d = str(tmp_path)
    saved = train.main(SMALL + ["--steps", "2", "--ckpt-dir", d])
    fresh = train.main(SMALL + ["--steps", "0", "--layer-units"])
    start = train.main(SMALL + ["--steps", "2", "--layer-units", "--resume",
                                "--ckpt-dir", d])     # restores, runs none
    assert _bits_equal(start["adapters"], saved["adapters"])
    assert _bits_equal([start["opt"]["m"], start["opt"]["v"]],
                       [saved["opt"]["m"], saved["opt"]["v"]])
    assert start["opt"]["t"] == 2 and fresh["opt"]["t"] == 0
    assert not _bits_equal(start["adapters"], fresh["adapters"])
    it = SyntheticCorpus(DataConfig(smoke_config("llama3-8b").vocab_size, 32,
                                    2)).batches()
    ring = [next(it)["tokens"] for _ in range(4)][2:]
    assert np.array_equal(start["data"]["tokens"].numpy(), np.stack(ring))
    after = train.main(SMALL + ["--steps", "3", "--layer-units", "--resume",
                                "--ckpt-dir", d])
    assert after["opt"]["t"] == 3 and after["iter"] == 1
    assert CheckpointManager(d).steps() == [2]


@pytest.mark.parametrize("units", [False, True])
def test_k2_calls_per_step(units):
    """With --use-kernels every adapted projection goes through K2's
    wrapper (its plain version on the CPU): a one-shot step makes the
    forward's, the remat recompute's and the backward's dx calls, less
    layer 0's q/k/v, whose input needs no gradient; an iteration of units
    7 per FWD and 14 per BWD unit."""
    cfg = smoke_config("llama3-8b")
    n = cfg.num_layers * len(cfg.lora.targets)
    K2.PLAIN_CALLS = 0
    train.main(SMALL + ["--steps", "2", "--use-kernels"]
               + (["--layer-units"] if units else []))
    assert K2.PLAIN_CALLS == 2 * (3 * n if units else 3 * n - 3)


def test_serve_with_the_costmodel_predictor_end_to_end():
    m = serve.main(["--smoke", "--device", "cpu", "--colocate",
                    "--predictor", "costmodel", "--requests", "5",
                    "--k-max", "4"])
    assert m.prefills == 5 and m.tokens_out > 0
    assert m.ft_units > 0


@pytest.mark.parametrize("units", [False, True])
def test_deepseek_trains_through_the_entry_point(units, tmp_path):
    """`launch/train.py --arch deepseek-v3-671b --smoke --device cpu
    --use-kernels`, one-shot (checkpointed: the "pre" lists of adapters,
    m and v restore into their template) and `--layer-units`: 5 adapted
    projections a layer, each forward, recomputed and its dx, less the
    first layer's q dx: 74 K2 calls a one-shot step; the units run the
    pre layer's 5 in EMBED and again in EMBED_BWD with 4 dx, and no
    recompute there: 74 too."""
    K2.PLAIN_CALLS = 0
    argv = ["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--steps", "2", "--use-kernels"]
    out = train.main(argv + (["--layer-units"] if units else
                             ["--ckpt-dir", str(tmp_path)]))
    assert K2.PLAIN_CALLS == 2 * 74
    assert out["opt"]["t"] == 2 and len(out["adapters"]["pre"]) == 1
    if not units:
        back = CheckpointManager(tmp_path).restore(
            {"adapters": out["adapters"], "opt": out["opt"]})
        assert _bits_equal(back["adapters"], out["adapters"])
        assert _bits_equal(back["opt"]["m"]["pre"], out["opt"]["m"]["pre"])
