"""CPU runs of the harness at smoke width: the result line and its
checks, the run's own look for JAX, and the refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.tests import smoke
from perfbench.tests.conftest import REPO

CELLS = ["dense-smoke.colo", "moe-smoke.colo", "dense-smoke.long"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(smoke_root, workload, capsys, monkeypatch):
    line, _ = smoke.run(smoke_root, workload, capsys=capsys,
                        monkeypatch=monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    names = set(line["metrics"])
    assert {"setup_s", "tpot_p95_ms", "decode_tokens_per_s"} <= names
    assert ("ft_tokens_per_s" in names) == workload.endswith(".colo")
    assert all(m["value"] > 0 for m in line["metrics"].values())


SCRIPT = """
import sys, time
t = time.perf_counter()
sys.path[:0] = [{repo!r}, {src!r}]
from pathlib import Path
import torch
torch.set_num_threads(2)
from perfbench.harness import cli
sys.exit(cli.main(sys.argv[1:], t, root=Path({root!r}), device="cpu"))
"""


def _child(root, repo, argv, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = SCRIPT.format(repo=str(repo), src=str(repo / "src"),
                         root=str(root))
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_result_line_in_a_fresh_process(smoke_root):
    """The contract's line last on stdout, the compared numbers last on
    stderr, and the run's own look at sys.modules (which finds no JAX)."""
    p = _child(smoke_root, REPO, ["--workload", "dense-smoke.colo", "--seed",
                                  "4294967311", "--seconds", "3",
                                  "--trace", "0"], smoke_root)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_no_card_no_result():
    """The run looks for a card first: without one it exits non-zero and
    prints no result."""
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen2.5-7b.colo-chat", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_benchmark_files_alone_are_no_run(tmp_path, smoke_root):
    """A directory with only BENCHMARK.json and perfbench/ (no program):
    non-zero, no result."""
    bare = tmp_path / "bare"
    shutil.copytree(REPO / "perfbench", bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(smoke_root / "BENCHMARK.json", bare / "BENCHMARK.json")
    for kind in ("configs", "traffic", "cells"):
        shutil.copytree(smoke_root / "perfbench" / kind,
                        bare / "perfbench" / kind, dirs_exist_ok=True)
    p = _child(bare, bare, ["--workload", "dense-smoke.colo", "--seed", "3",
                            "--seconds", "1", "--trace", "0"], bare)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "repro_torch" in p.stderr
