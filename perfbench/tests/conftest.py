"""A smoke root for the harness's CPU runs: BENCHMARK.json and the
configurations, mixes and cells of `data/` at smoke width, with the real
metric readers."""

import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_root(dest: Path) -> Path:
    (dest / "perfbench").mkdir(parents=True)
    shutil.copy(HERE / "data" / "BENCHMARK.json", dest / "BENCHMARK.json")
    for kind in ("configs", "traffic", "cells"):
        shutil.copytree(HERE / "data" / kind, dest / "perfbench" / kind)
    shutil.copytree(REPO / "perfbench" / "metrics",
                    dest / "perfbench" / "metrics")
    return dest


@pytest.fixture
def smoke_root(tmp_path):
    return make_root(tmp_path / "root")
