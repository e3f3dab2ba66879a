"""The control at each cell's own size, on the card: the reference in
float8 in the program's place, judged as the program is, comes out not
correct on every seed, where the program's own numbers, printed beside
it, are within every limit.

  python -m pytest -m gpu perfbench/tests/test_perfbench_card.py

(about 1.5 minutes a seed and cell; skips without a card)."""

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec
from perfbench.tests.conftest import REPO

SEEDS = (3000000019, 3000000037, 3000000079)


def _cells():
    return [w["name"] for w in spec.load(REPO)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", workload,
             "--seed", str(seed), "--seconds", "10", "--trace", "0",
             "--control", "1"], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        lines = p.stdout.strip().splitlines()
        line = json.loads(lines[-1])
        readings = json.loads(next(s for s in lines
                                   if s.startswith("readings "))[9:])
        assert line["correct"] is False, line["checks"]
        assert all(readings[f"program_{k}"] <= x["limit"]
                   for k, x in line["checks"].items()), readings
