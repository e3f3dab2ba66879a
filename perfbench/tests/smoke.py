"""Drives one CPU run of the harness at smoke width, in process, with the
look for a card skipped."""

import json
import time

import torch

from perfbench.harness import cell, cli


def run(root, workload, seed=20260, seconds=3.0, control=False,
        capsys=None, monkeypatch=None):
    """The run's result line, parsed. In a test process other tests may
    have loaded JAX, so the run's own check of sys.modules is left to the
    subprocess test."""
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    # a few threads: the suite's workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        return _run(root, workload, seed, seconds, control, capsys)
    finally:
        torch.set_num_threads(threads)


def _run(root, workload, seed, seconds, control, capsys):
    rc = cli.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0", "--control",
                   str(int(control))], time.perf_counter(), root=root,
                  device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    return json.loads(out.strip().splitlines()[-1]), out
