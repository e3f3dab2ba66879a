"""Builds the port's CUDA kernels from `csrc/` at first use.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, into a shared library with a plain C interface that the
wrappers load with `ctypes`. The libraries go into
`build/repro_torch_kernels/<hash>/` at the repository root, keyed by a hash
of the sources and flags, so a changed source is rebuilt and an unchanged
one is not. Only sources in the repository are built. A missing `nvcc` or
a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


@functools.cache
def build_all() -> Dict[str, Path]:
    """Compiles every kernel source (in parallel) unless already built.
    Returns {source stem: shared library}; the compiler's register and
    shared-memory report for each is left beside it as `<stem>.log`."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in _sources()}
    todo = {name: src for name, src in _sources().items()
            if not libs[name].exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, src in todo.items():
            tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{todo[name]}:\n{log}")
                continue
            os.replace(tmp, libs[name])        # atomic against other builders
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, built at first use."""
    return ctypes.CDLL(str(build_all()[name]))
