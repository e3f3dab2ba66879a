"""Fault tolerance: atomic checkpoints of torch trees, and stragglers.

Port of `repro/distributed/fault_tolerance.py`, with the same on-disk
format, so that a checkpoint either manager writes restores in the other:
one `.npy` per leaf (`leaf_{i:05d}.npy`, in `_flatten`'s order: dict
insertion order, lists by index), a `manifest.json` with `step`, the
`leaves` map (`file`, `shape`, `dtype`) and `time`, written into
`.tmp_step_{step}_{pid}` and committed by renaming it to `step_{step}`;
`keep` committed steps are retained (0 keeps none). bf16 and the float8
types, which `.npy` cannot name, are stored as a uint8 view with a
trailing axis of the item size and their own name in the manifest, built
from torch views (no `ml_dtypes`). The port keeps step counters such as
the optimizer's `t` as host ints: they are stored as 0-d int32, as the
reference stores its int32 scalars, and restore as ints where the
template has an int.

Two differences from the reference, both repairs:
  * `save` snapshots by copying every tensor to the host
    (`.detach().to("cpu", copy=True)`, after synchronizing the card when a
    tensor lives there). The reference's `np.asarray` snapshot is safe only
    because JAX arrays are immutable; the port's unit engine updates its
    state in place, CUDA graph replays write the same tensors, and
    `Tensor.cpu()` of a CPU tensor returns the same storage, so an
    asynchronous save that read without a copy would race with the next
    step.
  * `save` first waits for a save still in flight. The reference's
    blocking save does not, so a blocking save of the step an async save
    is writing (its `train.py` does both at the last step) races on the
    same temporary directory.

`restore` puts each tensor on its template's device, in its template's
dtype; with a `mesh` and a spec tree (`partitioning.param_specs`, ...) it
lays each tensor out as a DTensor over that mesh instead, which may differ
from the mesh that saved (elastic restore after a lost host). `reshard`
lays a live tree out over a (new) mesh the same way. The on-disk format
is the same either way.

Straggler mitigation is the reference's, copied: rounds that overrun a
robust deadline suppress the finetune quantum (finetune work is the shock
absorber, never the decode QoS).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map

# the dtypes numpy cannot (de)serialize, by their manifest names
_EXOTIC = {"bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_EXOTIC_NAMES = {v: k for k, v in _EXOTIC.items()}


def _to_savable(leaf):
    """(array to `np.save`, manifest dtype name, logical shape) of a host
    leaf: a CPU tensor, a numpy array or a Python int."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _EXOTIC_NAMES:
            t = leaf.contiguous()
            raw = t.reshape(-1).view(torch.uint8).reshape(
                *t.shape, t.element_size())
            return raw.numpy(), _EXOTIC_NAMES[leaf.dtype], list(t.shape)
        arr = leaf.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name, list(arr.shape)


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name in _EXOTIC:
        return t.reshape(-1).view(_EXOTIC[dtype_name]).reshape(arr.shape[:-1])
    return t


# ----------------------------------------------------------- tree <-> flat --
def _flatten(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    else:
        yield path, tree


def _unflatten(template, flat: Dict[str, Any], path=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{path}/{k}" if path else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, flat, f"{path}/{i}")
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    saved = flat[path]
    if isinstance(template, torch.Tensor):
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, int):
        return int(saved)
    return saved.numpy()


def _host_copy(tree):
    """The tree with every tensor copied to the host (ints and numpy
    arrays copied as they are), in the same structure and order."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, int):
        return tree
    return np.array(tree)


def snapshot(tree):
    """A host copy of `tree` that no later write to its tensors reaches:
    the card is synchronized first when a tensor lives there, so the copy
    also holds work queued on other streams."""
    devices = {leaf.device for _, leaf in _flatten(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return _host_copy(tree)


class CheckpointManager:
    """Atomic, async checkpoint manager of torch trees."""

    def __init__(self, directory, keep: int = 3):
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree, blocking: bool = True) -> None:
        self.wait()
        host_tree = snapshot(tree)
        if blocking:
            self._write(step, host_tree)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host_tree),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, step, tree):
        try:
            self._write(step, tree)
        except BaseException as e:   # surfaced on next wait()
            self._error = e

    def _write(self, step: int, tree) -> None:
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "leaves": {}, "time": time.time()}
        for i, (path, leaf) in enumerate(_flatten(tree)):
            fn = f"leaf_{i:05d}.npy"
            arr, dtype_name, shape = _to_savable(leaf)
            np.save(tmp / fn, arr, allow_pickle=False)
            manifest["leaves"][path] = {
                "file": fn, "shape": shape, "dtype": dtype_name}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                         # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.steps())
        # keep == 0 retains nothing: steps[:-0] would be the EMPTY slice
        # (retaining everything), so it needs its own branch
        drop = steps if self.keep == 0 else steps[:-self.keep]
        for s in drop:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ---------------------------------------------------------- restore --
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():        # committed only
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None, mesh=None,
                specs=None):
        """The tree of `template`'s structure from a committed step (the
        latest by default): tensors on their template's device and dtype,
        ints where the template has ints, numpy arrays elsewhere. With a
        `mesh`, each tensor is then laid out as a DTensor over it by its
        leaf of `specs` (a tree of `sharding.Spec`; replicated where
        `specs` is None), each rank keeping its shards."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {path: _from_saved(np.load(d / info["file"]), info["dtype"])
                for path, info in manifest["leaves"].items()}
        tree = _unflatten(template, flat)
        return tree if mesh is None else reshard(tree, mesh, specs)


def reshard(tree, mesh, specs=None):
    """Elastic re-layout of a tree onto a (new) mesh: every tensor leaf,
    the same full value on every rank (a DTensor is gathered first), laid
    out by its leaf of `specs` (replicated where `specs` is None); ints
    and numpy arrays stay as they are."""
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed.sharding import Spec

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x
    tree = tree_map(full, tree)
    if specs is None:
        specs = tree_map(lambda _: Spec(), tree)
    return PT.to_named(tree, specs, mesh)


# -------------------------------------------------------------- stragglers --
@dataclasses.dataclass
class StragglerConfig:
    window: int = 64             # rounds in the rolling estimate
    deadline_factor: float = 2.5  # x median = overrun
    cooloff_rounds: int = 8      # quantum suppressed after an overrun


class StragglerMitigator:
    """Decode-round deadline monitor: overruns (preemption, slow host,
    failing chip) shed finetune work first, never inference."""

    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.history: List[float] = []
        self.overruns = 0
        self._cooloff = 0

    def deadline(self) -> float:
        if len(self.history) < 8:
            return float("inf")
        h = sorted(self.history[-self.cfg.window:])
        return h[len(h) // 2] * self.cfg.deadline_factor

    def observe(self, round_s: float,
                expected_s: Optional[float] = None) -> bool:
        """Returns True when the round overran (caller drops quantum).

        With `expected_s` (the cost/predictor estimate for THIS round's
        (bs, k)), the gate is vs expectation — robust to the bimodal round
        distributions that co-location produces (k=0 vs k=k_max rounds
        differ 3x by design and must not look like stragglers). Without it,
        falls back to a rolling-median deadline."""
        if expected_s is not None and expected_s > 0:
            over = round_s > 2.0 * expected_s
        else:
            over = round_s > self.deadline()
        self.history.append(round_s)
        if over:
            self.overruns += 1
            self._cooloff = self.cfg.cooloff_rounds
        elif self._cooloff > 0:
            self._cooloff -= 1
        return over

    @property
    def suppress_quantum(self) -> bool:
        return self._cooloff > 0
