"""Synthetic token data pipeline: Zipf-corpus generation + sequence packing.

The port's own copy of `repro/training/data.py` (plain numpy; the port
imports nothing of the JAX package): the same seed gives the same batches,
which the tests check. Keep the two in step.

Double-buffered host staging (``Prefetcher``) mirrors a production input
pipeline: the PEFT engine consumes microbatches from a ring of staged
device tensors (`training/peft.py::init_ft_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    zipf_a: float = 1.2
    doc_len_mean: int = 512
    seed: int = 0
    frontend_tokens: int = 0       # VLM stub patches per sample
    enc_frames: int = 0            # audio stub frames per sample
    d_model: int = 0


class SyntheticCorpus:
    """Zipf-distributed token documents packed to fixed-length sequences."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def _doc(self) -> np.ndarray:
        n = max(int(self.rng.exponential(self.cfg.doc_len_mean)), 8)
        toks = self.rng.zipf(self.cfg.zipf_a, size=n)
        return np.minimum(toks, self.cfg.vocab_size - 1).astype(np.int32)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        buf = np.empty((0,), np.int32)
        while True:
            need = cfg.batch_size * (cfg.seq_len + 1)
            while buf.size < need:
                buf = np.concatenate([buf, self._doc(),
                                      np.array([0], np.int32)])  # doc sep
            chunk = buf[:need].reshape(cfg.batch_size, cfg.seq_len + 1)
            buf = buf[need:]
            # loss_fn shifts internally: CE(logits[:, :-1], labels[:, 1:]),
            # so labels == tokens is the standard next-token setup.
            batch = {"tokens": chunk[:, :-1].copy(),
                     "labels": chunk[:, :-1].copy(),
                     "mask": np.ones((cfg.batch_size, cfg.seq_len),
                                     np.float32)}
            if cfg.frontend_tokens and cfg.d_model:
                batch["frontend"] = self.rng.normal(
                    size=(cfg.batch_size, cfg.frontend_tokens, cfg.d_model)
                ).astype(np.float32)
            if cfg.enc_frames and cfg.d_model:
                batch["enc_frames"] = self.rng.normal(
                    size=(cfg.batch_size, cfg.enc_frames, cfg.d_model)
                ).astype(np.float32)
            yield batch


class Prefetcher:
    """Ring of pre-staged microbatches (the engine's host->device pipeline)."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], depth: int = 2):
        self.it = it
        self.depth = depth
        self.ring = [next(it) for _ in range(depth)]
        self.head = 0

    def refill(self, consumed: int) -> None:
        for _ in range(consumed):
            self.ring[self.head] = next(self.it)
            self.head = (self.head + 1) % self.depth

    def stacked(self) -> Dict[str, np.ndarray]:
        """(depth, B, ...) arrays for staging into the unit state."""
        keys = self.ring[0].keys()
        return {k: np.stack([r[k] for r in self.ring]) for k in keys}
