"""Two-stage latency predictor (paper §5).

Stage 1 — solo decode latency, one LR model per quantum level (paper: per SM
ratio, Eq. 2):      L(bs, s) = bs*b0 + c0 + bs*k0*s
Stage 2 — co-located decode latency (Eq. 3):
                    L_colo = (q_inf*b1 + q_ft*k1) * L_solo@q_inf

The port's own copy of `repro/core/predictor.py` (plain numpy; keep the
two in step). Two measurement sources fit it. `fit_from_costmodel` runs
the reference's offline profiling schedule (§8.8) against the roofline
cost model (`core/costmodel.py`, on the H100 spec and the constants fitted
on the card), sampled in the reference's order, so that on the same spec
its seeded noise draws and its coefficients equal the reference's.
`core/colocation.py::profile_rounds` measures rounds of the real engine on
the device it serves on instead, the route `launch/serve.py` takes by
default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import CostModel

PROFILE_BS = (4, 16, 64)
PROFILE_SEQLENS = tuple(range(64, 513, 64))


@dataclasses.dataclass
class FitReport:
    solo_samples: int = 0
    colo_samples: int = 0
    solo_mean_err: float = 0.0
    solo_max_err: float = 0.0
    colo_mean_err: float = 0.0          # roofline-max (production) form
    colo_max_err: float = 0.0
    colo_paper_mean_err: float = 0.0    # Eq. 3 verbatim, under fusion
    colo_paper_max_err: float = 0.0
    mixed_samples: int = 0
    mixed_mean_err: float = 0.0
    mixed_max_err: float = 0.0
    mixed_fused_samples: int = 0        # fused-quantum chunk rounds
    mixed_fused_mean_err: float = 0.0
    mixed_fused_max_err: float = 0.0


class TwoStageLatencyPredictor:
    """q_ft = k/k_max is the finetune quantum (TPU analogue of the SM ratio);
    q_inf = 1 - q_ft."""

    def __init__(self, k_max: int = 10):
        self.k_max = k_max
        self.quanta = [i / k_max for i in range(k_max + 1)]
        self.solo_coef: Dict[float, np.ndarray] = {}   # q_inf -> (b0, c0, k0)
        self.colo_coef: Optional[np.ndarray] = None    # Eq. 3 (b1, k1)
        self.colo_lr_coef: Optional[np.ndarray] = None  # roofline-LR
        self.mixed_coef: Optional[np.ndarray] = None    # chunked-prefill
        self.mixed_fused_coef: Optional[np.ndarray] = None  # q_ft>0 rounds
        self.report = FitReport()

    # ------------------------------------------------------------- stage 1
    @staticmethod
    def _solo_features(bs, s):
        bs = np.asarray(bs, np.float64)
        s = np.asarray(s, np.float64)
        return np.stack([bs, np.ones_like(bs), bs * s], axis=-1)

    def fit_solo(self, samples: Dict[float, List[Tuple[int, int, float]]]
                 ) -> None:
        """samples: q_inf -> [(bs, seqlen, latency_s)]."""
        errs = []
        for q, rows in samples.items():
            bs = np.array([r[0] for r in rows], np.float64)
            s = np.array([r[1] for r in rows], np.float64)
            y = np.array([r[2] for r in rows], np.float64)
            X = self._solo_features(bs, s)
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
            self.solo_coef[round(q, 6)] = coef
            pred = X @ coef
            errs.extend(np.abs(pred - y) / np.maximum(y, 1e-9))
            self.report.solo_samples += len(rows)
        self.report.solo_mean_err = float(np.mean(errs))
        self.report.solo_max_err = float(np.max(errs))

    def predict_solo(self, q_inf: float, bs: float, seqlen: float) -> float:
        key = min(self.solo_coef, key=lambda q: abs(q - q_inf))
        b0, c0, k0 = self.solo_coef[key]
        return float(bs * b0 + c0 + bs * k0 * seqlen)

    # ------------------------------------------------------------- stage 2
    #
    # Two co-location forms:
    #  * "paper"        — Eq. 3 verbatim: (q_inf*b1 + q_ft*k1) * L_solo@q_inf.
    #    Exact under *spatial* partitioning (the paper's GPU setting).
    #  * "roofline-max" — TPU adaptation: under temporal fusion the paper's
    #    own contention law (Eq. 4-5) yields a roofline, i.e. the max of two
    #    linear terms (memory-bound and compute-bound) in the same two
    #    regressors (solo latency, finetune quantum). Fit by 2-regime EM
    #    over plain lstsq. This is the production predictor; Fig. 12
    #    benchmarks report both.
    def _colo_features(self, q_ft, bs, s):
        base = self.predict_solo(1.0, bs, s)
        return np.array([base, q_ft, q_ft * base, 1.0], np.float64)

    def fit_colo(self, samples: List[Tuple[float, float, int, int, float]]
                 ) -> None:
        """samples: [(q_inf, q_ft, bs, seqlen, latency_s)]. One model across
        all (bs, seqlen) — paper §8.8."""
        # --- paper form (Eq. 3) ------------------------------------------
        Xp, y = [], []
        for q_inf, q_ft, bs, s, lat in samples:
            base = self.predict_solo(q_inf, bs, s)
            Xp.append([q_inf * base, q_ft * base])
            y.append(lat)
        Xp = np.asarray(Xp, np.float64)
        y = np.asarray(y, np.float64)
        self.colo_coef, *_ = np.linalg.lstsq(Xp, y, rcond=None)
        rel_p = np.abs(Xp @ self.colo_coef - y) / np.maximum(y, 1e-9)
        self.report.colo_paper_mean_err = float(np.mean(rel_p))
        self.report.colo_paper_max_err = float(np.max(rel_p))

        # --- roofline-LR form ---------------------------------------------
        # single lstsq on [L_solo, q_ft, q_ft*L_solo, 1]: the q_ft term is
        # the finetune units' compute slope, the interaction term captures
        # the bandwidth-contention coupling (Eq. 5). Deterministic and
        # seed-stable (a max-of-two-affine EM fit was tried and is worse).
        X = np.stack([self._colo_features(q_ft, bs, s)
                      for _, q_ft, bs, s, _ in samples])
        self.colo_lr_coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        pred = X @ self.colo_lr_coef
        rel = np.abs(pred - y) / np.maximum(y, 1e-9)
        self.report.colo_samples = len(y)
        self.report.colo_mean_err = float(np.mean(rel))
        self.report.colo_max_err = float(np.max(rel))

    def predict_colo(self, q_ft: float, bs: float, seqlen: float,
                     form: str = "roofline-max") -> float:
        """Predicted decode latency when q_ft of the round is granted to
        finetune units. q_ft=0 falls back to the stage-1 solo model."""
        if q_ft <= 0 or self.colo_lr_coef is None:
            return self.predict_solo(1.0, bs, seqlen)
        if form == "paper":
            q_inf = 1.0 - q_ft
            base = self.predict_solo(q_inf, bs, seqlen)
            b1, k1 = self.colo_coef
            return float((q_inf * b1 + q_ft * k1) * base)
        return float(self._colo_features(q_ft, bs, seqlen)
                     @ self.colo_lr_coef)

    # ------------------------------------------- stage 3 (chunked prefill)
    #
    # Mixed-round model for prefill_mode="chunked" (core/simulator.py): a
    # decode round that also carries `chunk_tokens` of prefill work. The
    # chunk's FLOPs are additive on the fused round's critical path (the
    # same linearity Eq. 5 gives the finetune quantum), so the model is
    # linear in the co-location baseline and the chunk size:
    #     L_mixed = a * L_colo(q_ft, bs, s) + b * chunk_tokens + c
    # Its inverse (`max_chunk_tokens`) is what the chunked scheduler uses
    # to price a chunk's TPOT impact BEFORE admitting it into a round —
    # the QoS guarantee stays prediction-driven, exactly like the finetune
    # quantum path.
    def _mixed_features(self, q_ft, bs, s, chunk_tokens):
        base = self.predict_colo(q_ft, bs, s)
        return np.array([base, float(chunk_tokens), 1.0], np.float64)

    def fit_mixed(self, samples: List[Tuple[float, int, int, int, float]]
                  ) -> None:
        """samples: [(q_ft, bs, seqlen, chunk_tokens, latency_s)]."""
        X = np.stack([self._mixed_features(q, bs, s, ct)
                      for q, bs, s, ct, _ in samples])
        y = np.array([lat for *_, lat in samples], np.float64)
        self.mixed_coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        rel = np.abs(X @ self.mixed_coef - y) / np.maximum(y, 1e-9)
        self.report.mixed_samples = len(y)
        self.report.mixed_mean_err = float(np.mean(rel))
        self.report.mixed_max_err = float(np.max(rel))

    def predict_mixed(self, q_ft: float, bs: float, seqlen: float,
                      chunk_tokens: int) -> float:
        """Predicted round latency with a prefill chunk mixed in."""
        if chunk_tokens <= 0 or self.mixed_coef is None:
            return self.predict_colo(q_ft, bs, seqlen)
        return float(self._mixed_features(q_ft, bs, seqlen, chunk_tokens)
                     @ self.mixed_coef)

    # -------------------------------------- fused-quantum chunk rounds
    #
    # ``ChunkedPrefillConfig.fuse_quantum`` prices rounds that carry BOTH
    # a prefill chunk and a reduced finetune quantum. The base mixed
    # stage is profiled exclusively at q_ft=0 (its inverse prices the
    # chunk cap on quantum-0 rounds and must stay bit-stable), so
    # extrapolating it to q_ft>0 carries 25-45% error at large quanta.
    # This stage refits the same linear form on samples that *include*
    # q_ft>0 rounds, so the fused admission check interpolates instead.
    def fit_mixed_fused(self, samples: List[Tuple[float, int, int, int,
                                                  float]]) -> None:
        """samples: [(q_ft, bs, seqlen, chunk_tokens, latency_s)] with
        q_ft spanning 0..~0.8."""
        X = np.stack([self._mixed_features(q, bs, s, ct)
                      for q, bs, s, ct, _ in samples])
        y = np.array([lat for *_, lat in samples], np.float64)
        self.mixed_fused_coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        rel = np.abs(X @ self.mixed_fused_coef - y) / np.maximum(y, 1e-9)
        self.report.mixed_fused_samples = len(y)
        self.report.mixed_fused_mean_err = float(np.mean(rel))
        self.report.mixed_fused_max_err = float(np.max(rel))

    def predict_mixed_fused(self, q_ft: float, bs: float, seqlen: float,
                            chunk_tokens: int) -> float:
        """Predicted latency of a round carrying a chunk AND a finetune
        quantum — the fused-admission price check. Falls back to the
        q_ft=0 mixed stage when the fused stage is not fitted."""
        if self.mixed_fused_coef is None:
            return self.predict_mixed(q_ft, bs, seqlen, chunk_tokens)
        if chunk_tokens <= 0:
            return self.predict_colo(q_ft, bs, seqlen)
        return float(self._mixed_features(q_ft, bs, seqlen, chunk_tokens)
                     @ self.mixed_fused_coef)

    def max_chunk_tokens(self, q_ft: float, bs: float, seqlen: float,
                         limit_s: float, cap: int) -> int:
        """Largest prefill chunk (<= cap) whose predicted mixed-round
        latency stays under ``limit_s`` — the admission price check."""
        if self.mixed_coef is None:
            return cap
        a, b, c = self.mixed_coef
        base = self.predict_colo(q_ft, bs, seqlen)
        if b <= 0:                       # degenerate fit: no per-token cost
            return cap
        room = limit_s - (a * base + c)
        return int(max(min(room / b, float(cap)), 0.0))

    # --------------------------------------------------- profiling driver
    def fit_from_costmodel(self, cm: CostModel, micro_batch: int = 2,
                           ft_seq: int = 1024) -> FitReport:
        """Paper §8.8 offline profiling schedule, against the cost model.

        Solo: k_max quantum levels x 3 batch sizes x 8 seqlens <= 512, one
        decode round each. Colo: k_max - 1 quanta x 3 batch sizes x 3
        contexts. Then the two chunked-prefill stages."""
        solo: Dict[float, List[Tuple[int, int, float]]] = {}
        for q in self.quanta[1:]:                 # q_inf in 0.1..1.0
            rows = []
            for bs in PROFILE_BS:
                for s in PROFILE_SEQLENS:
                    rows.append((bs, s, cm.decode_solo(bs, s, quantum=q)))
            solo[q] = rows
        self.fit_solo(solo)

        colo = []
        for ki in range(1, self.k_max):           # q_ft = ki/k_max
            q_ft = ki / self.k_max
            for bs in PROFILE_BS:
                for s in (128, 256, 512):
                    lat = cm.colocated_round(bs, s, ki, micro_batch, ft_seq)
                    colo.append((1.0 - q_ft, q_ft, bs, s, lat))
        self.fit_colo(colo)

        # chunked-prefill stage: decode rounds carrying a prefill chunk.
        # Profiled at q_ft=0 — the chunked scheduler preempts finetune on
        # chunk rounds (inference work beats finetune, §2.3), so that is
        # the operating point the inverse (max_chunk_tokens) prices.
        mixed = []
        for bs in PROFILE_BS:
            for s in (128, 256, 512):
                for ct in (64, 128, 256, 512):
                    lat = cm.mixed_round_latency(bs, s, ct, chunk_ctx=s)
                    mixed.append((0.0, bs, s, ct, lat))
        self.fit_mixed(mixed)

        # fused-quantum stage (fuse_quantum rounds: chunk + reduced
        # quantum). Sampled AFTER everything above so the q_ft=0 stages'
        # samples — and therefore their coefficients and every seeded
        # noise draw they consume — are bit-identical with or without it.
        fused = list(mixed)
        # low/mid/high quanta scaled to k_max (== (2, 5, 8) at the
        # default k_max=10); every sample stays physically reachable
        ks = sorted({max(self.k_max // 5, 1), max(self.k_max // 2, 1),
                     max(4 * self.k_max // 5, 1)})
        for ki in ks:
            q_ft = ki / self.k_max
            for bs in PROFILE_BS:
                for s in (128, 256, 512):
                    for ct in (64, 256):
                        lat = cm.mixed_round_latency(
                            bs, s, ct, chunk_ctx=s, k_units=ki,
                            micro_batch=micro_batch, seq_len=ft_seq)
                        fused.append((q_ft, bs, s, ct, lat))
        self.fit_mixed_fused(fused)
        return self.report
