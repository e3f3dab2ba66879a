"""QoS-guaranteed throughput-maximizing scheduler (paper §6).

Each decode round the scheduler picks the largest finetune quantum k (layer
units fused into the round) whose *predicted* co-located decode latency stays
within the QoS target. Predicting a violation pauses the finetune task
(k = 0, inference preempts everything); a finetune stall on window swaps does
the same (§6.2). A small multiplicative safety margin adapts from observed
latencies (feedback guard against model drift — beyond-paper hardening,
defaults to the paper's behaviour when predictions are accurate).

The port's own copy of `repro/core/scheduler.py` (plain Python; keep the
two in step).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.predictor import TwoStageLatencyPredictor


@dataclasses.dataclass
class SchedulerConfig:
    qos_s: float = 0.040            # 40 ms TPOT (paper §8.1)
    k_max: int = 10
    safety: float = 0.95            # fraction of QoS budget usable
    margin_adapt: float = 0.05      # feedback step on violations
    margin_floor: float = 0.70


@dataclasses.dataclass
class RoundDecision:
    k: int
    predicted_s: float
    reason: str                      # "ok" | "stalled" | "idle" | "qos"


class QoSScheduler:
    def __init__(self, predictor: TwoStageLatencyPredictor,
                 cfg: SchedulerConfig = SchedulerConfig()):
        self.pred = predictor
        self.cfg = cfg
        self.margin = cfg.safety
        self.violations = 0
        self.rounds = 0
        self.decisions: List[RoundDecision] = []

    def pick(self, bs: int, mean_ctx: float, *, ft_ready: bool,
             ft_units_available: int) -> RoundDecision:
        """Select the finetune quantum for the next decode round."""
        self.rounds += 1
        if bs == 0:
            # no decode work: finetune free-runs (max units per round)
            k = min(self.cfg.k_max, ft_units_available) if ft_ready else 0
            d = RoundDecision(k, 0.0, "idle")
        elif not ft_ready or ft_units_available <= 0:
            d = RoundDecision(0, self.pred.predict_colo(0.0, bs, mean_ctx),
                              "stalled")
        else:
            budget = self.cfg.qos_s * self.margin
            k_best, pred_best = 0, self.pred.predict_colo(0.0, bs, mean_ctx)
            for k in range(min(self.cfg.k_max, ft_units_available), 0, -1):
                p = self.pred.predict_colo(k / self.cfg.k_max, bs, mean_ctx)
                if p <= budget:
                    k_best, pred_best = k, p
                    break
            d = RoundDecision(k_best, pred_best,
                              "ok" if k_best > 0 else "qos")
        self.decisions.append(d)
        return d

    def observe(self, actual_s: float) -> None:
        """Feedback from the finished round: tighten the margin on QoS
        violations, relax it slowly when well under budget."""
        if actual_s > self.cfg.qos_s:
            self.violations += 1
            self.margin = max(self.margin - self.cfg.margin_adapt,
                              self.cfg.margin_floor)
        elif actual_s < 0.8 * self.cfg.qos_s and \
                self.margin < self.cfg.safety:
            self.margin = min(self.margin + self.cfg.margin_adapt / 4,
                              self.cfg.safety)
