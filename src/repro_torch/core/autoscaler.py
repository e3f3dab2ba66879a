"""Periodic fleet controller: decode-pool sizing + instance role flips.

Runs every ``interval_s`` of simulated time over a snapshot of per-instance
signals and emits at most one action per tick ("Taming the Chaos"-style
coordinated scaling: small reversible steps with a cooldown, never a bulk
reconfiguration). Actions:

  * ``add_instance``      — fleet saturated (high load or QoS violations
                            with no colocation left to shed)
  * ``remove_instance``   — sustained low load; the chosen instance drains
  * ``to_decode(id)``     — QoS under pressure: pause that instance's
                            finetune job (cheapest headroom first, §2.3 —
                            inference always preempts finetune)
  * ``to_colocated(id)``  — QoS headroom back + finetune backlog: resume
  * ``to_finetune(id)``   — deep idle + large backlog: dedicate an idle
                            instance to finetune until load returns
  * ``none``

A second, independent control loop (``evaluate_prefill``) sizes the
disaggregated prefill pool (core/prefill_pool.py); its chunked-mode
variant (``evaluate_chunked``) tunes the fleet-wide per-round chunk budget
instead (``grow_chunk_budget`` / ``shrink_chunk_budget``) — which loop
runs is the prefill placement's call (core/policies/placement.py).

This class is **mechanism only**: cooldown bookkeeping and the decision
log. The decisions themselves are ``ScalingPolicy`` classes resolved by
name through the control-plane registry (core/api.py; built-ins in
core/policies/scaling.py) — ``AutoscalerConfig.decode_policy`` /
``prefill_policy`` / ``chunk_policy`` select them, so a new scaling
strategy (model-predictive, deadline-aware, ...) is a registered plugin,
not an edit here. The controller never touches instances itself; the
cluster event loop (core/cluster.py) applies decisions. That keeps the
invariants testable — e.g. the built-in decode policy can never emit
``remove_instance`` or ``to_finetune`` when doing so would leave fewer
than ``min_decode`` serving instances.

The port's own copy of `repro/core/autoscaler.py` (plain Python and numpy;
keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core import api

ACTIONS = ("none", "add_instance", "remove_instance",
           "to_decode", "to_colocated", "to_finetune",
           "add_prefill", "remove_prefill",
           "grow_chunk_budget", "shrink_chunk_budget")


@dataclasses.dataclass
class AutoscalerConfig:
    interval_s: float = 5.0
    min_decode: int = 1              # serving instances, hard floor
    max_decode: int = 16
    scale_up_load: float = 0.85      # mean serving load above -> grow
    scale_down_load: float = 0.25    # mean serving load below -> shrink
    viol_frac_shed: float = 0.02     # QoS violations above -> shed finetune
    viol_frac_resume: float = 0.005  # below (and backlog) -> resume
    idle_load_ft: float = 0.05       # below (and backlog) -> dedicate to ft
    ft_target_iters_per_s: float = 0.0   # finetune demand; 0 = best-effort
    cooldown_ticks: int = 2          # ticks to wait after any action
    # ---- prefill-pool loop (coordinated with the decode loop: the pool
    # floor tracks the serving fleet so the two tiers move together,
    # ByteDance arXiv 2508.19559-style joint scaling against SLO headroom)
    min_prefill: int = 1             # pool hard floor
    max_prefill: int = 16
    prefill_per_decode: float = 1.0  # coordinated floor: ceil(r * serving)
    prefill_queue_hi: float = 2.0    # queued per worker above -> grow
    ttft_headroom: float = 0.6       # wait_p99 above frac*TTFT-SLO -> grow
    prefill_idle_backlog_s: float = 0.05  # backlog below + empty -> shrink
    prefill_cooldown_ticks: int = 0
    # ---- chunked-mode prefill loop (prefill_mode="chunked"): there is no
    # pool to size, so the same control slot tunes the per-round chunk
    # budget instead — grow when TTFT headroom erodes, give the tokens
    # back to decode/finetune when TTFT is comfortable but TPOT is not
    chunk_step_tokens: int = 64      # budget delta per action
    # ---- registered ScalingPolicy names, one per control loop
    decode_policy: str = "decode_fleet"
    prefill_policy: str = "pooled_prefill"
    chunk_policy: str = "chunked_budget"


@dataclasses.dataclass(frozen=True)
class InstanceSnapshot:
    inst_id: int
    role: str                        # decode | colocated | finetune
    load: float                      # queue+active over slot budget
    active: int                      # in-flight decode requests
    colocatable: bool                # has a finetune job attached
    can_serve: bool = True           # holds inference weights
    draining: bool = False


@dataclasses.dataclass
class ScaleDecision:
    t: float
    action: str                      # one of ACTIONS
    target: int = -1                 # instance id for role flips / removal
    reason: str = ""


class Autoscaler:
    def __init__(self, cfg: AutoscalerConfig = AutoscalerConfig()):
        self.cfg = cfg
        self.decisions: List[ScaleDecision] = []
        self._cooldown = 0
        self._prefill_cooldown = 0
        self._policies: Dict[str, api.ScalingPolicy] = {}
        self.prefill_ttft_slo_s = 4.0   # set by the cluster (RouterConfig)

    def _policy(self, name: str) -> api.ScalingPolicy:
        inst = self._policies.get(name)
        if inst is None:
            inst = self._policies[name] = \
                api.resolve_policy("scaling", name)()
        return inst

    # ------------------------------------------------------- decode loop --
    def evaluate(self, t: float, snaps: List[InstanceSnapshot],
                 viol_frac: float, ft_backlog: float = 0.0) -> ScaleDecision:
        """One decode-loop control tick: delegate to the configured
        ``decode_policy``, apply cooldown, record the decision."""
        if self._cooldown > 0:
            self._cooldown -= 1
            d = ScaleDecision(t, "none", reason="cooldown")
        else:
            d = self._policy(self.cfg.decode_policy).decide(
                t, self.cfg, dict(snaps=snaps, viol_frac=viol_frac,
                                  ft_backlog=ft_backlog))
            if d.action != "none":
                self._cooldown = self.cfg.cooldown_ticks
        assert d.action in ACTIONS
        self.decisions.append(d)
        return d

    # -------------------------------------------------- prefill-pool loop --
    def prefill_floor(self, n_serving: int) -> int:
        """Coordinated pool floor: the prefill tier tracks the decode tier
        (``prefill_per_decode`` workers per serving instance) so a decode
        scale-up pulls prefill capacity with it instead of waiting for the
        queue to back up first."""
        from repro_torch.core.policies.scaling import coordinated_prefill_floor
        return coordinated_prefill_floor(self.cfg, n_serving)

    def evaluate_prefill(self, t: float, snap, n_serving: int
                         ) -> ScaleDecision:
        """One prefill-pool control tick (second loop), delegating to the
        configured ``prefill_policy``. Own cooldown so a decode action
        never starves the pool of attention; decisions land in the same
        log as the decode loop's. ``snap`` is a PrefillPoolSnapshot."""
        return self._prefill_tick(
            t, self.cfg.prefill_policy,
            dict(snap=snap, n_serving=n_serving,
                 ttft_slo_s=self.prefill_ttft_slo_s))

    def evaluate_chunked(self, t: float, wait_p99: float, viol_frac: float,
                         budget: int, lo: int, hi: int, n_serving: int = 0
                         ) -> ScaleDecision:
        """Chunked-mode variant of the prefill control loop: no pool to
        size, so it tunes the fleet-wide per-round chunk budget against
        TTFT headroom (``target`` on the decision carries the new budget),
        escalating to ``add_instance`` once the budget is maxed. Shares
        the prefill loop's cooldown — it occupies the same control slot,
        just mode-aware."""
        return self._prefill_tick(
            t, self.cfg.chunk_policy,
            dict(wait_p99=wait_p99, viol_frac=viol_frac, budget=budget,
                 lo=lo, hi=hi, n_serving=n_serving,
                 ttft_slo_s=self.prefill_ttft_slo_s))

    def _prefill_tick(self, t: float, policy: str,
                      signals: Dict) -> ScaleDecision:
        if self._prefill_cooldown > 0:
            self._prefill_cooldown -= 1
            d = ScaleDecision(t, "none", reason="prefill cooldown")
        else:
            d = self._policy(policy).decide(t, self.cfg, signals)
            if d.action != "none":
                self._prefill_cooldown = self.cfg.prefill_cooldown_ticks
        assert d.action in ACTIONS
        self.decisions.append(d)
        return d
