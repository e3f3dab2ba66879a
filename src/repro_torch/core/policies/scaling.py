"""Built-in autoscaler control-loop policies.

Each class is one loop's pure decision function, lifted out of the
``Autoscaler`` (which keeps the mechanism: cooldown bookkeeping and the
decision log). Signals are passed as a plain dict so a custom loop can
carry extra inputs without changing the mechanism's signature:

  * ``decode_fleet``   — signals: snaps (List[InstanceSnapshot]),
    viol_frac, ft_backlog
  * ``pooled_prefill`` — signals: snap (PrefillPoolSnapshot), n_serving,
    ttft_slo_s
  * ``chunked_budget`` — signals: wait_p99, viol_frac, budget, lo, hi,
    n_serving, ttft_slo_s

The port's own copy of `repro/core/policies/scaling.py` (plain Python and
numpy; keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

import math
from typing import Dict

from repro_torch.core.api import ScalingPolicy, register_policy
from repro_torch.core.autoscaler import ScaleDecision


def coordinated_prefill_floor(cfg, n_serving: int) -> int:
    """Coordinated pool floor: the prefill tier tracks the decode tier
    (``prefill_per_decode`` workers per serving instance) so a decode
    scale-up pulls prefill capacity with it instead of waiting for the
    queue to back up first."""
    floor = max(cfg.min_prefill,
                math.ceil(cfg.prefill_per_decode * n_serving))
    return min(floor, cfg.max_prefill)


@register_policy("decode_fleet")
class DecodeFleetScaling(ScalingPolicy):
    """The decode loop: grow/shrink the serving fleet, flip roles between
    decode-only / co-located / finetune-dedicated on QoS headroom and
    finetune backlog ("Taming the Chaos"-style small reversible steps)."""

    def decide(self, t: float, cfg, signals: Dict) -> ScaleDecision:
        snaps = signals["snaps"]
        viol_frac = signals["viol_frac"]
        ft_backlog = signals["ft_backlog"]
        serving = [s for s in snaps if s.role != "finetune"
                   and not s.draining]
        n_serving = len(serving)
        mean_load = (sum(s.load for s in serving) / n_serving) \
            if n_serving else 1.0
        colocated = [s for s in serving if s.role == "colocated"]
        paused = [s for s in serving if s.role == "decode" and s.colocatable]
        dedicated = [s for s in snaps if s.role == "finetune"
                     and s.colocatable and s.can_serve and not s.draining]

        # --- QoS pressure: shed finetune first, then grow the fleet ------
        if viol_frac > cfg.viol_frac_shed:
            if colocated:
                victim = max(colocated, key=lambda s: (s.load, s.inst_id))
                return ScaleDecision(t, "to_decode", victim.inst_id,
                                     f"viol={viol_frac:.3f}")
            if n_serving < cfg.max_decode:
                return ScaleDecision(t, "add_instance",
                                     reason=f"viol={viol_frac:.3f}")
            return ScaleDecision(t, "none", reason="at max_decode")
        if mean_load > cfg.scale_up_load:
            if n_serving < cfg.max_decode:
                return ScaleDecision(t, "add_instance",
                                     reason=f"load={mean_load:.2f}")
            if colocated:
                victim = max(colocated, key=lambda s: (s.load, s.inst_id))
                return ScaleDecision(t, "to_decode", victim.inst_id,
                                     f"load={mean_load:.2f} at max_decode")
            return ScaleDecision(t, "none", reason="at max_decode")

        # --- headroom: give capacity back to finetune --------------------
        if viol_frac < cfg.viol_frac_resume and ft_backlog > 0:
            if paused:
                pick = min(paused, key=lambda s: (s.load, s.inst_id))
                return ScaleDecision(t, "to_colocated", pick.inst_id,
                                     f"backlog={ft_backlog:.1f}")
            idle = [s for s in colocated
                    if s.load <= cfg.idle_load_ft and s.active == 0]
            if idle and n_serving > cfg.min_decode:
                pick = min(idle, key=lambda s: (s.load, s.inst_id))
                return ScaleDecision(t, "to_finetune", pick.inst_id,
                                     f"backlog={ft_backlog:.1f} idle fleet")

        # --- sustained low load: shrink ----------------------------------
        if mean_load < cfg.scale_down_load and n_serving > cfg.min_decode:
            pick = min(serving, key=lambda s: (s.load, s.inst_id))
            return ScaleDecision(t, "remove_instance", pick.inst_id,
                                 f"load={mean_load:.2f}")
        # finetune-dedicated instances rejoin serving when load recovers
        if dedicated and mean_load > 2 * cfg.scale_down_load:
            pick = min(dedicated, key=lambda s: s.inst_id)
            return ScaleDecision(t, "to_colocated", pick.inst_id,
                                 "load recovered")
        return ScaleDecision(t, "none")


@register_policy("pooled_prefill")
class PooledPrefillScaling(ScalingPolicy):
    """The prefill-pool loop: grow on TTFT-headroom loss or queue depth,
    shrink on deep idle, never below the floor coordinated with the
    decode fleet."""

    def decide(self, t: float, cfg, signals: Dict) -> ScaleDecision:
        snap = signals["snap"]
        n_serving = signals["n_serving"]
        slo = signals["ttft_slo_s"]
        n = snap.n_workers
        floor = coordinated_prefill_floor(cfg, n_serving)
        if n < floor:
            return ScaleDecision(t, "add_prefill",
                                 reason=f"floor={floor} serving={n_serving}")
        # TTFT headroom / queue pressure -> grow
        if n < cfg.max_prefill:
            if snap.queue_depth > cfg.prefill_queue_hi * max(n, 1):
                return ScaleDecision(t, "add_prefill",
                                     reason=f"queue={snap.queue_depth}")
            if slo > 0 and snap.wait_p99 > cfg.ttft_headroom * slo:
                return ScaleDecision(
                    t, "add_prefill",
                    reason=f"wait_p99={snap.wait_p99:.2f}")
        # deep idle above the coordinated floor -> shrink
        if n > floor and snap.queue_depth == 0 \
                and snap.backlog_s <= cfg.prefill_idle_backlog_s \
                and (slo <= 0 or snap.wait_p99 <
                     0.5 * cfg.ttft_headroom * slo):
            return ScaleDecision(t, "remove_prefill",
                                 reason=f"idle backlog={snap.backlog_s:.2f}")
        return ScaleDecision(t, "none")


@register_policy("chunked_budget")
class ChunkedBudgetScaling(ScalingPolicy):
    """The chunked-mode prefill loop: AIMD-tune the fleet-wide per-round
    chunk budget against TTFT headroom, escalating to fleet growth once
    the budget is maxed (in chunked mode prefill capacity IS the decode
    fleet)."""

    def decide(self, t: float, cfg, signals: Dict) -> ScaleDecision:
        wait_p99 = signals["wait_p99"]
        viol_frac = signals["viol_frac"]
        budget = signals["budget"]
        lo, hi = signals["lo"], signals["hi"]
        n_serving = signals["n_serving"]
        slo = signals["ttft_slo_s"]
        step = cfg.chunk_step_tokens
        # TTFT headroom eroding -> spend more of each round on prefill;
        # once the budget is maxed (or the QoS price caps below it), the
        # only remaining lever is decode capacity itself — in chunked mode
        # prefill capacity IS the decode fleet, so this loop may grow it
        if slo > 0 and wait_p99 > cfg.ttft_headroom * slo:
            if budget < hi:
                # multiplicative increase / additive decrease: a backlog
                # compounds while the budget crawls, so growth must outrun
                # it — escalation to fleet growth then starts within a few
                # ticks instead of after max_budget/step of them
                return ScaleDecision(
                    t, "grow_chunk_budget", target=min(budget * 2, hi),
                    reason=f"chunk_wait_p99={wait_p99:.2f}")
            if n_serving < cfg.max_decode:
                return ScaleDecision(
                    t, "add_instance",
                    reason=f"chunk_wait_p99={wait_p99:.2f} budget maxed")
            return ScaleDecision(t, "none", reason="at max_decode")
        # TTFT comfortable but TPOT under pressure -> hand tokens back
        if budget > lo and viol_frac > cfg.viol_frac_shed and \
                (slo <= 0 or wait_p99 < 0.5 * cfg.ttft_headroom * slo):
            return ScaleDecision(
                t, "shrink_chunk_budget", target=max(budget - step, lo),
                reason=f"viol={viol_frac:.3f}")
        return ScaleDecision(t, "none")
