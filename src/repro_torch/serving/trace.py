"""Synthetic Splitwise-like LLM request trace.

The paper drives evaluation with the Microsoft Azure LLM inference trace
(Patel et al., ISCA'24), which is not available offline. This generator
reproduces its load characteristics qualitatively (DESIGN.md §2): bursty
Gamma inter-arrivals with a slowly-varying rate envelope, lognormal prompt
lengths, and lognormal output lengths — tuned so a single decode instance
sees batch sizes fluctuating roughly 0–60 (paper Fig. 3).

The port's own copy of `repro/serving/trace.py` (numpy; keep the two in
step), on the port's `Request`: for every scenario and seed the requests
and failure schedules equal the reference's (`tests/test_torch_simulator.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import (GROUP_SEG_BASE, SESSION_SEG_BASE,
                                   Request)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    duration_s: float = 3600.0
    mean_rps: float = 5.3            # ~19k requests/hour (paper §8.1)
    burstiness: float = 0.35         # gamma shape (lower = burstier)
    rate_period_s: float = 600.0     # load-envelope oscillation period
    rate_amplitude: float = 0.6      # envelope swing (fraction of mean)
    prompt_median: int = 1024
    prompt_sigma: float = 0.8        # lognormal sigma
    prompt_max: int = 8192
    output_median: int = 128
    output_sigma: float = 0.9
    output_max: int = 1024
    # multiplicative flash-crowd window (spike preset; 1.0 = disabled)
    spike_mult: float = 1.0
    spike_start_frac: float = 0.4    # window position, fraction of duration
    spike_dur_frac: float = 0.15
    # sticky sessions (session_affinity routing): 0 = sessionless trace.
    # Session ids are drawn Zipf-like from a separate RNG stream so enabling
    # them never perturbs the arrival/length draws of an existing seed.
    n_sessions: int = 0
    session_zipf_a: float = 1.2      # few hot sessions, long cold tail
    # multi-tenant adapter traffic (core/adapters.py): per-tenant arrival
    # weights; empty = single-tenant (every request serves the base model,
    # adapter_id -1). Tenant draws use their own RNG stream (like session
    # ids) so enabling tenants never perturbs an existing seed's trace.
    tenant_weights: Tuple[float, ...] = ()
    # cross-session shared prompt prefixes (core/prefix_tree.py): each
    # session belongs to one of ``shared_prefix_groups`` groups whose
    # requests open with the same ``shared_prefix_tokens``-token system
    # prompt, expressed as Request.prefix_segments. 0 groups = disabled.
    # Group assignment uses its own RNG stream (like sessions/tenants) so
    # enabling it never perturbs an existing seed's trace.
    shared_prefix_groups: int = 0
    shared_prefix_tokens: int = 0
    seed: int = 0


def generate(cfg: TraceConfig = TraceConfig()) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    reqs: List[Request] = []
    spike_lo = cfg.spike_start_frac * cfg.duration_s
    spike_hi = spike_lo + cfg.spike_dur_frac * cfg.duration_s
    t, rid = 0.0, 0
    while t < cfg.duration_s:
        envelope = 1.0 + cfg.rate_amplitude * math.sin(
            2 * math.pi * t / cfg.rate_period_s)
        if cfg.spike_mult != 1.0 and spike_lo <= t < spike_hi:
            envelope *= cfg.spike_mult
        rate = max(cfg.mean_rps * envelope, 1e-3)
        # gamma-distributed gap with mean 1/rate, shape = burstiness
        gap = rng.gamma(cfg.burstiness, 1.0 / (rate * cfg.burstiness))
        t += gap
        if t >= cfg.duration_s:
            break
        p = int(min(rng.lognormal(math.log(cfg.prompt_median),
                                  cfg.prompt_sigma), cfg.prompt_max))
        o = int(min(rng.lognormal(math.log(cfg.output_median),
                                  cfg.output_sigma), cfg.output_max))
        reqs.append(Request(rid=rid, arrival=t, prompt_len=max(p, 1),
                            max_new_tokens=max(o, 1)))
        rid += 1
    if cfg.n_sessions > 0:
        srng = np.random.default_rng(cfg.seed + 104729)
        for r in reqs:
            r.session_id = int(srng.zipf(cfg.session_zipf_a)
                               % cfg.n_sessions)
    if cfg.tenant_weights:
        trng = np.random.default_rng(cfg.seed + TENANT_SEED_SALT)
        w = np.asarray(cfg.tenant_weights, dtype=float)
        p = w / w.sum()
        for r in reqs:
            r.adapter_id = int(trng.choice(len(p), p=p))
    if cfg.shared_prefix_groups > 0 and cfg.shared_prefix_tokens > 0 \
            and cfg.n_sessions > 0:
        grng = np.random.default_rng(cfg.seed + SHARED_PREFIX_SEED_SALT)
        group_of = grng.integers(cfg.shared_prefix_groups,
                                 size=cfg.n_sessions)
        for r in reqs:
            # the system prompt covers at most the cacheable prompt (the
            # final token is never cached); too-short prompts stay opaque
            sys_len = min(cfg.shared_prefix_tokens, r.prompt_len - 1)
            rest = r.prompt_len - sys_len
            if sys_len <= 0 or rest <= 0:
                continue
            g = int(group_of[r.session_id])
            r.prefix_segments = (
                (GROUP_SEG_BASE + g, sys_len),
                (SESSION_SEG_BASE + r.session_id, rest),
            )
    return reqs


# ---------------------------------------------------- failure injection
# Own RNG stream salt (like the session stream's 104729): a failure
# schedule for seed s never perturbs the arrival/length draws of seed s.
FAILURE_SEED_SALT = 92821

# Tenant-assignment stream salt (same isolation property as above).
TENANT_SEED_SALT = 74093

# Session->shared-prefix-group stream salt (same isolation property).
SHARED_PREFIX_SEED_SALT = 48611


@dataclasses.dataclass(frozen=True)
class FailureConfig:
    """Failure/preemption injection for the cluster layer (core/cluster.py,
    ``ClusterConfig.failures``). Kills arrive as a Poisson process over the
    whole fleet; each event takes one victim (a live instance, or an active
    pooled prefill worker) chosen uniformly from the eligible candidates.

    ``warning_s > 0`` turns hard kills into spot-style preemptions: the
    victim gets a notice, drains gracefully (no new dispatches, finetune
    commits a final checkpoint and stops) and is hard-killed only if work
    remains at the deadline. ``checkpoint_interval_s`` is the cadence at
    which colocated/dedicated finetune jobs commit progress through the
    fault-tolerance ``CheckpointManager`` — a kill rolls the job back to
    its last commit, and each commit's device->host stream time is charged
    to the finetune quantum budget (``CostModel.checkpoint_time``).
    0 disables checkpointing (a kill loses all finetune progress)."""
    rate_per_min: float = 0.0        # fleet-wide Poisson kill rate; 0 = off
    warning_s: float = 0.0           # preemption notice; 0 = hard kill
    start_s: float = 0.0             # grace period before the first event
    checkpoint_interval_s: float = 20.0
    checkpoint_dir: Optional[str] = None   # None = private temp dir
    seed: int = 0


class FailureSchedule:
    """Seeded Poisson kill times + deterministic victim choice.

    The schedule is fully determined by ``(cfg, duration_s)`` — two runs
    with the same failure config see identical kill times regardless of
    mode or fleet shape, so harli-vs-separate comparisons at one churn
    rate face the same storm (victim draws consume one RNG step per
    event, keeping the choice sequence aligned across runs too)."""

    def __init__(self, cfg: FailureConfig, duration_s: float):
        self.cfg = cfg
        self.events: List[float] = []
        rng = np.random.default_rng(cfg.seed + FAILURE_SEED_SALT)
        if cfg.rate_per_min > 0:
            rate_s = cfg.rate_per_min / 60.0
            t = cfg.start_s
            while True:
                t += float(rng.exponential(1.0 / rate_s))
                if t >= duration_s:
                    break
                self.events.append(t)
        self._victim_rng = np.random.default_rng(
            cfg.seed + FAILURE_SEED_SALT + 1)
        self._cursor = 0

    def pop_due(self, now: float) -> List[float]:
        """Event times that have fired by ``now`` (consumed exactly once)."""
        out = []
        while self._cursor < len(self.events) \
                and self.events[self._cursor] <= now:
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def pick(self, candidates: Sequence[Tuple[str, int]]) -> Tuple[str, int]:
        """Uniform victim among the (kind, id) candidates. One RNG draw per
        call, even for a single candidate, so the draw sequence stays
        aligned across runs with different fleet shapes."""
        assert candidates, "pick() on an empty candidate list"
        ix = int(self._victim_rng.integers(len(candidates)))
        return candidates[ix]


# ------------------------------------------------- multi-tenant scenarios
# Workload-shape presets for the cluster layer (core/cluster.py): same
# generator, different envelope/burstiness/length mixes. Each models a
# tenant class a MaaS fleet must absorb (steady API traffic, a daily cycle,
# a flash crowd, agentic long-tail jobs, chatbot sessions with shared
# prompt prefixes).
SCENARIOS = ("steady", "diurnal", "spike", "heavy_tail", "session_heavy",
             "multi_tenant", "shared_prefix")

# multi_tenant default arrival mix: a few hot tenants, a long-ish tail —
# the regime adapter_placement policies must pack/replicate for.
DEFAULT_TENANT_WEIGHTS = (0.4, 0.3, 0.2, 0.1)


def scenario_config(name: str, duration_s: float = 600.0,
                    mean_rps: float = 5.3, seed: int = 0,
                    n_sessions: int = 0,
                    tenant_weights: Tuple[float, ...] = ()) -> TraceConfig:
    base = dict(duration_s=duration_s, mean_rps=mean_rps, seed=seed,
                n_sessions=n_sessions, tenant_weights=tenant_weights)
    if name == "steady":
        # near-Poisson arrivals, flat envelope: the autoscaler baseline
        return TraceConfig(burstiness=1.0, rate_amplitude=0.05, **base)
    if name == "diurnal":
        # one slow day/night cycle across the trace; moderate bursts
        return TraceConfig(burstiness=0.5, rate_amplitude=0.8,
                           rate_period_s=duration_s, **base)
    if name == "spike":
        # steady background + a 4x flash crowd over 15% of the trace
        return TraceConfig(burstiness=1.0, rate_amplitude=0.05,
                           spike_mult=4.0, **base)
    if name == "heavy_tail":
        # very bursty arrivals, fat prompt/output tails (agentic traffic)
        return TraceConfig(burstiness=0.2, rate_amplitude=0.3,
                           prompt_sigma=1.3, output_sigma=1.4,
                           output_max=2048, **base)
    if name == "session_heavy":
        # chatbot traffic: a small set of hot sessions keeps returning
        # with near-identical long prompts (shared conversation history),
        # the regime sticky routing + prefix caching targets. Low prompt
        # sigma keeps per-session prompts close in length, so a cached
        # prefix covers most of the next turn's prompt.
        base["n_sessions"] = n_sessions if n_sessions > 0 else 12
        return TraceConfig(burstiness=0.8, rate_amplitude=0.1,
                           prompt_sigma=0.35, **base)
    if name == "shared_prefix":
        # session_heavy traffic where sessions additionally share a few
        # long system prompts (per-tenant templates): the regime the
        # cross-session radix tree + gossip routing targets. Many more
        # sessions than session_heavy — single-session stickiness alone
        # cannot keep the fleet warm, shared prefixes can.
        base["n_sessions"] = n_sessions if n_sessions > 0 else 32
        return TraceConfig(burstiness=0.8, rate_amplitude=0.1,
                           prompt_sigma=0.35, shared_prefix_groups=4,
                           shared_prefix_tokens=384, **base)
    if name == "multi_tenant":
        # MaaS adapter tenancy: several tenants' traffic multiplexed over
        # one fleet, skewed toward a few hot adapters; moderate bursts so
        # placement (not raw capacity) dominates the outcome
        if not base["tenant_weights"]:
            base["tenant_weights"] = DEFAULT_TENANT_WEIGHTS
        return TraceConfig(burstiness=0.7, rate_amplitude=0.2, **base)
    raise ValueError(f"unknown scenario {name!r}; choose from {SCENARIOS}")


def generate_scenario(name: str, duration_s: float = 600.0,
                      mean_rps: float = 5.3, seed: int = 0,
                      n_sessions: int = 0,
                      tenant_weights: Tuple[float, ...] = ()
                      ) -> List[Request]:
    return generate(scenario_config(name, duration_s, mean_rps, seed,
                                    n_sessions=n_sessions,
                                    tenant_weights=tenant_weights))


def peak_rps(reqs: List[Request], window_s: float = 10.0) -> float:
    """Max windowed arrival rate — the load-shape metric the scenario
    tests assert on (spike peak >> steady peak at equal mean)."""
    if not reqs:
        return 0.0
    arr = sorted(r.arrival for r in reqs)
    best, lo = 0, 0
    for hi in range(len(arr)):
        while arr[hi] - arr[lo] > window_s:
            lo += 1
        best = max(best, hi - lo + 1)
    return best / window_s


def controlled_load(phases=((8, 60.0), (42, 60.0), (24, 60.0)),
                    prompt_len: int = 512, output_len: int = 400,
                    seed: int = 0) -> List[Request]:
    """The §8.5 controlled trace: light (bs=8) -> heavy (bs=42) -> medium
    (bs=24). Arrival rates chosen so steady-state decode bs ≈ target."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t, rid = 0.0, 0
    t_phase = 0.0
    for target_bs, dur in phases:
        # Little's law: bs = rate * decode_time_per_request
        # assume ~25ms/token -> request residency ≈ output_len * 0.025
        rate = target_bs / (output_len * 0.025)
        end = t_phase + dur
        while t < end:
            t += rng.exponential(1.0 / rate)
            if t >= end:
                break
            reqs.append(Request(rid=rid, arrival=t, prompt_len=prompt_len,
                                max_new_tokens=output_len))
            rid += 1
        t_phase = end
        t = max(t, t_phase)
    return reqs
