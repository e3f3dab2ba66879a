"""Unified experiment specification for the cluster control plane.

Before this module, every entry point (examples/cluster_sim.py,
benchmarks/*, tests) hand-wired four overlapping config dataclasses
(SimConfig, TraceConfig, RouterConfig, ClusterConfig) plus autoscaler
knobs, each with its own seed conventions — and contradictory
combinations (a chunk budget in pooled mode, pool workers in chained
mode) were silently ignored. ``ExperimentSpec`` is the one object that
composes all of it, with:

  * ``validate()``   — registry-checked policy names and *loud* rejection
    of contradictory mode/knob combinations, with the fix in the message;
  * ``to_json`` / ``from_json`` — loss-free round trip, so an experiment
    is a reviewable artifact (``examples/specs/*.json``) and
    ``cluster_sim.py --spec file.json`` reruns it exactly; documents are
    versioned (``schema_version``, see ``SCHEMA_VERSION``) — v1 specs
    upgrade automatically through ``upgrade_v1``, unknown versions fail
    loudly listing the supported ones;
  * ``run()``        — the single entry point: generate the trace
    (seeded ``seed + 1``, the convention every example already used) and
    run the cluster simulation;
  * ``instance_overrides`` (on ``ClusterConfig``) — the heterogeneous-
    fleet hook, validated here: entry *i* replaces SimConfig fields for
    the *i*-th spawned instance (mixed tp, mixed slot budgets, ...).

Determinism: a spec fully determines the experiment —
``from_json(spec.to_json()).run()`` is seed-identical to ``spec.run()``
(tested), and the legacy string-kwarg construction path produces
bit-identical results (pinned per prefill mode in tests/test_api.py).

The port's own copy of `repro/core/experiment.py` (keep the two in step):
the same JSON schema (v2 written, v1 upgraded), validation and error texts,
so it loads the reference's saved specs unchanged. `run` takes the
instances' `InstanceSpec` (by default one H100, `H100_CONSTANTS`) and
passes it to `simulate_cluster`; a spec's `sim.tp` counts that chip.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core import gossip as gossip_mod
from repro_torch.core.adapters import TenantConfig
from repro_torch.core.cluster import (ClusterConfig, ClusterResult,
                                      DegradationConfig, simulate_cluster)
from repro_torch.core.costmodel import InstanceSpec
from repro_torch.core.prefill_pool import PrefillPoolConfig
from repro_torch.core.simulator import ChunkedPrefillConfig, SimConfig
from repro_torch.serving.request import Request
from repro_torch.serving.trace import SCENARIOS, TraceConfig, generate, \
    generate_scenario

SIM_MODES = ("harli", "static", "separate")
# JSON schema versioning: v1 is the first schema (no multi-LoRA blocks);
# v2 added the top-level ``tenants`` and ``cluster.adapters`` blocks.
# ``from_dict`` accepts both — v1 documents are upgraded in exactly one
# place (``upgrade_v1``) — and rejects anything else loudly.
SCHEMA_VERSION = 2
SUPPORTED_SCHEMA_VERSIONS = (1, 2)
# per-instance override keys: any SimConfig field except the experiment
# identity ones (mode is fleet-wide; per-instance seeds derive from it)
OVERRIDABLE_SIM_FIELDS = tuple(
    f.name for f in dataclasses.fields(SimConfig)
    if f.name not in ("mode", "seed"))


class SpecError(ValueError):
    """An ExperimentSpec that cannot mean what it says — unknown names or
    contradictory knob combinations. The message states the fix."""


def _from_dict(cls, data):
    """Reconstruct a (possibly nested) config dataclass from plain dicts,
    rejecting unknown keys with the valid field names in the message."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise SpecError(f"{cls.__name__} must be an object, "
                        f"got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise SpecError(
            f"unknown {cls.__name__} field(s) {', '.join(unknown)}; "
            f"valid fields: {', '.join(sorted(fields))}")
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, value in data.items():
        t = hints[name]
        origin = typing.get_origin(t)
        if origin is Union:                      # Optional[X]
            args = [a for a in typing.get_args(t) if a is not type(None)]
            t, origin = args[0], typing.get_origin(args[0])
        if dataclasses.is_dataclass(t):
            value = _from_dict(t, value)
        elif origin is tuple and value is not None:
            args = typing.get_args(t)
            el = args[0] if args else None
            if el is not None and dataclasses.is_dataclass(el):
                value = tuple(_from_dict(el, v) for v in value)
            else:
                value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def upgrade_v1(data: Dict) -> Dict:
    """THE v1 -> v2 schema upgrade — the single place version migration
    happens (``from_dict`` routes every v1 document here).

    v2 added the multi-LoRA serving blocks (top-level ``tenants``,
    ``cluster.adapters``) and later the cache-gossip plane
    (``cluster.gossip``). A v1 document (``schema_version`` absent or 1)
    predates all of them, so the upgrade is: reject documents that
    smuggle v2 blocks without declaring the version, then fill the v2
    defaults (no tenants, no adapter serving, no gossip) — semantics
    unchanged by construction."""
    v2_only = [k for k in ("tenants",) if k in data]
    cl = data.get("cluster")
    if isinstance(cl, dict):
        for blk in ("adapters", "gossip"):
            if cl.get(blk) is not None:
                v2_only.append(f"cluster.{blk}")
    if v2_only:
        raise SpecError(
            f"v1 spec uses v2-only block(s) {', '.join(v2_only)} — "
            'declare "schema_version": 2')
    out = dict(data)
    out.pop("schema_version", None)
    return out


@dataclasses.dataclass
class ExperimentSpec:
    """One cluster experiment, fully specified and JSON-serializable.

    ``seed`` is the experiment's base seed: the trace draws at
    ``seed + 1`` (the convention examples/cluster_sim.py always used);
    ``sim.seed`` / ``cluster.router.seed`` keep their own threading
    (router derives from sim unless explicit). ``trace`` overrides the
    scenario preset entirely when given."""

    schema_version: int = SCHEMA_VERSION
    name: str = "experiment"
    inf_model: str = "llama3-8b"         # serving model config name
    ft_model: str = "llama3-8b"          # finetune model config name
    scenario: str = "spike"              # trace preset (serving/trace.py)
    duration_s: float = 60.0
    mean_rps: float = 10.0
    n_sessions: int = 0                  # sticky sessions in the trace
    seed: int = 0
    trace: Optional[TraceConfig] = None  # full trace override
    # v2: per-tenant traffic mix + SLO overrides; entry i is adapter_id i.
    # Tenants alone give per-tenant accounting (base-model serving);
    # pairing them with cluster.adapters turns on multi-LoRA serving.
    tenants: Tuple[TenantConfig, ...] = ()
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)

    # ------------------------------------------------------- validation --
    def validate(self) -> "ExperimentSpec":
        """Raise ``SpecError`` on unknown names or contradictory knob
        combinations (the centralized check examples/cluster_sim.py and
        ``run()`` both go through). Returns self for chaining."""
        for role, model in (("inf_model", self.inf_model),
                            ("ft_model", self.ft_model)):
            try:
                get_config(model)
            except Exception as e:
                raise SpecError(f"{role}={model!r}: {e}") from None
        if self.trace is None and self.scenario not in SCENARIOS:
            raise SpecError(f"unknown scenario {self.scenario!r}; choose "
                            f"from {', '.join(SCENARIOS)}")
        if self.trace is not None:
            # with a full trace override the top-level trace-shape fields
            # must mirror it — they feed reports and duration scaling, and
            # a silent disagreement is exactly the ignored-knob class this
            # method exists to reject
            for fld, tval in (("duration_s", self.trace.duration_s),
                              ("mean_rps", self.trace.mean_rps),
                              ("n_sessions", self.trace.n_sessions)):
                if getattr(self, fld) != tval:
                    raise SpecError(
                        f"trace override is set but {fld}="
                        f"{getattr(self, fld)} disagrees with trace.{fld}"
                        f"={tval} — set both to the same value (the trace"
                        " is what actually runs)")
        if self.duration_s <= 0 or self.mean_rps <= 0:
            raise SpecError("duration_s and mean_rps must be positive")
        if self.n_sessions < 0:
            raise SpecError("n_sessions must be >= 0")
        if self.sim.mode not in SIM_MODES:
            raise SpecError(f"unknown sim.mode {self.sim.mode!r}; choose "
                            f"from {', '.join(SIM_MODES)}")
        cl = self.cluster
        if cl.n_initial < 1:
            raise SpecError("cluster.n_initial must be >= 1")
        # registry-checked names: routing policy, prefill placement and
        # all three scaling-loop policies must resolve
        try:
            api.resolve_policy("routing", cl.router.policy)
            mode = cl.resolved_mode()
            for loop in ("decode_policy", "prefill_policy", "chunk_policy"):
                api.resolve_policy("scaling", getattr(cl.autoscaler, loop))
        except api.PolicyNotFoundError as e:
            raise SpecError(str(e)) from None
        # contradictory mode/knob combinations: a knob configured away
        # from its default for a mode that cannot read it is a silent
        # no-op — reject it loudly instead
        if mode == "pooled" and cl.prefill is None:
            raise SpecError(
                "prefill_mode 'pooled' needs a prefill pool config "
                "(cluster.prefill / --prefill-workers >= 1)")
        if mode != "pooled" and cl.prefill is not None \
                and cl.prefill != PrefillPoolConfig():
            raise SpecError(
                f"prefill pool configured ({cl.prefill}) but prefill_mode "
                f"is {mode!r} — the pool only exists in pooled mode; drop "
                "the pool config (CLI: --prefill-workers only applies to "
                "--prefill-mode pooled)")
        if mode != "chunked" and cl.chunked != ChunkedPrefillConfig():
            raise SpecError(
                f"chunked-prefill knobs configured ({cl.chunked}) but "
                f"prefill_mode is {mode!r} — they only apply in chunked "
                "mode; drop them (CLI: --chunk-budget / --fuse-quantum "
                "only apply to --prefill-mode chunked)")
        if cl.prefix_cache is not None and self.n_sessions == 0 \
                and self.scenario not in ("session_heavy", "shared_prefix"):
            # session_heavy/shared_prefix default their own sessions on;
            # any other sessionless trace would make the cache pure cost
            # — it reserves real allocator capacity (shrinking the
            # finetune window and KV budget) and can never hit
            raise SpecError(
                "prefix_cache configured but the trace is sessionless "
                "(n_sessions=0) — the prefix cache would reserve "
                "allocator capacity and never hit; set n_sessions > 0 "
                "or drop prefix_cache")
        if cl.gossip is not None:
            g = cl.gossip
            if cl.prefix_cache is None:
                raise SpecError(
                    "cluster.gossip configured but prefix_cache is null — "
                    "the gossip plane publishes prefix-cache digests; "
                    "configure cluster.prefix_cache or drop gossip "
                    "(gossip: null)")
            if g.period_s <= 0:
                raise SpecError("cluster.gossip.period_s must be > 0")
            if g.staleness_bound_s < g.period_s:
                raise SpecError(
                    "cluster.gossip.staleness_bound_s must be >= period_s "
                    "— a bound under the publish period would discard "
                    "every digest before its refresh arrives (got "
                    f"period={g.period_s}, bound={g.staleness_bound_s})")
            if g.top_k < 1:
                raise SpecError("cluster.gossip.top_k must be >= 1")
            if g.effective_top_k() < 1:
                raise SpecError(
                    f"cluster.gossip.max_bytes={g.max_bytes} cannot fit "
                    "even one digest entry (header "
                    f"{gossip_mod.DIGEST_HEADER_BYTES} + entry "
                    f"{gossip_mod.DIGEST_ENTRY_BYTES} bytes); raise "
                    "max_bytes")
        if cl.router.policy == "cache_aware_gossip" and cl.gossip is None:
            raise SpecError(
                "router.policy 'cache_aware_gossip' needs the gossip "
                "plane — configure cluster.gossip (it never falls back "
                "to synchronous cache peeks)")
        if cl.failures is not None:
            f = cl.failures
            if f.rate_per_min < 0 or f.warning_s < 0 or f.start_s < 0 \
                    or f.checkpoint_interval_s < 0:
                raise SpecError(
                    "cluster.failures knobs (rate_per_min, warning_s, "
                    "start_s, checkpoint_interval_s) must all be >= 0")
            if f.rate_per_min == 0 and f.warning_s == 0 \
                    and f.checkpoint_interval_s == 0:
                raise SpecError(
                    "cluster.failures is configured but fully inert "
                    "(rate 0, no warning, no checkpointing) — drop it "
                    "(failures: null) to state the fleet is stable")
        if cl.migration is not None:
            m = cl.migration
            if cl.failures is None:
                raise SpecError(
                    "cluster.migration is configured but failures is null "
                    "— live KV migration only fires on preemption "
                    "warnings; configure cluster.failures (CLI: "
                    "--migration-bw requires --churn-rate > 0)")
            if cl.failures.warning_s <= 0:
                raise SpecError(
                    "cluster.migration is configured but failures."
                    "warning_s is 0 — hard kills leave no window to "
                    "stream KV; set warning_s > 0 (CLI: --churn-warning)")
            if m.bw_gbps <= 0:
                raise SpecError(
                    "cluster.migration.bw_gbps must be > 0 — a zero-"
                    "bandwidth link can never move KV; drop the config "
                    "(migration: null) to state re-prefill-only intent")
            if m.setup_s < 0:
                raise SpecError("cluster.migration.setup_s must be >= 0")
            try:
                api.resolve_policy("migration", m.policy)
            except api.PolicyNotFoundError as e:
                raise SpecError(str(e)) from None
        if cl.degradation is not None:
            g = cl.degradation
            if not (0.0 <= g.resume_viol_frac <= g.breaker_viol_frac
                    <= g.shed_viol_frac <= 1.0):
                raise SpecError(
                    "cluster.degradation thresholds must satisfy 0 <= "
                    "resume_viol_frac <= breaker_viol_frac <= "
                    "shed_viol_frac <= 1 — the ladder escalates through "
                    f"them in order (got resume={g.resume_viol_frac}, "
                    f"breaker={g.breaker_viol_frac}, "
                    f"shed={g.shed_viol_frac})")
            if g.backoff_base_s <= 0 or g.backoff_mult < 1.0 \
                    or not (0.0 <= g.backoff_jitter < 1.0) \
                    or g.max_retries < 0:
                raise SpecError(
                    "cluster.degradation backoff knobs out of range: "
                    "backoff_base_s > 0, backoff_mult >= 1, 0 <= "
                    "backoff_jitter < 1, max_retries >= 0")
            if not g.shed:
                base = DegradationConfig(shed=False)
                tuned = [k for k in ("shed_viol_frac", "backoff_base_s",
                                     "backoff_mult", "backoff_jitter",
                                     "max_retries", "seed")
                         if getattr(g, k) != getattr(base, k)]
                if tuned:
                    raise SpecError(
                        f"cluster.degradation.shed is false but shedding "
                        f"knob(s) {', '.join(tuned)} are configured — "
                        "they only apply when shedding is enabled; drop "
                        "them or set shed: true (CLI: --shed-* flags "
                        "require the ladder with shedding on)")
        if self.schema_version != SCHEMA_VERSION:
            raise SpecError(
                f"schema_version must be {SCHEMA_VERSION} on a parsed "
                "spec — from_json/from_dict auto-upgrade v1 documents; "
                "don't set the field by hand")
        for i, tn in enumerate(self.tenants):
            if tn.weight <= 0:
                raise SpecError(f"tenants[{i}].weight must be > 0 "
                                f"(got {tn.weight})")
            for fld in ("ttft_slo_s", "tpot_slo_s"):
                v = getattr(tn, fld)
                if v is not None and v <= 0:
                    raise SpecError(
                        f"tenants[{i}].{fld} must be > 0 or null "
                        "(null inherits the fleet SLO)")
        if self.tenants and self.trace is not None \
                and tuple(self.trace.tenant_weights) \
                != tuple(t.weight for t in self.tenants):
            raise SpecError(
                "tenants block disagrees with trace.tenant_weights="
                f"{self.trace.tenant_weights} — with a full trace "
                "override, trace.tenant_weights must mirror the tenant "
                "weights (the trace is what actually runs)")
        if cl.adapters is not None:
            a = cl.adapters
            if not self.tenants and not (
                    self.trace is not None and self.trace.tenant_weights):
                raise SpecError(
                    "cluster.adapters configured but no tenant traffic — "
                    "no request would ever carry an adapter_id; add a "
                    "tenants block (or trace.tenant_weights) or drop "
                    "adapters (adapters: null)")
            if a.rank < 1:
                raise SpecError("cluster.adapters.rank must be >= 1")
            if a.publish_every_iters <= 0:
                raise SpecError(
                    "cluster.adapters.publish_every_iters must be > 0 — "
                    "it is the finetune-iterations-per-version cadence")
            if a.max_loaded < 0:
                raise SpecError("cluster.adapters.max_loaded must be >= 0 "
                                "(0 = bounded only by allocator capacity)")
            try:
                api.resolve_policy("adapter_placement", a.policy)
            except api.PolicyNotFoundError as e:
                raise SpecError(str(e)) from None
        for i, ov in enumerate(cl.instance_overrides):
            if not isinstance(ov, dict):
                raise SpecError(f"instance_overrides[{i}] must be an "
                                "object of SimConfig fields")
            bad = sorted(set(ov) - set(OVERRIDABLE_SIM_FIELDS))
            if bad:
                raise SpecError(
                    f"instance_overrides[{i}] has non-overridable "
                    f"field(s) {', '.join(bad)}; overridable: "
                    f"{', '.join(OVERRIDABLE_SIM_FIELDS)}")
        return self

    # ------------------------------------------------------------- JSON --
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        # normalize: a *default* pool config outside pooled mode is just
        # the dataclass default riding along — write null so the JSON
        # artifact states only what the experiment reads
        mode = self.cluster.prefill_mode
        if mode is None:
            mode = "pooled" if self.cluster.prefill is not None \
                else "chained"
        if mode != "pooled" and self.cluster.prefill == PrefillPoolConfig():
            d["cluster"]["prefill"] = None
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, data: Dict) -> "ExperimentSpec":
        if not isinstance(data, dict):
            raise SpecError("ExperimentSpec must be an object, "
                            f"got {type(data).__name__}")
        version = data.get("schema_version", 1)
        if version not in SUPPORTED_SCHEMA_VERSIONS:
            raise SpecError(
                f"unsupported schema_version {version!r}; supported "
                "versions: 1 (auto-upgraded), 2 (current)")
        if version == 1:
            data = upgrade_v1(data)
        return _from_dict(cls, data)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"spec is not valid JSON: {e}") from None
        return cls.from_dict(data)

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # -------------------------------------------------------------- run --
    def with_mode(self, sim_mode: str) -> "ExperimentSpec":
        """Copy of this spec with ``sim.mode`` replaced (harli-vs-separate
        comparisons run the same spec under both)."""
        return dataclasses.replace(
            self, sim=dataclasses.replace(self.sim, mode=sim_mode))

    def requests(self) -> List[Request]:
        """The (seeded, deterministic) trace this spec describes.
        When tenants are declared, their weights drive the per-request
        adapter_id draw and their SLO overrides are stamped onto each
        request (null inherits the fleet-wide router SLO)."""
        if self.trace is not None:
            reqs = generate(self.trace)
        else:
            reqs = generate_scenario(
                self.scenario, self.duration_s, self.mean_rps,
                seed=self.seed + 1, n_sessions=self.n_sessions,
                tenant_weights=tuple(t.weight for t in self.tenants))
        if self.tenants:
            for r in reqs:
                if 0 <= r.adapter_id < len(self.tenants):
                    tn = self.tenants[r.adapter_id]
                    r.ttft_slo_s = tn.ttft_slo_s
                    r.tpot_slo_s = tn.tpot_slo_s
        return reqs

    def run(self, duration: Optional[float] = None,
            spec: InstanceSpec = InstanceSpec()) -> ClusterResult:
        """Validate, generate the trace, run the cluster experiment on
        instances of `spec`. Deterministic: same spec (same JSON) and
        instance -> same ClusterResult."""
        self.validate()
        cfg_inf = get_config(self.inf_model)
        cfg_ft = get_config(self.ft_model)
        return simulate_cluster(cfg_inf, cfg_ft, self.requests(),
                                self.sim, self.cluster, duration, spec)
