"""First-class control-plane API: policy interfaces + a string-keyed
registry.

Harli's contribution is a *composition* of interchangeable mechanisms —
routing, prefill placement, QoS-guaranteed scaling — and every future
scenario on the ROADMAP (heterogeneous fleets, multi-tenant finetune
queues, cross-instance cache-aware placement) is a new *policy* over the
same mechanism. Before this module, each choice was a string-enum
``if/elif`` chain inside ``router.py`` / ``cluster.py`` /
``autoscaler.py``; adding a policy meant editing three core modules. Now
the core modules own only mechanism (queues, hand-off, accounting,
cooldowns, decision logs) and decisions live in self-contained policy
classes registered by name:

    from repro_torch.core.api import RoutingPolicy, register_policy

    @register_policy("my_policy")
    class MyPolicy(RoutingPolicy):
        def pick(self, cand, req, router):
            return min(cand, key=lambda i: (i.load(), i.inst_id))

Nothing else changes: ``RouterConfig(policy="my_policy")`` now resolves
through the registry, every entry point (``ExperimentSpec``,
``examples/cluster_sim.py``, the benchmarks) accepts the new name, and
the router's dispatch path needs no edits. ``cache_aware`` routing
(core/policies/cache_aware.py) is the worked proof — see docs/api.md.

Three policy kinds:

  * ``routing``  — ``RoutingPolicy``: which decode instance gets a
    request. Owns its own state (RNG, round-robin cursor, sticky-session
    map, admission pins).
  * ``prefill``  — ``PrefillPlacement``: where prefill work runs
    (chained / pooled / chunked deployment modes). One object is shared
    by the router (placement of each request) and the cluster loop
    (tier scaling, timelines, result accounting).
  * ``scaling``  — ``ScalingPolicy``: pure decision functions for the
    autoscaler's control loops (decode fleet, pooled prefill tier,
    chunked budget). The ``Autoscaler`` keeps cooldown bookkeeping and
    the decision log; policies only decide.
  * ``adapter_placement`` — ``AdapterPlacement``: which decode instance
    serves an adapter-carrying request (multi-LoRA serving,
    core/adapters.py). Consulted by the router *instead of* the routing
    policy when the request carries an ``adapter_id`` and adapter
    serving is enabled.

``ExperimentSpec`` (core/experiment.py) is re-exported here lazily so
``from repro_torch.core.api import ExperimentSpec`` works without an import
cycle (experiment.py composes the modules that import this one).

The port's own copy of `repro/core/api.py` (plain Python and numpy; keep the
two in step), with its names, seeds and arithmetic. The registry is the
port's own: policies registered here never reach the reference's registry,
nor the reverse, and `_ensure_builtins` imports `repro_torch.core.policies`.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Tuple, Type

# Router dispatch sentinels (canonical home; core/router.py re-exports
# them for back compatibility).
PENDING = -2     # admitted; still in the prefill stage
REJECTED = -1

KINDS = ("routing", "prefill", "scaling", "migration", "adapter_placement")


def _check_kind(kind: str) -> None:
    """Unknown *kinds* are a programming error distinct from unknown
    names; fail loudly with the kind list (never another kind's names)."""
    if kind not in KINDS:
        raise ValueError(
            f"unknown policy kind {kind!r}; valid kinds: {', '.join(KINDS)}")


class PolicyNotFoundError(KeyError):
    """Unknown policy name. The message lists what IS registered *for the
    requested kind only* so a typo'd spec/CLI run fails with the fix in
    the error text (suggestions from other kinds would be noise)."""

    def __init__(self, kind: str, name: str, available: Tuple[str, ...]):
        self.kind = kind
        self.name = name
        self.available = available
        super().__init__(
            f"unknown {kind} policy {name!r}; registered {kind} policies: "
            f"{', '.join(available) or '(none)'}")

    def __str__(self) -> str:  # KeyError str() adds quotes; keep it clean
        return self.args[0]


class PolicyRegistry:
    """String-keyed registry, one namespace per policy kind."""

    def __init__(self):
        self._by_kind: Dict[str, Dict[str, type]] = {k: {} for k in KINDS}

    def register(self, kind: str, name: str, cls: type) -> None:
        _check_kind(kind)
        existing = self._by_kind[kind].get(name)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"{kind} policy {name!r} already registered by "
                f"{existing.__module__}.{existing.__qualname__}")
        self._by_kind[kind][name] = cls

    def resolve(self, kind: str, name: str) -> type:
        _check_kind(kind)
        self._ensure_builtins()
        try:
            return self._by_kind[kind][name]
        except KeyError:
            # suggestion list scoped to the requested kind only
            raise PolicyNotFoundError(kind, name, self.names(kind)) from None

    def names(self, kind: str) -> Tuple[str, ...]:
        _check_kind(kind)
        self._ensure_builtins()
        return tuple(sorted(self._by_kind[kind]))

    @staticmethod
    def _ensure_builtins() -> None:
        # the built-in policies live in repro_torch.core.policies and
        # register on import; resolve/names pull them in lazily so a bare
        # ``ClusterRouter(...)`` works without anyone importing the package
        # (the port's own package: the reference's would fill the
        # reference's registry and leave this one empty)
        import repro_torch.core.policies  # noqa: F401  (registration)


REGISTRY = PolicyRegistry()


def _infer_kind(cls: type) -> str:
    if issubclass(cls, RoutingPolicy):
        return "routing"
    if issubclass(cls, PrefillPlacement):
        return "prefill"
    if issubclass(cls, ScalingPolicy):
        return "scaling"
    if issubclass(cls, MigrationPolicy):
        return "migration"
    if issubclass(cls, AdapterPlacement):
        return "adapter_placement"
    raise TypeError(
        f"{cls.__qualname__} subclasses none of RoutingPolicy / "
        f"PrefillPlacement / ScalingPolicy / MigrationPolicy / "
        f"AdapterPlacement; pass kind= explicitly")


def register_policy(name: str, *, kind: Optional[str] = None):
    """Class decorator: ``@register_policy("session_affinity")``. The
    policy kind is inferred from the base class (or given explicitly);
    the class gains a ``name`` attribute and becomes resolvable through
    ``RouterConfig.policy`` / ``ClusterConfig.prefill_mode`` /
    ``AutoscalerConfig.*_policy`` and ``ExperimentSpec``."""
    def deco(cls):
        REGISTRY.register(kind or _infer_kind(cls), name, cls)
        cls.name = name
        return cls
    return deco


def resolve_policy(kind: str, name: str) -> type:
    """Public lookup: registry class for ``name``, raising
    ``PolicyNotFoundError`` (with the registered names in the message)
    when unknown."""
    return REGISTRY.resolve(kind, name)


def available_policies(kind: str) -> Tuple[str, ...]:
    return REGISTRY.names(kind)


# --------------------------------------------------------------- routing --
class RoutingPolicy(abc.ABC):
    """Decode-stage placement decision. Instantiated once per
    ``ClusterRouter`` with the router's config; any decision state (RNG,
    cursors, sticky maps, pins) belongs to the policy object, so the
    router stays pure mechanism.

    ``router`` in the hooks is the owning ``ClusterRouter`` — policies
    may read fleet state (``router.instances``, ``router.predictor``)
    but must not mutate it."""

    name: str = ""
    # declare True when the policy keys on Request.session_id (sticky /
    # cache-style policies): entry points that generate the trace consult
    # this to default sessions on, instead of hardcoding policy names
    needs_sessions: bool = False

    def __init__(self, cfg):
        self.cfg = cfg               # RouterConfig

    @abc.abstractmethod
    def pick(self, cand: List, req, router):
        """Choose one instance from the non-empty candidate list for
        ``req``. Must be deterministic given the policy's own state."""

    def pin_for_prefill(self, cand: List, req, router):
        """Pooled-mode hook, called at admission (before prefill runs):
        return the decode instance this request should be bound to so
        its prefix-cache credit can shorten the prefill, or None for
        hand-off-time placement. A returned pin must be remembered and
        surrendered by ``claim_pin``."""
        return None

    def claim_pin(self, req) -> Optional[int]:
        """Pooled-mode hook, called once at hand-off: pop and return the
        instance id pinned for ``req`` at admission (None if unpinned).
        The router honors the pin while the instance can still serve and
        un-credits the prefix hit when the pin broke mid-prefill."""
        return None


# --------------------------------------------------------------- prefill --
class PrefillPlacement(abc.ABC):
    """Where prefill work runs — the deployment-mode axis
    (docs/cluster.md "Three deployment modes"). One placement object is
    shared by the ``ClusterRouter`` (per-request placement, pump) and
    ``ClusterSim`` (tier scaling, timelines, result fields); standalone
    routers construct one directly from the back-compat kwargs.

    Router-side hooks receive the router; cluster-side hooks receive the
    ``ClusterSim`` (``cs``). Every hook except ``place`` has a no-op
    default, so a minimal placement only decides where a request goes."""

    name: str = ""

    # ---- router side ----
    def on_add_instance(self, inst, now: float, router) -> None:
        """A decode instance joined the fleet."""

    def on_retire_instance(self, inst_id: int, router) -> None:
        """A drained decode instance left the fleet."""

    def saturated(self, cand: List, router) -> bool:
        """Extra admission backpressure beyond decode load (e.g. the
        pooled tier's queue depth). True => reject the request."""
        return False

    @abc.abstractmethod
    def place(self, req, now: float, cand: List, router) -> int:
        """Route an admitted request into this deployment mode. Returns
        the decode instance id, or PENDING when the request entered a
        prefill stage and will reach decode later via ``pump``."""

    def pump(self, until: float, router) -> int:
        """Advance any prefill stage to ``until``, handing completions
        to ``router.dispatch_decode``. Returns requests handed off."""
        return 0

    # ---- cluster side ----
    @classmethod
    def build(cls, cs) -> "PrefillPlacement":
        """Construct for a ``ClusterSim`` (cs exposes cfg_inf, sim,
        cluster, router_cfg)."""
        return cls()

    def spawn_kwargs(self, cs, serves_inference: bool) -> Dict:
        """Extra DecodeInstanceSim kwargs for a (re)spawned instance."""
        return {}

    def on_scale_up(self, cs, t: float) -> None:
        """A decode instance was just added by the autoscaler —
        coordinate the prefill tier (e.g. top the pool up to its floor)."""

    def control(self, cs, t: float, viol_frac: float) -> None:
        """The autoscaler's prefill-loop control slot for this mode:
        evaluate the mode's ScalingPolicy and apply its decision."""

    def retire(self, cs, t: float) -> None:
        """End-of-epoch lifecycle (e.g. retire drained pool workers)."""

    def record_timeline(self, cs, t: float) -> None:
        """Per-epoch timeline point for this tier."""

    def finalize(self, cs, res) -> None:
        """Fill mode-specific ``ClusterResult`` fields."""


# --------------------------------------------------------------- scaling --
class ScalingPolicy(abc.ABC):
    """One autoscaler control loop's decision function. Pure policy: the
    ``Autoscaler`` (core/autoscaler.py) applies cooldowns, records the
    decision stream, and the cluster loop applies actions — a policy
    only maps signals to a ``ScaleDecision``.

    ``signals`` is a plain dict; each loop documents its keys (see
    core/policies/scaling.py for the built-in three)."""

    name: str = ""

    @abc.abstractmethod
    def decide(self, t: float, cfg, signals: Dict):
        """Return a ScaleDecision for control tick ``t`` given
        ``AutoscalerConfig`` ``cfg`` and this loop's signals."""


# ------------------------------------------------------------- migration --
class MigrationPolicy(abc.ABC):
    """Live-KV-migration destination choice (survivability layer,
    core/cluster.py ``KVMigrationConfig``). When an instance receives a
    spot-style preemption warning, ``ClusterSim`` streams each victim
    request's KV to a peer over the interconnect; this policy picks the
    peer. Pure decision: the cluster loop owns the transfer timeline,
    the deadline race and the re-prefill fallback.

    Must be deterministic — migration happens on the seeded failure
    path, and a nondeterministic pick would break the bit-identity
    guarantees the churn tests pin."""

    name: str = ""

    @abc.abstractmethod
    def pick_dest(self, req, cand: List, router):
        """Choose the destination instance for ``req``'s KV from the
        non-empty candidate list (serving peers, victim excluded)."""


# ---------------------------------------------------- adapter placement --
class AdapterPlacement(abc.ABC):
    """Adapter-aware decode placement (multi-LoRA serving,
    core/adapters.py). When ``ClusterConfig.adapters`` is set, the router
    consults this policy *instead of* the routing policy for every
    request carrying an ``adapter_id`` — the trade-off it owns is
    locality (an instance already holding the adapter skips the
    hot-load/swap) versus load balance. Requests without an adapter, and
    all requests when adapter serving is off, still go through the
    ``routing`` policy unchanged.

    Instances expose ``inst.adapters`` (an ``AdapterPool`` or None) for
    residency queries; like routing policies, placements may read router
    and fleet state but must not mutate it, and must be deterministic."""

    name: str = ""

    def __init__(self, cfg):
        self.cfg = cfg               # RouterConfig

    @abc.abstractmethod
    def pick(self, cand: List, req, router):
        """Choose one instance from the non-empty candidate list for the
        adapter-carrying ``req`` (``req.adapter_id >= 0``,
        ``req.adapter_version`` already stamped from the registry)."""


def __getattr__(name: str):
    # lazy re-export: experiment.py imports cluster/router/trace, which
    # import this module — a module-level import here would be a cycle
    if name in ("ExperimentSpec", "SpecError"):
        from repro_torch.core import experiment
        return getattr(experiment, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
