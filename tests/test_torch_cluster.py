"""The port's cluster simulator (`core/cluster.py::simulate_cluster`, with
the router, the autoscaler, the prefill pool, the gossip plane and the
seven policy modules under it) against the reference's.

* On the reference's instance (TPU v5e, tp from `SimConfig`, its cost
  constants; `test_torch_costmodel._tpu_instance` builds it in the port's
  types), llama3-8b serving and finetuning, the same seeded traces: every
  field of `ClusterResult` equals the reference's (`_state`, as
  `tests/test_torch_simulator.py` compares `SimResult`: the statistics
  with their per-tenant entries, the scale decisions, the fleet, prefill
  and chunk-budget timelines, the TPOT samples, the failure, migration,
  ladder, prefix-cache, gossip and adapter counters) for
  - the three prefill modes (chained, pooled, chunked), in harli and in
    separate mode, on a spike;
  - each of the seven routing policies once, on a session-heavy trace
    with prefix caches (a shared-prefix one for `cache_aware_gossip`, with
    the gossip plane);
  - failures with preemption warnings, checkpoints, live KV migration and
    the degradation ladder;
  - four tenants with multi-LoRA adapter serving;
  - a heterogeneous fleet (`instance_overrides`: one instance at tp 4).
  Each case asserts that its mechanism fired in the run (scale actions;
  prefix hits for the cache-keyed policies; gossip digests; kills,
  warnings, checkpoints, migrations and a ladder step; adapter loads;
  `test_spawned_instances_take_their_overridden_tp` for the tp 4
  instance). Its trace is sized to the least that makes the mechanism
  fire.
* On the port's own instance, one H100 (tp 1) with the committed cost
  constants, the reference's mode-independent properties
  (`tests/test_cluster.py`): conservation (`offered == routed +
  rejected`; the router's own `check_conservation` runs in every epoch),
  goodput <= throughput, the fleet never under `min_decode`, the same seed
  reproducing the identical result and another seed a different one.

The file takes ~40 s alone on an idle machine.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import adapters as JA  # noqa: E402
from repro.core import cluster as JC  # noqa: E402
from repro.core import gossip as JG  # noqa: E402
from repro.core import prefill_pool as JP  # noqa: E402
from repro.core import prefix_cache as JPC  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.serving import trace as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import adapters as TA  # noqa: E402
from repro_torch.core import cluster as TC  # noqa: E402
from repro_torch.core import gossip as TG  # noqa: E402
from repro_torch.core import prefill_pool as TP  # noqa: E402
from repro_torch.core import prefix_cache as TPC  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.costmodel import InstanceSpec  # noqa: E402
from repro_torch.serving import trace as TT  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_costmodel import _tpu_instance  # noqa: E402
from test_torch_simulator import _state  # noqa: E402

REF = SimpleNamespace(configs=jconfigs, adapters=JA, cluster=JC, gossip=JG,
                      pool=JP, cache=JPC, router=JR, sim=JS, trace=JT)
PORT = SimpleNamespace(configs=tconfigs, adapters=TA, cluster=TC, gossip=TG,
                       pool=TP, cache=TPC, router=TR, sim=TS, trace=TT)


@dataclasses.dataclass(frozen=True)
class Case:
    scenario: str
    duration: float
    rps: float
    mode: str = "harli"
    sessions: int = 0
    tenants: int = 0
    n_initial: int = 2
    prefill_mode: str = "pooled"
    policy: str = "least_loaded"
    cache: bool = False
    gossip: bool = False
    churn: bool = False
    adapters: bool = False
    overrides: tuple = ()


def _acts(res):
    return [d for d in res.decisions if d.action != "none"]


# name -> (case, what shows its mechanism fired)
CASES = {
    **{f"{pm}-{mode}": (Case("spike", 10.0, 12.0, mode=mode,
                             prefill_mode=pm),
                        lambda r: len(_acts(r)) > 0)
       for pm in ("chained", "pooled", "chunked")
       for mode in ("harli", "separate")},
    **{f"policy-{p}": (Case("session_heavy", 20.0, 8.0, sessions=16,
                            policy=p, cache=True),
                       lambda r: len(_acts(r)) > 0)
       for p in ("least_loaded", "round_robin", "random",
                 "predicted_latency")},
    **{f"policy-{p}": (Case("session_heavy", 20.0, 8.0, sessions=16,
                            policy=p, cache=True),
                       lambda r: r.prefix_hits > 0)
       for p in ("session_affinity", "cache_aware")},
    "policy-cache_aware_gossip": (
        Case("shared_prefix", 20.0, 8.0, sessions=16,
             policy="cache_aware_gossip", cache=True, gossip=True),
        lambda r: r.gossip_published > 0 and r.prefix_hits > 0),
    "churn-migration-ladder": (
        Case("spike", 30.0, 14.0, n_initial=3, churn=True),
        lambda r: r.failures > 0 and r.preemptions > 0
        and r.migrated_requests > 0 and r.checkpoint_commits > 0
        and r.ladder_peak > 0),
    "adapters-tenants": (
        Case("steady", 20.0, 6.0, tenants=4, adapters=True),
        lambda r: r.adapter_loads > 0 and len(r.stats.tenants) == 4),
    "hetero-tp4": (
        Case("steady", 20.0, 8.0, n_initial=3, prefill_mode="chained",
             overrides=({"tp": 4}, {})),
        lambda r: r.stats.completed > 0),
}


def _tenant_weights(n):
    w = [1.0 / (i + 1) for i in range(n)]
    return tuple(x / sum(w) for x in w)


def _cluster_config(m, c: Case):
    failures = migration = degradation = None
    if c.churn:
        failures = m.trace.FailureConfig(
            rate_per_min=6.0, warning_s=5.0, checkpoint_interval_s=5.0,
            seed=7)
        migration = m.cluster.KVMigrationConfig()
        degradation = m.cluster.DegradationConfig()
    return m.cluster.ClusterConfig(
        n_initial=c.n_initial, prefill_mode=c.prefill_mode,
        prefill=m.pool.PrefillPoolConfig()
        if c.prefill_mode == "pooled" else None,
        prefix_cache=m.cache.PrefixCacheConfig() if c.cache else None,
        gossip=m.gossip.GossipConfig() if c.gossip else None,
        router=m.router.RouterConfig(policy=c.policy),
        failures=failures, migration=migration, degradation=degradation,
        adapters=m.adapters.AdapterServingConfig() if c.adapters else None,
        instance_overrides=c.overrides)


def _run(m, c: Case, seed: int = 2, **kw):
    cfg = m.configs.get_config("llama3-8b")
    reqs = m.trace.generate_scenario(
        c.scenario, c.duration, c.rps, seed=seed - 1,
        n_sessions=c.sessions, tenant_weights=_tenant_weights(c.tenants))
    return m.cluster.simulate_cluster(
        cfg, cfg, reqs, m.sim.SimConfig(mode=c.mode, seed=seed),
        _cluster_config(m, c), **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_matches_reference(name):
    case, fired = CASES[name]
    ref = _run(REF, case)
    port = _run(PORT, case, spec=_tpu_instance())
    assert fired(ref), name
    assert _state(port) == _state(ref)


def test_spawned_instances_take_their_overridden_tp():
    """The instance seam: each spawned instance is priced on the cluster's
    chip at its own `SimConfig`'s tp, after `instance_overrides`."""
    case, _ = CASES["hetero-tp4"]
    cfg = tconfigs.get_config("llama3-8b")
    cs = TC.ClusterSim(cfg, cfg, TS.SimConfig(mode="harli", seed=2),
                       _cluster_config(PORT, case), _tpu_instance())
    tps = [i.cm_inf.inst.tp for i in cs.router.instances.values()]
    assert tps == [4, 2, 2]
    assert {i.cm_inf.inst.chip for i in cs.router.instances.values()} == \
        {_tpu_instance().chip}
    assert cs.router.prefill_cm.inst.tp == 2


# ------------------------------------ properties on one H100 an instance --
H100 = Case("spike", 20.0, 12.0)


@pytest.fixture(scope="module")
def h100_runs():
    return {mode: _run_tp1(dataclasses.replace(H100, mode=mode))
            for mode in ("harli", "separate")}


def _run_tp1(case: Case, seed: int = 2):
    cfg = tconfigs.get_config("llama3-8b")
    reqs = TT.generate_scenario(case.scenario, case.duration, case.rps,
                                seed=seed - 1)
    return TC.simulate_cluster(
        cfg, cfg, reqs, TS.SimConfig(mode=case.mode, seed=seed, tp=1),
        _cluster_config(PORT, case), spec=InstanceSpec())


@pytest.mark.parametrize("mode", ["harli", "separate"])
def test_h100_conservation_and_goodput(h100_runs, mode):
    res = h100_runs[mode]
    s = res.stats
    assert s.offered > 0 and s.routed + s.rejected == s.offered
    assert s.completed > 0 and s.goodput <= s.throughput
    assert 0.0 <= s.slo_attainment <= 1.0
    assert res.ft_throughput > 0


@pytest.mark.parametrize("mode", ["harli", "separate"])
def test_h100_fleet_never_below_min(h100_runs, mode):
    res = h100_runs[mode]
    floor = TC.ClusterConfig().autoscaler.min_decode
    assert res.fleet_timeline
    assert min(n for _, n, _ in res.fleet_timeline) >= floor
    assert res.final_fleet >= floor


def test_h100_seed_determinism(h100_runs):
    again = _run_tp1(H100)
    assert _state(again) == _state(h100_runs["harli"])
    other = _run_tp1(H100, seed=5)
    assert _state(other) != _state(h100_runs["harli"])
