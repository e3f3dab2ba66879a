"""The cluster layer's parts in the port against the reference's, on
seeded operation sequences.

* `core/api.py`: `available_policies(kind)` for every kind; the registry's
  error texts (an unknown name, an unknown kind, a second class under a
  registered name, a class of no policy kind); and the two registries
  stay apart (a plugin registered in one is absent from the other).
* `core/prefill_pool.py`: a `PrefillPool` under `edf` and `fifo` driven
  by submissions of a spike trace, pumps, added, drained, retired and
  killed workers: after every operation its state and what the operation
  returned equal the reference's (the cost model's instance is the
  reference's v5e, `test_torch_costmodel._tpu_instance`).
* `core/gossip.py`: a `GossipPlane` publishing digests of growing radix
  trees, read at ages inside and past the staleness bound, and dropped:
  the digests, their bytes, the reads, the staleness discards and the
  oldest age used equal the reference's.
* `core/autoscaler.py`: an `Autoscaler`'s three control loops (decode
  fleet, pooled prefill, chunked budget) on seeded snapshot sequences,
  with cooldowns: the decisions equal the reference's.
* `core/policies/routing.py`, `cache_aware.py`, `cache_aware_gossip.py`:
  a `ClusterRouter` over three co-located instances with prefix caches
  (and a gossip plane for `cache_aware_gossip`) dispatches a seeded
  session trace, stepping the instances as the cluster does: each of the
  seven routing policies picks the same instance for every request, and
  ends in the same state, as the reference's.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import api as JAPI  # noqa: E402
from repro.core import autoscaler as JAS  # noqa: E402
from repro.core import costmodel as JCM  # noqa: E402
from repro.core import gossip as JG  # noqa: E402
from repro.core import prefill_pool as JP  # noqa: E402
from repro.core import prefix_cache as JPC  # noqa: E402
from repro.core import prefix_tree as JPT  # noqa: E402
from repro.core import router as JR  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.serving import request as JRQ  # noqa: E402
from repro.serving import trace as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import api as TAPI  # noqa: E402
from repro_torch.core import autoscaler as TAS  # noqa: E402
from repro_torch.core import costmodel as TCM  # noqa: E402
from repro_torch.core import gossip as TG  # noqa: E402
from repro_torch.core import prefill_pool as TP  # noqa: E402
from repro_torch.core import prefix_cache as TPC  # noqa: E402
from repro_torch.core import prefix_tree as TPT  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.serving import request as TRQ  # noqa: E402
from repro_torch.serving import trace as TT  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_costmodel import _tpu_instance  # noqa: E402
from test_torch_simulator import SKIP, _copies, _state  # noqa: E402

REF = SimpleNamespace(configs=jconfigs, api=JAPI, autoscaler=JAS, cm=JCM,
                      gossip=JG, pool=JP, cache=JPC, tree=JPT, router=JR,
                      sim=JS, request=JRQ, trace=JT)
PORT = SimpleNamespace(configs=tconfigs, api=TAPI, autoscaler=TAS, cm=TCM,
                       gossip=TG, pool=TP, cache=TPC, tree=TPT, router=TR,
                       sim=TS, request=TRQ, trace=TT)


def _spec(m, tp=2):
    """The reference's v5e instance on either side."""
    if m is REF:
        return JCM.InstanceSpec(tp=tp)
    return dataclasses.replace(_tpu_instance(), tp=tp)


# ------------------------------------------------------------ registry --
@pytest.mark.parametrize("kind", list(JAPI.KINDS))
def test_available_policies_match_reference(kind):
    assert TAPI.KINDS == JAPI.KINDS
    names = TAPI.available_policies(kind)
    assert names and names == JAPI.available_policies(kind)
    for name in names:
        cls = TAPI.resolve_policy(kind, name)
        assert cls.__module__.startswith("repro_torch.core.policies.")
        ref = JAPI.resolve_policy(kind, name)
        assert (cls.__qualname__, cls.name) == (ref.__qualname__, ref.name)
        assert getattr(cls, "needs_sessions", None) == \
            getattr(ref, "needs_sessions", None)


def _error(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_registry_error_texts_match_reference():
    for kind in JAPI.KINDS:
        assert _error(lambda: TAPI.resolve_policy(kind, "no_such")) == \
            _error(lambda: JAPI.resolve_policy(kind, "no_such"))
    for fn in ("resolve_policy", "available_policies"):
        args = ("routingg", "x") if fn == "resolve_policy" else ("routingg",)
        assert _error(lambda: getattr(TAPI, fn)(*args)) == \
            _error(lambda: getattr(JAPI, fn)(*args))

    class NotAPolicy:
        pass
    assert _error(lambda: TAPI.register_policy("x")(NotAPolicy)) == \
        _error(lambda: JAPI.register_policy("x")(NotAPolicy))
    # a second class under a built-in name names the first one's module,
    # which differs by package only
    port = _error(lambda: TAPI.register_policy("least_loaded")(
        type("Dup", (TAPI.RoutingPolicy,), {"pick": lambda *a: None})))
    ref = _error(lambda: JAPI.register_policy("least_loaded")(
        type("Dup", (JAPI.RoutingPolicy,), {"pick": lambda *a: None})))
    assert port[0] == ref[0] == "ValueError"
    assert port[1].replace("repro_torch.", "repro.") == ref[1]


@pytest.fixture
def plugin_names():
    """Unregisters what a test registered, in both registries."""
    added = []
    yield added
    for api, kind, name in added:
        api.REGISTRY._by_kind[kind].pop(name, None)


def test_registries_stay_apart(plugin_names):
    @TAPI.register_policy("port_only_plugin")
    class PortOnly(TAPI.RoutingPolicy):
        def pick(self, cand, req, router):
            return cand[0]
    plugin_names.append((TAPI, "routing", "port_only_plugin"))

    @JAPI.register_policy("ref_only_plugin")
    class RefOnly(JAPI.RoutingPolicy):
        def pick(self, cand, req, router):
            return cand[0]
    plugin_names.append((JAPI, "routing", "ref_only_plugin"))

    assert "port_only_plugin" in TAPI.available_policies("routing")
    assert "port_only_plugin" not in JAPI.available_policies("routing")
    assert "ref_only_plugin" in JAPI.available_policies("routing")
    assert "ref_only_plugin" not in TAPI.available_policies("routing")
    assert TAPI.resolve_policy("routing", "port_only_plugin") is PortOnly
    # the router still re-exports the sentinels, and the experiment spec
    # resolves lazily through the port's api
    assert (TR.PENDING, TR.REJECTED) == (JR.PENDING, JR.REJECTED) == (-2, -1)
    assert TAPI.ExperimentSpec.__module__ == "repro_torch.core.experiment"
    assert issubclass(TAPI.SpecError, ValueError)


# --------------------------------------------------------- prefill pool --
POOL_SKIP = SKIP + ("cm",)


def _pool_ops(m, ordering):
    """(op, returned, pool state) after every operation of a seeded
    sequence."""
    cfg = m.configs.get_config("llama3-8b")
    pool = m.pool.PrefillPool(
        m.pool.PrefillPoolConfig(n_workers=2, ordering=ordering),
        m.cm.CostModel(cfg, _spec(m), seed=7), ttft_slo_s=4.0)
    reqs = _copies(JT.generate_scenario("spike", 20.0, 12.0, seed=3),
                   m.request)
    rng = np.random.default_rng(5)
    out, qi, t = [], 0, 0.0
    while t < 30.0:
        t += 0.5
        while qi < len(reqs) and reqs[qi].arrival < t:
            pool.submit(reqs[qi], reqs[qi].arrival)
            qi += 1
        op = int(rng.integers(8))
        if op == 0:
            got = pool.add_worker(t)
        elif op == 1:
            got = pool.drain_worker(min_workers=1)
        elif op == 2:
            got = pool.retire_drained(t)
        elif op == 3 and pool.active_workers():
            wid = pool.active_workers()[
                int(rng.integers(len(pool.active_workers())))].wid
            got = pool.kill_worker(wid, t)
            for rid in got:               # the cluster resubmits them
                pool.forget(rid)
        else:
            got = [(r.rid, ready) for r, ready in pool.pump(t)]
        out.append((op, _state(got), _state(pool.snapshot(t)),
                    _state(pool, POOL_SKIP)))
        pool.check_conservation()
    return out


@pytest.mark.parametrize("ordering", ["edf", "fifo"])
def test_prefill_pool_matches_reference(ordering):
    ref = _pool_ops(REF, ordering)
    port = _pool_ops(PORT, ordering)
    ops = {op for op, *_ in ref}
    assert ops >= {0, 1, 2, 3} and len(ref) == len(port)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a == b, i


# --------------------------------------------------------------- gossip --
def _gossip_ops(m):
    plane = m.gossip.GossipPlane(m.gossip.GossipConfig(
        period_s=1.0, staleness_bound_s=3.0, top_k=4))
    trees = {i: m.tree.RadixPrefixTree(4_000) for i in range(3)}
    rng = np.random.default_rng(9)
    out = []
    for step in range(120):
        now = step * 0.25
        iid = int(rng.integers(3))
        op = int(rng.integers(6))
        if op <= 1:
            segs = ((int(rng.integers(4)), int(rng.integers(16, 400))),
                    (100 + int(rng.integers(40)),
                     int(rng.integers(8, 200))))
            trees[iid].insert(segs)
            got = None
        elif op == 2:
            got = plane.publish(iid, now, trees[iid])
        elif op == 3:
            plane.drop(iid)
            got = len(plane)
        else:
            d = plane.get(iid, now)
            got = (d, None if d is None else plane.discount(d.age(now)))
        out.append((op, _state(got), _state(plane)))
    return out


def test_gossip_plane_matches_reference():
    ref, port = _gossip_ops(REF), _gossip_ops(PORT)
    last = ref[-1][2]
    assert last["published"] > 0 and last["stale_discards"] > 0
    assert last["reads"] > 0 and last["bytes_published"] > 0
    assert port == ref


# ----------------------------------------------------------- autoscaler --
def _autoscaler_ops(m):
    A = m.autoscaler
    scaler = A.Autoscaler(A.AutoscalerConfig(cooldown_ticks=1,
                                             prefill_cooldown_ticks=1))
    rng = np.random.default_rng(13)
    roles = ("decode", "colocated", "finetune")
    for tick in range(200):
        t = 5.0 * tick
        snaps = [A.InstanceSnapshot(
            inst_id=i, role=roles[int(rng.integers(3))],
            load=float(rng.uniform(0.0, 1.3)),
            active=int(rng.integers(0, 9)),
            colocatable=bool(rng.integers(2)),
            can_serve=bool(rng.integers(4) > 0),
            draining=bool(rng.integers(6) == 0))
            for i in range(int(rng.integers(1, 6)))]
        scaler.evaluate(t, snaps, float(rng.uniform(0.0, 0.05)),
                        float(rng.uniform(0.0, 2.0)))
        n_serving = sum(s.can_serve and s.role != "finetune"
                        for s in snaps)
        snap = m.pool.PrefillPoolSnapshot(
            n_workers=int(rng.integers(1, 5)),
            n_draining=int(rng.integers(0, 2)),
            queue_depth=int(rng.integers(0, 20)),
            backlog_s=float(rng.uniform(0.0, 3.0)),
            wait_p99=float(rng.uniform(0.0, 4.0)))
        scaler.evaluate_prefill(t, snap, n_serving)
        scaler.evaluate_chunked(
            t, float(rng.uniform(0.0, 4.0)), float(rng.uniform(0.0, 0.1)),
            int(rng.integers(64, 1025)), 64, 1024, n_serving)
        scaler.prefill_floor(n_serving)
    return scaler.decisions


def test_autoscaler_matches_reference():
    ref, port = _autoscaler_ops(REF), _autoscaler_ops(PORT)
    actions = {d.action for d in ref}
    assert len(actions) >= 6, actions
    assert _state(port) == _state(ref)


# -------------------------------------------------------------- routing --
ROUTING = ("least_loaded", "round_robin", "random", "predicted_latency",
           "session_affinity", "cache_aware", "cache_aware_gossip")


def _routing_ops(m, policy):
    """Dispatch a seeded session trace through a chained-placement router
    over three co-located instances, stepping them epoch by epoch as the
    cluster does. Returns every pick and the end state."""
    cfg = m.configs.get_config("llama3-8b")
    sim = m.sim.SimConfig(mode="harli", seed=2)
    spec = _spec(m, sim.tp)
    fit = (cfg, sim) if m is REF else (cfg, sim, spec)
    predictor, _ = m.sim.fit_predictor(*fit)
    router = m.router.ClusterRouter(
        m.router.RouterConfig(policy=policy, seed=19),
        m.cm.CostModel(cfg, spec, seed=sim.seed + 7), predictor=predictor)
    kw = {} if m is REF else {"spec": _tpu_instance()}
    for i in range(3):
        router.add_instance(m.sim.DecodeInstanceSim(
            i, cfg, cfg, sim, predictor, sim.seed + i, role="colocated",
            prefix_cache=m.cache.PrefixCacheConfig(), **kw))
    plane = None
    if policy == "cache_aware_gossip":
        plane = router.gossip = m.gossip.GossipPlane(m.gossip.GossipConfig())
    scenario = "shared_prefix" if plane is not None else "session_heavy"
    reqs = _copies(JT.generate_scenario(scenario, 12.0, 8.0, seed=1,
                                        n_sessions=12), m.request)
    picks, qi, t = [], 0, 0.0
    while t < 12.0:
        end = t + 1.0
        while qi < len(reqs) and reqs[qi].arrival < end:
            r = reqs[qi]
            picks.append((r.rid, router.dispatch(r, r.arrival),
                          r.cache_hit_tokens))
            qi += 1
        for inst in router.instances.values():
            while inst.t < end:
                inst.step(end)
            if plane is not None:
                plane.publish(inst.inst_id, end, inst.prefix_cache.tree)
        t = end
    router.check_conservation()
    return picks, _state(router.policy), router.dispatch_peeks, \
        _state(router.stats(12.0))


@pytest.mark.parametrize("policy", ROUTING)
def test_routing_policy_picks_match_reference(policy):
    ref = _routing_ops(REF, policy)
    port = _routing_ops(PORT, policy)
    assert len({iid for _, iid, _ in ref[0]}) > 1
    if policy in ("session_affinity", "cache_aware", "cache_aware_gossip"):
        assert any(hit > 0 for *_, hit in ref[0])
    assert port == ref
