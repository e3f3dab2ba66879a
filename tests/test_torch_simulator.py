"""The port's co-location simulator and request traces against the
reference's.

* `serving/trace.py`: for every scenario of `SCENARIOS` at two seeds (and
  the default `TraceConfig`) the generated requests equal the reference's
  field by field, and so do `FailureSchedule`'s kill times and victim
  picks.
* `core/simulator.py::simulate` on the reference's instance (TPU v5e, tp
  from `SimConfig`, its cost constants; `test_torch_costmodel._tpu_instance`
  builds it in the port's types), llama3-8b serving and finetuning, qos
  40 ms, a 30 s trace at 4 rps (seed 1), sim seed 2: in separate, static
  and harli mode every field of `SimResult` equals the reference's, the
  TPOT samples and the batch, quantum and memory timelines included, and
  the predictor's fit report but for its wall-clock fit times. Also with
  stragglers injected (`straggler_prob` 0.05).
* `DecodeInstanceSim` driven through `enqueue`/`step` as the cluster layer
  drives it, against the reference's instance event by event: with
  chunked prefill (`ChunkedPrefillConfig`), with a session prefix cache,
  and with a `FinetuneCheckpointer` that commits, is killed and restores.
* The reference's regression properties
  (`tests/test_simulator_regression.py`) on the port's own instance, one
  H100 (tp 1) with the committed cost constants: harli beats separate on
  finetune throughput, holds QoS attainment at 0.97 or more, completes
  every request; finetune makes progress in both modes; the same seed
  reproduces the identical result and another seed does not.
"""

import dataclasses
import enum
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import prefix_cache as JPC  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.serving import request as JRQ  # noqa: E402
from repro.serving import trace as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import prefix_cache as TPC  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.serving import request as TRQ  # noqa: E402
from repro_torch.serving import trace as TT  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_costmodel import _tpu_instance  # noqa: E402

QOS_S = 0.040
MODES = ("separate", "static", "harli")
# objects another field already covers, or that differ by package only
# (the cost model's instance and constants: `test_torch_costmodel.py`)
SKIP = ("parent", "alloc", "inst", "c", "predictor", "sched", "mgr", "cfg",
        "cfg_inf", "sim", "_thread")


def _state(x, skip=SKIP):
    """x's state as plain values: dataclasses as dicts, enums by name, a
    numpy generator by its bit state, objects by their attributes (less
    `skip`), containers element-wise."""
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, np.random.Generator):
        return x.bit_generator.state
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _state(getattr(x, f.name), skip)
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _state(v, skip) for k, v in x.items()}
    if isinstance(x, (list, tuple)) or type(x).__name__ == "deque":
        return [_state(v, skip) for v in x]
    if hasattr(x, "__dict__"):
        return {k: _state(v, skip) for k, v in vars(x).items()
                if k not in skip}
    if hasattr(type(x), "__slots__"):
        return {k: _state(getattr(x, k), skip) for k in type(x).__slots__
                if k not in skip}
    return x


def _copies(base, mod):
    """Fresh requests of `mod`'s type with `base`'s fields."""
    return [mod.Request(**{f.name: getattr(r, f.name)
                           for f in dataclasses.fields(r)
                           if f.name in ("rid", "arrival", "prompt_len",
                                         "max_new_tokens", "session_id",
                                         "prefix_segments")})
            for r in base]


# ------------------------------------------------------------- traces ----
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("scenario", list(JT.SCENARIOS) + ["default"])
def test_trace_matches_reference(scenario, seed):
    assert TT.SCENARIOS == JT.SCENARIOS
    if scenario == "default":
        ref = JT.generate(JT.TraceConfig(duration_s=60.0, seed=seed))
        port = TT.generate(TT.TraceConfig(duration_s=60.0, seed=seed))
    else:
        ref = JT.generate_scenario(scenario, duration_s=120.0, seed=seed)
        port = TT.generate_scenario(scenario, duration_s=120.0, seed=seed)
    assert ref and _state(port) == _state(ref)


@pytest.mark.parametrize("seed", [0, 7])
def test_failure_schedule_matches_reference(seed):
    kw = dict(rate_per_min=4.0, start_s=5.0, seed=seed)
    ref = JT.FailureSchedule(JT.FailureConfig(**kw), 600.0)
    port = TT.FailureSchedule(TT.FailureConfig(**kw), 600.0)
    assert ref.events and port.events == ref.events
    cands = [("instance", i) for i in range(5)] + [("prefill", 0)]
    for now in (30.0, 90.0, 300.0, 601.0):
        due = port.pop_due(now)
        assert due == ref.pop_due(now)
        for _ in due:
            assert port.pick(cands) == ref.pick(cands)


# ---------------------------------------------------------- simulate ----
@pytest.fixture(scope="module")
def trace30():
    return JT.generate(JT.TraceConfig(duration_s=30.0, mean_rps=4.0,
                                      seed=1))


def _both(trace, **sim):
    """(reference, port) SimResult of llama3-8b on the v5e instance."""
    jcfg, tcfg = (m.get_config("llama3-8b") for m in (jconfigs, tconfigs))
    ref = JS.simulate(jcfg, jcfg, _copies(trace, JRQ),
                      JS.SimConfig(qos_s=QOS_S, seed=2, **sim))
    port = TS.simulate(tcfg, tcfg, _copies(trace, TRQ),
                       TS.SimConfig(qos_s=QOS_S, seed=2, **sim),
                       spec=_tpu_instance())
    return ref, port


def _report(rep):
    """The fit report without its wall-clock fit times."""
    return None if rep is None else {k: v for k, v in _state(rep).items()
                                     if not k.endswith("_fit_s")}


def _assert_equal_results(ref, port):
    a, b = _state(port), _state(ref)
    for key in a:
        if key == "predictor_report":
            assert _report(port.predictor_report) == \
                _report(ref.predictor_report)
        else:
            assert a[key] == b[key], key


def test_sim_config_crosses_unchanged():
    assert _state(TS.SimConfig()) == _state(JS.SimConfig())
    assert _state(TS.ChunkedPrefillConfig()) == \
        _state(JS.ChunkedPrefillConfig())


@pytest.mark.parametrize("mode", MODES)
def test_simulate_matches_reference(trace30, mode):
    ref, port = _both(trace30, mode=mode)
    _assert_equal_results(ref, port)
    assert port.completed == len(trace30) and port.tpot


def test_simulate_with_stragglers_matches_reference(trace30):
    ref, port = _both(trace30, mode="harli", straggler_prob=0.05)
    _assert_equal_results(ref, port)


# ------------------------------------- DecodeInstanceSim, enqueue/step --
def _instance_pair(sim_kw, **inst_kw):
    """(reference, port) colocated llama3-8b instances on the v5e spec,
    with the harli predictor fitted, and `inst_kw` built per side by
    `inst_kw[name](module)`."""
    out = []
    for cfgs, S, spec in ((jconfigs, JS, {}),
                          (tconfigs, TS, {"spec": _tpu_instance()})):
        cfg = cfgs.get_config("llama3-8b")
        sim = S.SimConfig(mode="harli", qos_s=QOS_S, seed=2, **sim_kw)
        pred, _ = S.fit_predictor(cfg, sim, **spec)
        kw = {k: make(S) for k, make in inst_kw.items()}
        out.append(S.DecodeInstanceSim(0, cfg, cfg, sim, pred, 2, **kw,
                                       **spec))
    return out


def _drive(inst, reqs, until, ready=None, chunked=False):
    """Enqueue every request, then step to `until` one event at a time;
    the sequence of clocks the steps return."""
    for r in reqs:
        if chunked:
            inst.enqueue_chunked(r, 0.0)
        else:
            inst.enqueue(r, ready[r.rid])
    clocks = []
    while inst.t < until:
        clocks.append(inst.step(until))
    return clocks


def _ready(reqs):
    return {r.rid: r.arrival + 0.05 + 1e-4 * r.prompt_len for r in reqs}


def test_chunked_prefill_instance_matches_reference(trace30):
    ref, port = _instance_pair(
        {}, chunked=lambda S: S.ChunkedPrefillConfig(budget_tokens=192))
    clocks_ref = _drive(ref, _copies(trace30, JRQ), 30.0, chunked=True)
    clocks_port = _drive(port, _copies(trace30, TRQ), 30.0, chunked=True)
    assert clocks_port == clocks_ref
    assert port.chunk_timeline and _state(port) == _state(ref)
    assert _state(port.alloc) == _state(ref.alloc)
    assert port.recent_chunk_waits(30.0) == ref.recent_chunk_waits(30.0)


def test_prefix_cache_instance_matches_reference():
    base = JT.generate_scenario("shared_prefix", duration_s=30.0,
                                mean_rps=4.0, seed=3)
    ref, port = _instance_pair(
        {}, prefix_cache=lambda S: (JPC if S is JS else TPC)
        .PrefixCacheConfig(chunks=8, min_hit_tokens=16))
    reqs_ref, reqs_port = _copies(base, JRQ), _copies(base, TRQ)
    for a, b in zip(reqs_ref, reqs_port):
        # the router's dispatch-time lookup, then the instance
        assert port.prefix_cache.lookup(b.session_id, b.prompt_len,
                                        b.prefix_segments) == \
            ref.prefix_cache.lookup(a.session_id, a.prompt_len,
                                    a.prefix_segments)
    assert _drive(port, reqs_port, 30.0, _ready(base)) == \
        _drive(ref, reqs_ref, 30.0, _ready(base))
    assert port.prefix_cache.stats.insertions > 0
    assert _state(port) == _state(ref)
    assert _state(port.alloc) == _state(ref.alloc)


def test_checkpointer_instance_matches_reference(trace30, tmp_path):
    dirs = {JS: tmp_path / "ref", TS: tmp_path / "port"}
    ref, port = _instance_pair({}, ckpt=lambda S: S.FinetuneCheckpointer(
        dirs[S], interval_s=4.0, commit_time_s=0.3))
    half = [r for r in trace30 if r.arrival < 15.0]
    assert _drive(port, _copies(half, TRQ), 15.0, _ready(half)) == \
        _drive(ref, _copies(half, JRQ), 15.0, _ready(half))
    assert port.ckpt.commits == ref.ckpt.commits > 0
    assert port.ckpt.restore_units() == ref.ckpt.restore_units() > 0
    lost_port, iters_port = port.kill(port.t)
    lost_ref, iters_ref = ref.kill(ref.t)
    assert _state(lost_port) == _state(lost_ref) and lost_port
    assert iters_port == iters_ref > 0
    assert port.ft.units_done == ref.ft.units_done == \
        ref.ckpt.restore_units()
    assert _state(port) == _state(ref)


# ------------------------------ the regression properties on the H100 --
def _h100(mode, seed=2, trace_seed=1):
    cfg = tconfigs.get_config("llama3-8b")
    reqs = TT.generate(TT.TraceConfig(duration_s=30.0, mean_rps=4.0,
                                      seed=trace_seed))
    return len(reqs), TS.simulate(cfg, cfg, reqs, TS.SimConfig(
        mode=mode, qos_s=QOS_S, seed=seed, tp=1))


@pytest.fixture(scope="module")
def h100():
    return {m: _h100(m) for m in ("harli", "separate")}


def test_h100_harli_beats_separate_at_held_qos(h100):
    (n, h), (_, s) = h100["harli"], h100["separate"]
    assert h.ft_throughput > s.ft_throughput, (h.ft_throughput,
                                               s.ft_throughput)
    assert h.tpot and 1.0 - h.qos_violation_frac >= 0.97
    for mode, (n, res) in h100.items():
        assert res.completed == n, mode
        assert res.ft_iterations > 0 and res.ft_units_done > 0, mode


def test_h100_same_seed_same_result_other_seed_differs():
    a = _state(_h100("harli", seed=4, trace_seed=3)[1])
    b = _state(_h100("harli", seed=4, trace_seed=3)[1])
    c = _state(_h100("harli", seed=5, trace_seed=3)[1])
    for d in (a, b, c):
        d.pop("predictor_report")
    assert a == b and a != c


def test_trace_replay_prints_the_fig11_comparison(capsys):
    from repro_torch.launch import trace_replay
    out = trace_replay.main(["--duration", "10", "--rps", "2"])
    text = capsys.readouterr().out
    assert set(out) == set(MODES)
    assert "Harli vs SeparateMode:" in text and "Harli vs StaticMode:" in text
    for mode in MODES:
        assert f"{mode:9s} ft_throughput=" in text
    assert out["harli"].completed == out["separate"].completed > 0
