"""The port's span recorder (`repro_torch/spans.py`) on the CPU: off, a
span is one shared object that reads no clock; on, spans nest by thread
with their attributes; the recording follows a profiler and sits on its
clock; the engine's admissions and rounds and the co-located runner's
units give their spans, one each, with the children they name. The
split rounds' device marks run on the card (`tests/test_torch_gpu.py`)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch import spans  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import colocation as C  # noqa: E402
from repro_torch.core.scheduler import RoundDecision  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.training import peft as TP  # noqa: E402
from repro_torch.training.data import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticCorpus)


@pytest.fixture(autouse=True)
def _off():
    """Each test starts off, on an empty recording."""
    spans.enable()
    spans.disable()
    yield
    spans.disable()


def _children(recs, parent):
    return [s.name for s in recs if s.parent == parent.id]


def test_off_is_one_object_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("an unrecorded span read the clock")
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(time, "time_ns", no_clock)
    got = {id(spans.span("a", x=1)), id(spans.span("b")),
           id(spans.top("c", t0=5))}
    assert len(got) == 1
    with spans.top("c") as sp:
        with spans.span("d"):
            sp.set(k=2)
    assert not spans.enabled() and spans.records() == []
    assert spans.split_marks() is None


def test_nesting_gives_parents_and_keeps_attrs():
    spans.enable()
    t0 = time.perf_counter_ns()
    with spans.top("a", x=1) as a:
        with spans.span("b", y=2) as b:
            b.set(z=3)
        with spans.span("c", t0=t0):
            pass
        a.set(k=4)
    recs = {s.name: s for s in spans.records()}
    assert [s.name for s in spans.records()] == ["b", "c", "a"]
    a, b, c = recs["a"], recs["b"], recs["c"]
    assert a.parent == 0 and b.parent == a.id and c.parent == a.id
    assert a.attrs == {"x": 1, "k": 4} and b.attrs == {"y": 2, "z": 3}
    assert a.t0 <= b.t0 <= b.t1 <= a.t1 and c.t1 <= a.t1
    # a start read by the caller, on the same offset
    assert c.t0 == t0 + spans._OFFSET <= a.t0
    # Unix-epoch ns
    assert abs(a.t0 - time.time_ns()) < 60e9


def test_recording_follows_the_profiler():
    with spans.top("before"):
        pass
    assert not spans.enabled() and spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.top("inside"):
            with spans.span("child"):
                pass
    assert [s.name for s in spans.records()] == ["child", "inside"]
    with spans.top("after"):                  # switches off, keeps them
        pass
    assert not spans.enabled()
    assert [s.name for s in spans.records()] == ["child", "inside"]
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.top("next"):
            pass
    assert [s.name for s in spans.records()] == ["next"]    # a new one


def test_span_holds_the_profilers_event_on_its_clock():
    """A span around a `record_function` region holds that region's
    kineto event, with 1 ms of slack on each side."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.top("outer"):
            time.sleep(0.002)
            with record_function("inner_region"):
                torch.ones(64, 64).sum()
                time.sleep(0.003)
            time.sleep(0.002)
    outer = next(s for s in spans.records() if s.name == "outer")
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "inner_region"
              and e.device_type() == DeviceType.CPU)
    slack = 1_000_000
    assert outer.t0 - slack <= ev.start_ns() <= ev.end_ns() <= \
        outer.t1 + slack
    # the event sits in the middle, not at an edge
    assert ev.start_ns() - outer.t0 > 1_000_000
    assert outer.t1 - ev.end_ns() > 1_000_000


def _job(cfg, params):
    pc = TP.PeftConfig(micro_batch=2, seq_len=12, accum=1)
    pf = Prefetcher(SyntheticCorpus(
        DataConfig(cfg.vocab_size, 12, 2, seed=1)).batches(), pc.n_stage)
    return pc, TP.init_ft_state(cfg, pc, params, 0, pf.stacked())


def test_engine_admissions_and_rounds_give_their_spans():
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, max_slots=2, s_max=64, device="cpu")
    reqs = [Request(rid=i, arrival=0.0, prompt_len=5 + i, max_new_tokens=3)
            for i in range(3)]
    spans.enable()
    m = eng.run_trace(reqs)
    recs = spans.records()
    admits = [s for s in recs if s.name == "engine.admit"]
    rounds = [s for s in recs if s.name == "engine.round"]
    assert len(admits) == m.prefills == 3
    assert len(rounds) == m.decode_rounds
    assert sorted((s.attrs["rid"], s.attrs["prompt_len"]) for s in admits) \
        == [(0, 5), (1, 6), (2, 7)]
    for s in admits:
        assert _children(recs, s) == ["engine.admit.cache", "engine.prefill",
                                      "engine.admit.insert",
                                      "engine.admit.token"]
    for s, bs in zip(rounds, m.round_batch_sizes):
        assert s.attrs == {"batch": bs} and s.parent == 0
        assert _children(recs, s) == ["engine.round.inputs",
                                      "engine.round.step",
                                      "engine.round.tokens",
                                      "engine.round.finish"]
    # each round's host time lies inside its span
    for s, secs in zip(rounds, m.round_s):
        assert secs * 1e9 <= s.t1 - s.t0


class _Sched:
    """Picks k = 2 every round (the serve loop's scheduler interface)."""

    def __init__(self):
        self.decisions = []

    def pick(self, bs, ctx, *, ft_ready, ft_units_available):
        d = RoundDecision(2, 0.01 * bs, "ok")
        self.decisions.append(d)
        return d

    def observe(self, actual_s):
        pass


def test_colocated_rounds_give_unit_spans_of_their_kinds():
    """A sequential co-located round (the CPU's) gives `colo.decode`, then
    `colo.units` holding k `colo.unit` spans whose kinds are the unit
    step's; the serve loop's pick gives `sched.pick` with the decision;
    no device marks off the split."""
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    pc, ft = _job(cfg, params)
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=4)
    unit = runner.unit_step
    eng = ServingEngine(cfg, params, max_slots=2, s_max=64, device="cpu")
    reqs = [Request(rid=i, arrival=0.0, prompt_len=6, max_new_tokens=3)
            for i in range(2)]
    sched = _Sched()
    spans.enable()
    idx0 = ft["unit_idx"]
    m, ft = C.run_colocated_trace(eng, runner, sched, ft, reqs)
    recs = spans.records()
    by_id = {s.id: s for s in recs}
    picks = [s for s in recs if s.name == "sched.pick"]
    assert len(picks) == len(sched.decisions) == m.decode_rounds
    assert all(s.attrs["k"] == 2 and s.parent == 0 for s in picks)
    groups = [s for s in recs if s.name == "colo.units"]
    assert len(groups) == m.decode_rounds and all(s.attrs == {"k": 2}
                                                  for s in groups)
    units = [s for s in recs if s.name == "colo.unit"]
    assert len(units) == m.ft_units == 2 * m.decode_rounds
    total = unit.total_units
    assert [s.attrs["unit"] for s in units] == \
        [(idx0 + j) % total for j in range(len(units))]
    assert [s.attrs["kind"] for s in units] == \
        [unit.kind(s.attrs["unit"]) for s in units]
    for s in units:
        assert by_id[s.parent].name == "colo.units"
        step = by_id[by_id[s.parent].parent]
        assert step.name == "engine.round.step"
        assert by_id[step.parent].name == "engine.round"
    assert len([s for s in recs if s.name == "colo.decode"]) == \
        m.decode_rounds
    assert spans.marks() == []
    # a round of k = 0 runs no units and opens no unit span
    spans.enable()
    tokens = torch.zeros((2,), dtype=torch.int32)
    runner.run_round(0, tokens, tokens, eng.cache, ft)
    assert [s.name for s in spans.records()] == ["colo.decode"]


def test_unrecorded_runs_record_nothing():
    cfg = smoke_config("llama3-8b")
    params = TMD.init_params(cfg, 0, device="cpu")
    eng = ServingEngine(cfg, params, max_slots=2, s_max=64, device="cpu")
    toks = np.arange(5, dtype=np.int32)
    assert eng.try_admit(Request(rid=0, arrival=0.0, prompt_len=5,
                                 max_new_tokens=2), toks)
    eng.decode_round()
    assert spans.records() == [] and not spans.enabled()


def test_the_port_opens_no_profiler_range():
    """No `record_function` or NVTX range in the port: a trace would
    mirror it on the device's timeline and count it as device work."""
    import ast
    from pathlib import Path
    root = Path(spans.__file__).parent
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            name = getattr(node, "attr", None) or getattr(node, "id", None) \
                or getattr(node, "module", None) or ""
            assert "record_function" not in name and "nvtx" not in name, \
                path
