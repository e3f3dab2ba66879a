"""The program's spans read against a traced window (`harness/
program_spans.py`, `idle_by_span.py`, the `units_set_round.colo` reader):
on hand-built busy intervals, spans and marks with known answers; and on
CPU runs of the smoke cells, where a traced window records one
`engine.round` span per round of the window and an untraced run records
none."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import idle_by_span as T
from perfbench.harness import cell, cli, spec
from perfbench.harness import program_spans as PS
from perfbench.harness.record import Record
from perfbench.harness.trace import Tracer
from perfbench.tests.conftest import REPO
from repro_torch import spans
from repro_torch.spans import Span

MS = 1_000_000


@pytest.fixture(autouse=True)
def _off():
    spans.enable()
    spans.disable()
    yield
    spans.disable()


def _tree():
    """Two rounds and an admission between them, in ms: a round [0, 10]
    with its step [2, 8] holding a unit [3, 7]; an admission [12, 20]
    with its prefill [13, 19]; a round [22, 30]."""
    return [Span(3, 2, "colo.unit", 3 * MS, 7 * MS, {"kind": "FWD"}),
            Span(2, 1, "engine.round.step", 2 * MS, 8 * MS, {}),
            Span(1, 0, "engine.round", 0, 10 * MS, {}),
            Span(5, 4, "engine.prefill", 13 * MS, 19 * MS, {}),
            Span(4, 0, "engine.admit", 12 * MS, 20 * MS, {}),
            Span(6, 0, "engine.round", 22 * MS, 30 * MS, {})]


# busy: [1, 4] [6, 9] [14, 18] [23, 24]; the window [0, 32]
BUSY = [(1 * MS, 4 * MS), (6 * MS, 9 * MS), (14 * MS, 18 * MS),
        (23 * MS, 24 * MS)]
HOST = [(-1 * MS, 11 * MS, "perfbench.round"),
        (11 * MS, 21 * MS, "perfbench.admit"),
        (21 * MS, 31 * MS, "perfbench.round")]


def test_idle_by_innermost_and_outermost_span():
    inner = PS.idle_by_span((0, 32 * MS), BUSY, _tree(), HOST)
    # gaps: [0,1] round; [4,6] unit; [9,14] mid 11.5: no program span,
    # the harness's admit; [18,23] mid 20.5: perfbench.admit (to 21);
    # [24,32] mid 28: round
    assert inner == pytest.approx({"engine.round": 0.009,
                                   "colo.unit": 0.002,
                                   "perfbench.admit": 0.010})
    outer = PS.idle_by_span((0, 32 * MS), BUSY, _tree(), HOST, top=True)
    assert outer == pytest.approx({"engine.round": 0.011,
                                   "perfbench.admit": 0.010})
    # past the harness's spans: between
    assert PS.idle_by_span((0, 40 * MS), BUSY, _tree(), HOST)[
        "between"] == pytest.approx(0.016)


def test_busy_share_and_idle_per_span():
    assert PS.busy_share(BUSY, _tree(), "engine.admit") == \
        pytest.approx(100 * 4 / 8)
    assert PS.idle_per_span_ms(BUSY, _tree(), "engine.round") == \
        pytest.approx([10 - 6, 8 - 1])
    assert PS.busy_share(BUSY, _tree(), "sched.pick") is None
    b = PS.Busy(BUSY)
    assert b.within(0, 32 * MS) == 11 * MS
    assert b.within(2 * MS, 7 * MS) == 3 * MS


def test_marks_give_sides_and_unit_kinds():
    sides = [(10.0, 12.0), (10.0, 8.0), (9.0, 9.0), (11.0, 15.0)]
    assert PS.units_set_round(sides) == 50.0
    assert PS.units_set_round([]) is None
    assert PS.unit_ms_by_kind([("FWD", 2.0), ("BWD", 5.0), ("FWD", 4.0),
                               ("FWD", 3.0)]) == {"BWD": 5.0, "FWD": 3.0}


class _Marks:
    def __init__(self, decode_ms, units_ms):
        self.sides = (decode_ms, units_ms)

    def read(self):
        return (*self.sides, [])


class _Program:
    @staticmethod
    def marks():
        return [_Marks(14.0, 9.0), _Marks(14.0, 16.0), _Marks(15.0, 17.5),
                _Marks(16.0, 10.0)]


class _Rec:
    trace = object()


def test_units_set_round_reader(monkeypatch):
    monkeypatch.setattr(PS, "program", lambda: _Program)
    read = spec.reader(REPO, "units_set_round.colo")
    assert read(_Rec()) == 50.0
    untraced = _Rec()
    untraced.trace = None
    assert read(untraced) is None


def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(PS, "program", lambda: None)
    assert spec.reader(REPO, "units_set_round.colo")(_Rec()) is None


class CpuTracer(PS.SpanTracer):
    """The harness's tracer on CPU activities only (the CPU has no CUDA
    timeline)."""

    @staticmethod
    def warm() -> None:
        pass

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.__enter__()
        self.span = record_function("perfbench.window")
        self.span.__enter__()

    def stop(self) -> None:
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)


@pytest.mark.parametrize("trace", [1, 0])
def test_smoke_window_records_a_round_span_per_round(smoke_root, trace,
                                                     capsys, monkeypatch):
    """The benchmark's own run of `dense-smoke.colo`: traced, the program
    records its spans over the window, one `engine.round` per round and
    one `engine.admit` per admission of the window; untraced, none, and
    recording stays off."""
    kept = []
    monkeypatch.setattr(cell, "Record",
                        lambda **kw: kept.append(Record(**kw)) or kept[-1])
    monkeypatch.setattr(cell, "Tracer", CpuTracer)
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    # a few threads, as `smoke.run`: the suite's workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        rc = cli.main(["--workload", "dense-smoke.colo", "--seed", "20260",
                       "--seconds", "3", "--trace", str(trace)],
                      time.perf_counter(), root=smoke_root, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, (out + err)[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    (rec,) = kept
    names = [s.name for s in spans.records()]
    if trace:
        assert rec.rounds and names.count("engine.round") == len(rec.rounds)
        assert names.count("engine.admit") == len(rec.admissions)
        assert names.count("sched.pick") == len(rec.rounds)
        assert names.count("colo.unit") == sum(r.k for r in rec.rounds)
    else:
        assert names == [] and not spans.enabled()


def test_tool_holds_spans_on_over_an_untraced_window(smoke_root,
                                                     monkeypatch):
    """`idle_by_span.py --mode spans`: the program's spans held on over the
    window alone, the profiler off, one round span per round."""
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    res = T.run(smoke_root, "dense-smoke.long", 7, 1.0, "spans",
                device="cpu", tracer=CpuTracer)
    assert res["spans"]["engine.round"] == \
        res["spans"]["engine.round.step"] > 0
    assert "tpot_p95_ms" in res["metrics"]
    assert not spans.enabled()
    assert cell.Tracer is Tracer


def test_tool_reads_a_traced_window(smoke_root, monkeypatch):
    """`idle_by_span.py --mode traced` on the CPU (no device intervals):
    the whole window one gap, put under one span by both readings, and
    the program's round spans inside the harness's on one clock."""
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    res = T.run(smoke_root, "dense-smoke.long", 7, 1.0, "traced",
                device="cpu", tracer=CpuTracer)
    assert res["correct"] is True and res["spans"]["engine.round"] > 0
    inner, outer = res["idle_by_span"], res["idle_by_top_span"]
    assert len(inner) == len(outer) == 1
    assert sum(inner.values()) == pytest.approx(sum(outer.values()))
    assert set(res["clocks"]) == {"engine.round", "engine.admit"}
    assert res["span_lead_us"]["engine.round"] >= 0
