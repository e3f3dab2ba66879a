"""The program's own spans and device marks (`repro_torch/spans.py`) put
against a traced window's device intervals.

The program records its spans while a torch profiler records, on the
profiler's clock (Unix-epoch ns), and its split rounds' CUDA events
beside them. `SpanTracer` is the harness's `Tracer` that also keeps the
window's busy intervals and the harness's own spans; the functions below
read them with the program's spans:

- `idle_by_span`: the window's idle seconds by the innermost (or the
  outermost) program span open at each gap's middle; where none is, the
  harness's span ("perfbench.round" ...), else "between".
- `busy_share`: the device-busy share of the window's spans of one name
  (`engine.admit`: how much the card does while a request is admitted).
- `idle_per_span_ms`: the device-idle ms inside each span of one name
  (`engine.round`).
- `units_set_round`, `unit_ms_by_kind`: from the split rounds' marks, the
  share of rounds whose unit side ended after the decode side, and each
  unit kind's median device ms on the unit partition.

`program()` is None where the program records no spans (a program older
than them): every reader then has nothing to read.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from torch.autograd import DeviceType

from perfbench.harness.trace import HOST_SPANS, Tracer, union


def program():
    """The program's span recorder, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


class SpanTracer(Tracer):
    """`Tracer`, keeping its summary and what `summarize` reduces: the
    window (w0, w1), the union of the device's busy intervals in it, and
    the harness's spans as (t0, t1, name), all in the trace's ns."""

    def __init__(self) -> None:
        super().__init__()
        self.window: Tuple[int, int] = (0, 0)
        self.busy: List[Tuple[int, int]] = []
        self.host: List[Tuple[int, int, str]] = []
        self.summary = None

    def summarize(self):
        out = super().summarize()
        events = self.prof.profiler.kineto_results.events()
        w0, w1 = next((e.start_ns(), e.end_ns()) for e in events
                      if e.name() == "perfbench.window"
                      and e.device_type() == DeviceType.CPU)
        dev, host = [], []
        for e in events:
            s, t = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.name().startswith("perfbench."):
                    s, t = max(s, w0), min(t, w1)
                    if t > s:
                        dev.append((s, t))
            elif e.name() in HOST_SPANS and t > w0 and s < w1:
                host.append((s, t, e.name()))
        self.window, self.busy, self.host = (w0, w1), union(dev), sorted(host)
        self.summary = out
        return out


class Busy:
    """A union of busy intervals, with the busy ns inside any interval."""

    def __init__(self, busy: Sequence[Tuple[int, int]]):
        self.starts = [s for s, _ in busy]
        self.ends = [e for _, e in busy]
        self.cum = [0]
        for s, e in busy:
            self.cum.append(self.cum[-1] + e - s)

    def _upto(self, t: int) -> int:
        """Busy ns before t."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        return self.cum[i - 1] + min(t, self.ends[i - 1]) - \
            self.starts[i - 1]

    def within(self, t0: int, t1: int) -> int:
        return self._upto(t1) - self._upto(t0)


def _innermost(spans, mid: float, starts: List[int], by_id: Dict):
    """The innermost span open at `mid`: spans nest on one thread, so it
    is the last one started by then or an ancestor of it."""
    i = bisect.bisect_right(starts, mid) - 1
    s = spans[i] if i >= 0 else None
    while s is not None and s.t1 < mid:
        s = by_id.get(s.parent)
    return s


def idle_by_span(window: Tuple[int, int], busy, spans,
                 host: Sequence[Tuple[int, int, str]] = (),
                 top: bool = False) -> Dict[str, float]:
    """Idle seconds of the window by the innermost program span open at
    each gap's middle (`top`: by the outermost), else the harness's span
    there, else "between"."""
    w0, w1 = window
    spans = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in spans]
    by_id = {s.id: s for s in spans}
    hstarts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    prev = w0
    for s, e in list(busy) + [(w1, w1)]:
        if s > prev:
            mid = (prev + s) / 2
            sp = _innermost(spans, mid, starts, by_id)
            while top and sp is not None and sp.parent in by_id:
                sp = by_id[sp.parent]
            if sp is not None:
                name = sp.name
            else:
                j = bisect.bisect_right(hstarts, mid) - 1
                name = host[j][2] if j >= 0 and host[j][1] >= mid \
                    else "between"
            idle[name] = idle.get(name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return idle


def busy_share(busy, spans, name: str) -> Optional[float]:
    """% of the total length of the spans named `name` in which the
    device was busy."""
    b = Busy(busy)
    mine = [s for s in spans if s.name == name]
    total = sum(s.t1 - s.t0 for s in mine)
    if not total:
        return None
    return 100.0 * sum(b.within(s.t0, s.t1) for s in mine) / total


def idle_per_span_ms(busy, spans, name: str) -> List[float]:
    """Device-idle ms inside each span named `name`."""
    b = Busy(busy)
    return [(s.t1 - s.t0 - b.within(s.t0, s.t1)) / 1e6 for s in spans
            if s.name == name]


def units_set_round(sides: Sequence[Tuple[float, float]]
                    ) -> Optional[float]:
    """% of split rounds, as (decode side ms, unit side ms) from the
    fork, whose unit side ended after the decode side."""
    if not sides:
        return None
    return 100.0 * sum(u > d for d, u in sides) / len(sides)


def unit_ms_by_kind(per_unit: Sequence[Tuple[str, float]]
                    ) -> Dict[str, float]:
    """Median device ms of a unit by kind, from (kind, ms) pairs."""
    by: Dict[str, List[float]] = {}
    for kind, ms in per_unit:
        by.setdefault(kind, []).append(ms)
    return {k: statistics.median(v) for k, v in sorted(by.items())}
