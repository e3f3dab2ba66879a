"""The device trace of a traced run (`--trace 1`).

`torch.profiler` records the window, CPU and CUDA, with the kernels that
graph replays launch. A `record_function` span "perfbench.window" marks
the window in the trace's clock; the harness's spans ("perfbench.admit",
"perfbench.schedule", "perfbench.round") say what the host was doing.
`summarize` reduces the trace to what the per-layer metrics read: the
union of the device's busy intervals (its kernels, copies and sets; the
profiler's mirrors of the harness's spans on the device timeline are
left out), device time by operation name,
and the idle time between them by the host span it fell in. No timeline
is written.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

HOST_SPANS = ("perfbench.admit", "perfbench.schedule", "perfbench.round")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_s: Dict[str, float]            # device seconds by operation name
    op_n: Dict[str, int]              # device operations by name
    idle_s: Dict[str, float]          # idle seconds by host span

    def device_s(self, *parts: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds any
        of `parts`."""
        names = [n for n in self.op_s if any(p in n for p in parts)]
        return (sum(self.op_s[n] for n in names),
                sum(self.op_n[n] for n in names))


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Tracer:
    def __init__(self) -> None:
        self.prof: Optional[profile] = None
        self.span = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up, so that starting it
        at the window's opening costs the window little."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            (torch.ones(8, device="cuda") + 1).sum().item()

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function("perfbench.window")
        self.span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summarize(self) -> TraceSummary:
        # the profiler's raw events (its FunctionEvent tree takes minutes to
        # build for a window of graph replays); times in ns, one clock
        events = self.prof.profiler.kineto_results.events()
        win = [e for e in events if e.name() == "perfbench.window"
               and e.device_type() == DeviceType.CPU]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win[0].start_ns(), win[0].end_ns()
        dev, spans = [], []
        op_s: Dict[str, float] = {}
        op_n: Dict[str, int] = {}
        for e in events:
            name = e.name()
            s, t = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith("perfbench."):
                    continue        # a host span's mirror on the device
                s, t = max(s, w0), min(t, w1)
                if t <= s:
                    continue
                dev.append((s, t))
                op_s[name] = op_s.get(name, 0.0) + (t - s) / 1e9
                op_n[name] = op_n.get(name, 0) + 1
            elif name in HOST_SPANS and t > w0 and s < w1:
                spans.append((s, t, name.split(".", 1)[1]))
        busy = union(dev)
        spans.sort()
        starts = [s for s, _, _ in spans]
        idle: Dict[str, float] = {}
        prev = w0
        for s, e in busy + [(w1, w1)]:
            if s > prev:
                mid = (prev + s) / 2
                i = bisect.bisect_right(starts, mid) - 1
                # the last span that started before the gap's middle and
                # is still open then; the schedule span sits outside the
                # round span, so at most one holds
                name = spans[i][2] if i >= 0 and spans[i][1] >= mid \
                    else "between"
                idle[name] = idle.get(name, 0.0) + (s - prev) / 1e9
            prev = max(prev, e)
        return TraceSummary((w1 - w0) / 1e9,
                            sum(e - s for s, e in busy) / 1e9, op_s, op_n,
                            idle)
