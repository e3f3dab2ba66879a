"""Program spans: where the host's time goes inside the serve loop.

`span(name, **attrs)` marks one step of the loop (`serving/engine.py`,
`core/colocation.py`). Recording is off unless `enable()` holds it on or
a torch profiler records (a traced window): the loop's top spans
(`top`: an admission, a round, the scheduler's pick) switch it to follow
those two before they open, so a traced window records the spans of its
own admissions and rounds and an untraced run records nothing.

Off, `span` returns one shared object after a single test of a module
flag: it allocates nothing and reads no clock. On, each span appends a
`Span` (id, parent id, name, t0 and t1 in ns, attrs) to a list in memory
when it closes; its parent is the span open on the same thread when it
opened. Times are `time.perf_counter_ns()` plus an offset that the switch
on measures, the least `time.time_ns() - time.perf_counter_ns()` over a
few paired reads: the profiler's events are on the Unix-epoch clock in
ns, so the spans can be put against a device trace without being part of
it. The program opens no `record_function` or NVTX range, whose mirror on
the device's timeline a trace would count as device work.

Device marks: while recording, a co-located round with k > 0 on the SM
split records timing-enabled CUDA events (`split_marks`): at the fork,
on the decode partition's stream after decode, and on the unit
partition's stream after each unit. `marks()` holds them, read after the
window (`RoundMarks`).

Switching on drops the last recording's spans and marks.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

_ON = False          # recording: the one test an unrecorded span makes
_HELD = False        # enable() holds recording on
_OFFSET = 0          # time.time_ns() - time.perf_counter_ns()
_SPANS: List[tuple] = []            # closed spans, as Span's fields
_MARKS: List["RoundMarks"] = []
_IDS = itertools.count(1)
_LOCAL = threading.local()


class Span(NamedTuple):
    id: int
    parent: int          # 0: none
    name: str
    t0: int              # ns, Unix epoch
    t1: int
    attrs: Dict


class _Off:
    """What `span` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Open:
    __slots__ = ("id", "parent", "name", "t0", "attrs", "stack")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns() + _OFFSET
        self.stack.pop()
        _SPANS.append((self.id, self.parent, self.name, self.t0, t1,
                       self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Attributes known only once the span's work is done."""
        self.attrs.update(attrs)


def span(name: str, t0: Optional[int] = None, **attrs):
    """A span over a `with` block. t0: its start as the caller read it
    from `time.perf_counter_ns()`, where the caller reads the clock there
    anyway."""
    if not _ON:
        return _OFF
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    s = _Open()
    s.id, s.parent, s.name, s.attrs, s.stack = \
        next(_IDS), stack[-1] if stack else 0, name, attrs, stack
    s.t0 = (time.perf_counter_ns() if t0 is None else t0) + _OFFSET
    stack.append(s.id)
    return s


def top(name: str, t0: Optional[int] = None, **attrs):
    """A span at the top of the serve loop, where no other span is open:
    first switches recording on or off as `enable()` and the profiler
    ask."""
    if _ON != (_HELD or _profiler_enabled()):
        _switch(not _ON)
    return span(name, t0, **attrs)


def _switch(on: bool) -> None:
    global _ON, _OFFSET
    if on:
        _SPANS.clear()
        _MARKS.clear()
        _OFFSET = _clock_offset()
    _ON = on


def _clock_offset(reads: int = 5) -> int:
    """`time.time_ns() - time.perf_counter_ns()`, the least over paired
    reads (a read pair that the scheduler splits only grows it)."""
    best = None
    for _ in range(reads):
        p = time.perf_counter_ns()
        d = time.time_ns() - p
        best = d if best is None else min(best, d)
    return best


def enable() -> None:
    """Record from here on, profiler or not (a new recording)."""
    global _HELD
    _HELD = True
    _switch(True)


def disable() -> None:
    """Stop recording (the spans and marks stay to be read). A profiler
    that still records switches it on again at the next top span."""
    global _HELD
    _HELD = False
    _switch(False)


def enabled() -> bool:
    return _ON


def records() -> List[Span]:
    """The closed spans of the last recording, in the order they closed."""
    return [Span._make(r) for r in _SPANS]


# ------------------------------------------------------------ device --
class RoundMarks:
    """One split round's CUDA events: `fork` on the current stream, then
    one on the decode partition's stream after decode and one on the unit
    partition's stream after each unit (`kinds` beside them)."""

    __slots__ = ("fork", "decode", "units", "kinds")

    def __init__(self) -> None:
        self.fork = torch.cuda.Event(enable_timing=True)
        self.decode: Optional[torch.cuda.Event] = None
        self.units: List[torch.cuda.Event] = []
        self.kinds: List[str] = []

    def after_decode(self) -> None:
        self.decode = torch.cuda.current_stream().record_event(
            torch.cuda.Event(enable_timing=True))

    def after_unit(self, kind: str) -> None:
        self.units.append(torch.cuda.current_stream().record_event(
            torch.cuda.Event(enable_timing=True)))
        self.kinds.append(kind)

    def read(self) -> Tuple[float, float, List[Tuple[str, float]]]:
        """(decode side ms, unit side ms, [(kind, ms)]) from the fork, on
        the device's clock; each unit's ms runs from the mark before it."""
        self.units[-1].synchronize()
        self.decode.synchronize()
        per, prev = [], self.fork
        for kind, ev in zip(self.kinds, self.units):
            per.append((kind, prev.elapsed_time(ev)))
            prev = ev
        return (self.fork.elapsed_time(self.decode),
                self.fork.elapsed_time(self.units[-1]), per)


def split_marks() -> Optional[RoundMarks]:
    """A split round's marks while recording, else None (no event)."""
    if not _ON:
        return None
    m = RoundMarks()
    _MARKS.append(m)
    return m


def marks() -> List[RoundMarks]:
    """The last recording's split rounds that ran units, in order."""
    return [m for m in _MARKS if m.units and m.decode is not None]
