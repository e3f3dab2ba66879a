"""The benchmark's clock around the program's serving engine.

`TimedEngine` is the program's `ServingEngine` with three methods
wrapped. `try_admit` and `decode_round` keep their own work and are timed
by the host clock (each ends in a copy of its tokens to the host, which
waits for the device), and what they emit is recorded: the first token
of an admission, every token of a round, the lengths a round's slots fed
and, in a co-located round, the finetune units it ran. Each runs inside a
`torch.profiler.record_function` span ("perfbench.admit",
"perfbench.round"), which a traced run reads.

`run_trace` is replaced: the program's admits requests as soon as slots
free and ignores their arrival times. This one admits each request when
its arrival time has come (in arrival order, while a slot is free), and
runs rounds until the window has closed: it opens `warmup_s` after the
start of the arrivals, or after the admission of every request due at
time 0 where there are such, at a round boundary, and closes at the
first boundary `seconds` after that. It calls `round_fn` as the program's does (the
co-located serve loop passes its round), else `decode_round`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
from torch.profiler import record_function

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Phase, Request


@dataclasses.dataclass
class Round:
    t0: float
    t1: float
    k: int                    # finetune units the round ran
    units: List[int]          # their indices in the iteration
    emitted: int              # tokens emitted
    lengths: List[int]        # K1's length per slot (positions + 1)
    contexts: List[int]       # the active slots' contexts


@dataclasses.dataclass
class Admission:
    t0: float
    t1: float
    prompt_len: int
    due: float                # the host time the request was due


class TimedEngine(ServingEngine):
    def arm(self, planned, warmup_s: float, seconds: float,
            on_open: Callable[[float], float],
            on_close: Callable[[float], None], ft_state=None,
            units_per_iter: int = 0,
            after_round: Optional[Callable[[], None]] = None) -> None:
        """The run's requests (`traffic.Planned`) and window. on_open(now)
        returns the time the window opens (after its own work);
        after_round() runs after each round's tokens are recorded."""
        self.planned = {p.rid: p for p in planned}
        self.warmup_s, self.seconds = warmup_s, seconds
        self.on_open, self.on_close = on_open, on_close
        self.ft_state, self.units_per_iter = ft_state, units_per_iter
        self.after_round = after_round
        self.next_k = 0
        self.rounds: List[Round] = []
        self.admissions: List[Admission] = []
        self.served: Dict[int, List[int]] = {}
        self.finished: Dict[int, float] = {}
        self.due: Dict[int, float] = {}
        self.opened: Optional[float] = None
        self.closed: Optional[float] = None

    # ----------------------------------------------------------- wraps --
    def try_admit(self, req: Request, prompt_tokens: np.ndarray,
                  extras=None) -> bool:
        t0 = time.perf_counter()
        with record_function("perfbench.admit"):
            ok = super().try_admit(req, prompt_tokens, extras)
        if ok:
            self.admissions.append(Admission(t0, time.perf_counter(),
                                             req.prompt_len,
                                             self.due.get(req.rid, t0)))
            self.served[req.rid] = [int(self.last_token[req.slot])]
        return ok

    def decode_round(self, step=None):
        active = self.active_requests()
        contexts = [self.context(r.slot) for r in active]
        lengths = [1] * self.max_slots
        for r, c in zip(active, contexts):
            lengths[r.slot] = min(c, self.cache_len)
        k = self.next_k if step is not None else 0
        units = []
        if k and self.ft_state is not None:
            u0 = self.ft_state["unit_idx"]
            units = [(u0 + j) % self.units_per_iter for j in range(k)]
        self.next_k = 0
        t0 = time.perf_counter()
        with record_function("perfbench.round"):
            out = super().decode_round(step)
        t1 = time.perf_counter()
        if active:
            self.rounds.append(Round(t0, t1, k, units, len(out), lengths,
                                     contexts))
        for rid, tok in out.items():
            self.served[rid].append(tok)
        for r in active:
            if r.phase == Phase.DONE:
                self.finished[r.rid] = t1
        if self.after_round is not None:
            self.after_round()
        return out

    # ------------------------------------------------------------- run --
    def run_trace(self, reqs: List[Request], vocab=None,
                  max_rounds: int = 10 ** 9, round_fn=None):
        pending = sorted(reqs, key=lambda r: r.arrival)
        n_zero = sum(r.arrival == 0.0 for r in pending)
        if n_zero > self.max_slots:
            raise ValueError(f"{n_zero} requests are due at time 0 and the "
                             f"engine has {self.max_slots} slots")
        start = time.perf_counter()
        for r in pending:
            self.due[r.rid] = start + r.arrival
        open_at = None if n_zero else start + self.warmup_s
        qi, rounds = 0, 0
        while rounds < max_rounds:
            now = time.perf_counter()
            while qi < len(pending) and self.due[pending[qi].rid] <= now:
                r = pending[qi]
                if not self.try_admit(r, self.planned[r.rid].tokens):
                    break
                qi += 1
                now = time.perf_counter()
            if open_at is None and qi >= n_zero:
                open_at = now + self.warmup_s
            if self.opened is None and now >= open_at:
                self.opened = self.on_open(now)
            elif self.opened is not None and \
                    now >= self.opened + self.seconds:
                self.closed = now
                self.on_close(now)
                break
            if not self.active_requests():
                target = open_at if self.opened is None else \
                    self.opened + self.seconds
                if qi < len(pending):
                    target = min(target, self.due[pending[qi].rid])
                time.sleep(max(0.0, target - now))
                continue
            (round_fn or self.decode_round)()
            rounds += 1
        return self.metrics
