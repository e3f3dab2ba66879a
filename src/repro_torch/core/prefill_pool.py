"""Disaggregated prefill pool: TTFT-deadline-aware batched prefill workers.

DistServe (Zhong et al., OSDI'24) shows goodput depends on scaling and
scheduling prefill and decode *independently*; the chained cluster layer
serialized prefill as one chain per decode instance, so TTFT was an artifact
of decode placement. This module makes prefill a scheduled resource of its
own: a pool of workers shares one cluster-wide queue, each worker runs
*fused batched* prefills (``CostModel.prefill_batch_latency`` — token work
additive, weight stream paid once), and the queue is ordered by TTFT
deadline.

Queue ordering ("edf"): earliest *latest-feasible-start* first, i.e.
``arrival + ttft_slo - estimated_prefill_compute``. With a uniform SLO,
textbook EDF over ``arrival + ttft_slo`` degenerates to FIFO; subtracting
each request's own prefill estimate keeps the ordering deadline-aware for
ragged prompts — a long prompt must start earlier than a short one that
arrived just before it to make the same TTFT SLO. Under overload, plain EDF
(and FIFO) burn capacity on requests that can no longer attain their
deadline, so EDF here additionally *demotes doomed requests*: at dispatch
time, a request whose deadline is already infeasible yields to every
still-feasible one (it is served, just last) — the overload behaviour that
actually moves SLO attainment and goodput. "fifo" (strict arrival order) is
kept as the comparison baseline.

Workers mirror decode-instance lifecycle: they can be added at any time,
put into draining (no new batches), and retired once idle — the second
autoscaler control loop (core/autoscaler.py, ``evaluate_prefill``) drives
both transitions against TTFT headroom and queue depth.

Conservation invariant (tested): every submitted request is prefilled
exactly once or still queued — never dropped, never duplicated — and each
worker's completion times are monotone non-decreasing.

The port's own copy of `repro/core/prefill_pool.py` (plain Python and numpy;
keep the two in step), with its names, seeds and arithmetic.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np

from repro_torch.core.costmodel import CostModel
from repro_torch.serving.request import Request

ORDERINGS = ("edf", "fifo")


@dataclasses.dataclass
class PrefillPoolConfig:
    n_workers: int = 2               # pool size at t=0
    max_batch: int = 4               # fused-prefill batch cap per launch
    # token budget per fused launch: prefill is compute-bound past a few
    # hundred tokens (work additive — fusing a long prompt onto an urgent
    # one only delays the urgent one), so only short prompts below the
    # compute/memory crossover are batched, where fusing is ~free and
    # amortizes the weight stream + launch overhead
    max_batch_tokens: int = 512
    ordering: str = "edf"            # "edf" | "fifo"
    wait_window_s: float = 15.0      # recency horizon, TTFT-headroom signal


@dataclasses.dataclass
class PrefillWorker:
    wid: int
    free_at: float = 0.0             # end of the batch currently running
    busy_s: float = 0.0
    n_prefilled: int = 0
    n_batches: int = 0
    draining: bool = False
    last_done: float = 0.0           # monotone per worker (tested)
    # failure layer: prefills whose output KV was later lost to a kill
    # (the request was resubmitted); rids of the batch now running
    n_invalidated: int = 0
    current_batch: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class PrefillPoolSnapshot:
    """Control-loop view of the pool (autoscaler input)."""
    n_workers: int                   # active (non-draining)
    n_draining: int
    queue_depth: int
    backlog_s: float                 # scheduled work beyond `now`, summed
    wait_p99: float                  # recent arrival -> prefill-done waits


class PrefillPool:
    """Shared-queue prefill tier over a mutable set of workers.

    Driven by the cluster event loop: ``submit`` on admission, ``pump``
    once per epoch — it assigns queued requests to free workers in deadline
    order and returns ``(request, ready_time)`` completions for the decode
    stage. A batch started before ``until`` runs atomically and may finish
    past it (same convention as decode rounds)."""

    def __init__(self, cfg: PrefillPoolConfig, cm: CostModel,
                 ttft_slo_s: float = 4.0, t0: float = 0.0):
        assert cfg.ordering in ORDERINGS, cfg.ordering
        assert cfg.n_workers >= 1 and cfg.max_batch >= 1
        self.cfg = cfg
        self.cm = cm
        self.ttft_slo_s = ttft_slo_s
        self.workers: Dict[int, PrefillWorker] = {}
        self.retired: Dict[int, PrefillWorker] = {}
        self.killed: Dict[int, PrefillWorker] = {}   # failure-layer victims
        self._next_wid = 0
        for _ in range(cfg.n_workers):
            self.add_worker(t0)
        # main queue of (order_key, rid, request), heap in key order; a
        # request classified doomed (deadline infeasible) moves to the
        # doomed heap permanently — batch start times are non-decreasing,
        # so doomed-ness is absorbing and each item is classified once
        self._queue: List[Tuple[float, int, Request]] = []
        self._doomed: List[Tuple[float, int, Request]] = []
        # min-arrival tracking with lazy deletion (rid still queued?)
        self._arr_heap: List[Tuple[float, int]] = []
        self._queued_rids: set = set()
        self._submitted: Dict[int, Request] = {}
        self._done: Dict[int, int] = {}            # rid -> worker id
        self._waits: Deque[Tuple[float, float]] = deque()  # (done_t, wait)

    # ------------------------------------------------------------ workers --
    def add_worker(self, now: float = 0.0) -> int:
        w = PrefillWorker(wid=self._next_wid, free_at=now, last_done=now)
        self.workers[w.wid] = w
        self._next_wid += 1
        return w.wid

    def active_workers(self) -> List[PrefillWorker]:
        return [w for w in self.workers.values() if not w.draining]

    def drain_worker(self, min_workers: int = 1) -> int:
        """Mark one worker draining (it finishes its running batch but takes
        no new ones). Picks the soonest-idle worker; refuses to go below
        ``min_workers`` active. Returns the wid, or -1 if refused."""
        cand = self.active_workers()
        if len(cand) <= min_workers:
            return -1
        w = min(cand, key=lambda w: (w.free_at, w.wid))
        w.draining = True
        return w.wid

    def retire_drained(self, now: float) -> List[int]:
        """Move draining workers whose last batch has finished out of the
        pool (they stay visible for accounting)."""
        out = []
        for wid in list(self.workers):
            w = self.workers[wid]
            if w.draining and w.free_at <= now:
                self.retired[wid] = self.workers.pop(wid)
                out.append(wid)
        return out

    def kill_worker(self, wid: int, now: float) -> List[int]:
        """Hard worker failure (cluster failure layer): the worker leaves
        the pool immediately. Returns the rids of the batch it was still
        running at ``now`` — their prefill output dies with the host, so
        the caller must recall them from their decode instances and
        resubmit. Queued work is untouched (the queue is cluster-wide)."""
        w = self.workers.pop(wid)
        w.draining = True
        self.killed[wid] = w
        if w.free_at <= now:
            return []
        return [rid for rid in w.current_batch
                if self._done.get(rid) == wid]

    def has_prefill_record(self, rid: int) -> bool:
        """True when ``rid`` holds a completed-prefill record that must be
        forgotten before the request may be resubmitted."""
        return rid in self._done

    def forget(self, rid: int) -> None:
        """Erase one prefill record after its output KV was lost to a
        failure, so the request can be submitted again. The worker's
        throughput counter keeps the work it did — the conservation audit
        tracks invalidations separately."""
        wid = self._done.pop(rid)
        w = self.workers.get(wid) or self.retired.get(wid) \
            or self.killed.get(wid)
        w.n_invalidated += 1

    def all_workers(self) -> List[PrefillWorker]:
        return list(self.workers.values()) + list(self.retired.values()) \
            + list(self.killed.values())

    # -------------------------------------------------------------- queue --
    def _order_key(self, req: Request) -> float:
        if self.cfg.ordering == "fifo":
            return req.arrival
        # EDF over the latest feasible start time for the TTFT deadline.
        # Costing uses the EFFECTIVE prompt (minus any prefix-cache credit
        # the router granted at admission): a sticky hit genuinely needs
        # less compute, so its deadline is later than raw length suggests.
        return req.arrival + self.ttft_slo_s \
            - self.cm.prefill_latency(req.effective_prompt_len)

    def submit(self, req: Request, now: float) -> None:
        # a genuine double-submit is still an error; a RESUBMIT after a
        # failure is legal once forget() erased the lost prefill record
        assert req.rid not in self._queued_rids \
            and req.rid not in self._done, "request submitted twice"
        self._submitted[req.rid] = req
        heapq.heappush(self._queue, (self._order_key(req), req.rid, req))
        heapq.heappush(self._arr_heap, (req.arrival, req.rid))
        self._queued_rids.add(req.rid)

    def _min_arrival(self) -> float:
        """Earliest arrival among queued requests (doomed included), with
        lazy deletion of already-prefilled entries."""
        while self._arr_heap and self._arr_heap[0][1] not in self._queued_rids:
            heapq.heappop(self._arr_heap)
        assert self._arr_heap, "min_arrival on an empty queue"
        return self._arr_heap[0][0]

    @property
    def queue_depth(self) -> int:
        return len(self._queue) + len(self._doomed)

    def backlog_s(self, now: float) -> float:
        return sum(max(w.free_at - now, 0.0)
                   for w in self.workers.values())

    def wait_p99(self, now: float) -> float:
        """p99 of arrival->prefill-done waits completed within the recency
        horizon — stale spike-era samples must not keep the autoscaler
        growing the pool after the backlog has cleared. Old samples are
        pruned from the front (done times are near-sorted; the residual
        filter keeps the value exact)."""
        lo = now - self.cfg.wait_window_s
        while self._waits and self._waits[0][0] < lo:
            self._waits.popleft()
        recent = [w for t, w in self._waits if t >= lo]
        if not recent:
            return 0.0
        return float(np.percentile(recent, 99))

    def snapshot(self, now: float) -> PrefillPoolSnapshot:
        return PrefillPoolSnapshot(
            n_workers=len(self.active_workers()),
            n_draining=sum(1 for w in self.workers.values() if w.draining),
            queue_depth=self.queue_depth,
            backlog_s=self.backlog_s(now),
            wait_p99=self.wait_p99(now))

    def _select_batch(self, start: float) -> List[Request]:
        """Pop the next fused batch for a worker starting at ``start``:
        requests that have arrived, in queue-key order, feasible ones
        (deadline still attainable) ahead of doomed ones, fused only while
        the batch stays under the token budget — a long prompt fused onto
        an urgent short one would delay the short one for near-zero
        throughput gain (prefill is compute-bound past a few hundred
        tokens). A request found doomed moves to the doomed heap for good
        (batch starts never decrease), so it is classified exactly once."""
        feas: List[Tuple[float, int, Request]] = []
        deferred: List[Tuple[float, int, Request]] = []
        while self._queue and len(feas) < self.cfg.max_batch:
            item = heapq.heappop(self._queue)
            r = item[2]
            if r.arrival > start:
                deferred.append(item)
            elif self.cfg.ordering == "edf" and \
                    start + self.cm.prefill_latency(
                        r.effective_prompt_len) > \
                    r.arrival + self.ttft_slo_s:
                heapq.heappush(self._doomed, item)
            else:
                feas.append(item)
        # budget-bounded prefix in key order; doomed run only when nothing
        # feasible is waiting (they are served, just last)
        batch: List[Request] = []
        tokens = 0
        if feas:
            for i, item in enumerate(feas):
                r = item[2]
                if batch and tokens + r.effective_prompt_len > \
                        self.cfg.max_batch_tokens:
                    deferred.extend(feas[i:])
                    break
                batch.append(r)
                tokens += r.effective_prompt_len
        else:
            while self._doomed and len(batch) < self.cfg.max_batch:
                r = self._doomed[0][2]
                if batch and tokens + r.effective_prompt_len > \
                        self.cfg.max_batch_tokens:
                    break
                heapq.heappop(self._doomed)
                batch.append(r)
                tokens += r.effective_prompt_len
        for item in deferred:
            heapq.heappush(self._queue, item)
        for r in batch:
            self._queued_rids.discard(r.rid)
        return batch

    # --------------------------------------------------------------- pump --
    def pump(self, until: float) -> List[Tuple[Request, float]]:
        """Assign queued requests to free workers up to ``until``. Returns
        ``(request, prefill_done)`` for every batch *started* before
        ``until`` in completion order (ready times may exceed ``until``)."""
        out: List[Tuple[Request, float]] = []
        while self._queue or self._doomed:
            cand = self.active_workers()
            if not cand:
                break
            w = min(cand, key=lambda w: (w.free_at, w.wid))
            # the worker may only start once free AND something has arrived
            start = max(w.free_at, self._min_arrival())
            if start >= until:
                break
            batch = self._select_batch(start)
            assert batch, "free worker with an arrived request found none"
            lat = self.cm.prefill_batch_latency(
                [r.effective_prompt_len for r in batch])
            done = start + lat
            assert done >= w.last_done - 1e-12
            w.free_at = done
            w.last_done = done
            w.busy_s += lat
            w.n_batches += 1
            w.n_prefilled += len(batch)
            w.current_batch = [r.rid for r in batch]
            for r in batch:
                r.prefill_start = start
                r.prefill_done = done
                r.prefill_worker = w.wid
                assert r.rid not in self._done, "request prefilled twice"
                self._done[r.rid] = w.wid
                self._waits.append((done, done - r.arrival))
                out.append((r, done))
        return out

    # --------------------------------------------------------- invariants --
    def check_conservation(self) -> None:
        """Every submitted request is queued xor prefilled-exactly-once,
        and per-worker throughput accounting matches the completion map."""
        queued = {rid for _, rid, _ in self._queue} \
            | {rid for _, rid, _ in self._doomed}
        assert len(queued) == self.queue_depth, "duplicate in queue"
        assert queued == self._queued_rids
        for rid in self._submitted:
            in_q, is_done = rid in queued, rid in self._done
            assert in_q != is_done, \
                f"request {rid} queued={in_q} done={is_done}"
        assert len(queued) + len(self._done) == len(self._submitted)
        per_worker: Dict[int, int] = {}
        for wid in self._done.values():
            per_worker[wid] = per_worker.get(wid, 0) + 1
        for w in self.all_workers():
            # live records + failure-invalidated ones account for every
            # prefill the worker ever ran
            assert per_worker.get(w.wid, 0) + w.n_invalidated \
                == w.n_prefilled
