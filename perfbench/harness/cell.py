"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the reference.

Set-up (every part timed, printed on a line of its own): the weights
from the seed on the device; the program's `ServingEngine` (as
`TimedEngine`) at the configuration's slots and the mix's `s_max`. With a
finetune job: its state from the seed's rows and adapters; the
`ColocatedRunner` and its CUDA graphs (decode on the SM split's decode
partition and on the whole card, the units on the unit partition); a copy
of the job's seed state; the predictor fit from `profile_rounds` as
`launch/serve.py` fits it (batch sizes 1, slots / 2 and slots; contexts
s_max / 8, / 4 and / 2; k = 1, k_max / 2 and k_max; two repeats);
`QoSScheduler` at the configuration's target. Without one: the decode
graph. Then the traffic's warm-up, through the same serve loop.

The window: `run_colocated_trace` (co-located cells) or the engine's
`run_trace` (solo cells), the engine admitting requests at their arrival
times (`engine.py`). A traced run starts the profiler at the window's
opening and stops it at its close. At the opening the finetune job is put
back to its seed state (the profile and the warm-up ran units), so the
window's own first three iterations, beside live decode and at the
scheduler's k, are the steps the reference follows: each one's loss, the
first one's gradient and the change after the three are read on the
device as those iterations end.

After the window the peak memory is read, the program's state is freed,
and the reference judges what the window produced (`checks.py`).
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from collections import Counter

from perfbench.harness import checks, spec, traffic
from perfbench.harness import weights as W
from perfbench.harness.engine import TimedEngine
from perfbench.harness.record import Record
from perfbench.harness.trace import Tracer
from perfbench.reference import model as R
from perfbench.roofline import counts
from perfbench.roofline.peaks import BF16_FLOPS, HBM_BYTES

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the finetune state's host counters (its tensors are put back by copy)
HOST_COUNTERS = ("unit_idx", "data_idx", "iter", "consumed")


def log(*a) -> None:
    print(*a, flush=True)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class StepReader:
    """Reads the finetune job's first `steps` iterations as they end: each
    one's loss, the first one's gradient as AdamW got it (its first moment
    over 1 - b1) and the adapters' change after the last, as device
    tensors, read by the host after the window."""

    def __init__(self, ft: Dict, adapters0: Dict, steps: int, b1: float):
        self.ft, self.adapters0 = ft, adapters0
        self.steps, self.b1 = steps, b1
        self.losses: List[torch.Tensor] = []
        self.grad = self.change = None
        self.armed = False

    def __call__(self) -> None:
        ft = self.ft
        if not self.armed or len(self.losses) >= self.steps or \
                ft["iter"] == len(self.losses):
            return
        if ft["iter"] != len(self.losses) + 1:
            raise RuntimeError(f"iteration {ft['iter']} ended before "
                               f"{len(self.losses)} was read")
        self.losses.append(ft["last_loss"].clone())
        if len(self.losses) == 1:
            self.grad = R.leaf_norms(
                {n: {ab: t / (1.0 - self.b1) for ab, t in v.items()}
                 for n, v in ft["opt"]["m"]["scan"].items()})
        if len(self.losses) == self.steps:
            self.change = R.leaf_norms(
                {n: {ab: t - self.adapters0[n][ab] for ab, t in v.items()}
                 for n, v in ft["adapters"]["scan"].items()})

    def read(self) -> Dict:
        if len(self.losses) < self.steps:
            raise RuntimeError(f"the window ended {len(self.losses)} of the "
                               f"{self.steps} finetune iterations that are "
                               "judged")

        def host(tree):
            return {k: v.cpu().numpy() for k, v in tree.items()}
        return {"losses": [float(x) for x in self.losses],
                "grad": host(self.grad), "change": host(self.change)}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", graphs: Optional[bool] = None,
        control: bool = False, rate: Optional[float] = None,
        judge: bool = True) -> Dict:
    """One run; returns the result line's object. `rate` replaces the
    cell's arrival rate and `judge=False` skips the reference (the knee
    sweep, `perfbench/sweep.py`)."""
    from repro_torch.core import graphs as G
    from repro_torch.core.colocation import (ColocatedRunner, fit_predictor,
                                             profile_rounds,
                                             run_colocated_trace)
    from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
    from repro_torch.serving.request import Request
    from repro_torch.training import peft as P
    from repro_torch.training.optimizer import AdamWConfig

    bench = spec.load(root)
    wl = spec.entry(bench, "workloads", workload)
    cj = spec.data(root, "configs", wl["config"])
    mix = spec.data(root, "traffic", wl["traffic"])
    cell = spec.data(root, "cells", workload)
    if rate is not None:
        cell = dict(cell, rate_rps=rate)
    arch, cfg = spec.arch_of(cj), spec.model_config(cj)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    colo = bool(cell.get("colocate"))
    eng_cfg = cj["engine"]
    s_max = int(mix.get("s_max", eng_cfg["s_max"]))
    parts: Dict[str, float] = {}

    def lap(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    parts["start"] = t - t_start
    params = W.make_params(arch, seed, dev)
    if on_card:
        torch.cuda.synchronize()
    t = lap("weights", t)
    eng = TimedEngine(cfg, params, max_slots=int(eng_cfg["max_slots"]),
                      s_max=s_max, use_kernels=True, device=dev,
                      page_tokens=int(eng_cfg.get("page_tokens", 16)),
                      graphs=graphs)
    planned = traffic.generate(mix, cell, seed, seconds, arch.vocab, s_max)
    reqs = [Request(rid=p.rid, arrival=p.arrival, prompt_len=p.prompt_len,
                    max_new_tokens=p.max_new_tokens) for p in planned]
    t = lap("engine", t)
    ft = runner = sched = None
    ftc = cj.get("finetune", {})
    U = tokens_per_iter = 0
    steps = seed_state = None
    if colo:
        oc = ftc["adamw"]
        opt = AdamWConfig(lr=oc["lr"], b1=oc["b1"], b2=oc["b2"],
                          eps=oc["eps"], weight_decay=oc["weight_decay"],
                          grad_clip=oc["grad_clip"],
                          warmup_steps=oc["warmup_steps"])
        pc = P.PeftConfig(micro_batch=ftc["micro_batch"],
                          seq_len=ftc["seq_len"], accum=ftc["accum"],
                          n_stage=ftc["n_stage"], opt=opt)
        if pc.n_stage < ftc["checked_steps"] or pc.accum != 1:
            raise ValueError("the checked steps need a row of their own "
                             "each: n_stage >= checked_steps, accum 1")
        rows = W.make_rows(arch.vocab, pc.n_stage, pc.micro_batch,
                           pc.seq_len, seed)
        ft = P.init_ft_state(cfg, pc, params, 0, rows)
        adapters0 = W.make_adapters(arch, seed, dev)
        if set(adapters0) != set(ft["adapters"]["scan"]):
            raise ValueError("the program adapts other projections than the "
                             "configuration's lora_targets: "
                             f"{sorted(ft['adapters']['scan'])}")
        for n, v in adapters0.items():
            for ab, t0 in v.items():
                ft["adapters"]["scan"][n][ab].copy_(t0)
        runner = ColocatedRunner(cfg, params, cfg, params, pc,
                                 k_max=int(ftc["k_max"]), use_kernels=True,
                                 graphs=graphs, split=True if on_card
                                 else False)
        U = runner.unit_step.total_units
        tokens_per_iter = pc.accum * pc.micro_batch * pc.seq_len
        t = lap("finetune_state", t)
        if runner.graphs:
            runner.precompile(eng.cache, ft)
        t = lap("capture", t)
        # the profile runs units for real: keep the seed state to put back
        seed_state = (G.snapshot(ft), {k: ft[k] for k in HOST_COUNTERS},
                      ft["opt"]["t"])
        t = lap("seed_state", t)
        km, slots = runner.k_max, eng.max_slots
        solo, colo_pts, ft = profile_rounds(
            runner, eng.cache, ft,
            batch_sizes=sorted({1, max(slots // 2, 1), slots}),
            contexts=sorted({s_max // 8, s_max // 4, s_max // 2}),
            ks=sorted({1, max(km // 2, 1), km}), repeats=2)
        steps = StepReader(ft, adapters0, int(ftc["checked_steps"]), opt.b1)
        pred = fit_predictor(km, solo, colo_pts)
        sched = QoSScheduler(pred, SchedulerConfig(qos_s=float(ftc["qos_s"]),
                                                   k_max=km))
        pick = sched.pick

        def timed_pick(*a, **kw):
            from torch.profiler import record_function
            with record_function("perfbench.schedule"):
                d = pick(*a, **kw)
            eng.next_k = d.k
            return d
        sched.pick = timed_pick
        t = lap("profile", t)
        log(f"predictor: {len(solo[1.0])} solo and {len(colo_pts)} "
            f"co-located points, solo mean err "
            f"{pred.report.solo_mean_err:.4f}, colo mean err "
            f"{pred.report.colo_mean_err:.4f}")
    elif eng.graphs:
        eng.precompile()
        t = lap("capture", t)
    tracer = Tracer() if trace else None
    if tracer:
        tracer.warm()
        t = lap("profiler_warm", t)
    snap: Dict[str, float] = {}

    def units_done():
        return 0 if ft is None else ft["iter"] * U + ft["unit_idx"]

    def on_open(now):
        if steps is not None:
            # the job from its seed state: the judged steps are the window's
            G.restore(seed_state[0])
            ft.update(seed_state[1])
            ft["opt"]["t"] = seed_state[2]
            steps.armed = True
        if tracer:
            tracer.start()
        snap["open"] = time.perf_counter()
        snap["tokens0"] = eng.metrics.tokens_out
        snap["units0"] = units_done()
        return snap["open"]

    def on_close(now):
        if tracer:
            tracer.stop()
        snap["close"] = now
        snap["tokens1"] = eng.metrics.tokens_out
        snap["units1"] = units_done()

    eng.arm(planned, float(mix["warmup_s"]), seconds, on_open, on_close,
            ft_state=ft, units_per_iter=U, after_round=steps)
    t_loop = time.perf_counter()
    if colo:
        _, ft = run_colocated_trace(eng, runner, sched, ft, reqs)
    else:
        eng.run_trace(reqs)
    if on_card:
        torch.cuda.synchronize()
    parts["warmup"] = snap["open"] - t_loop
    setup_s = snap["open"] - t_start
    window_s = snap["close"] - snap["open"]
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    o, c = snap["open"], snap["close"]
    rounds = [r for r in eng.rounds if r.t0 >= o and r.t1 <= c]
    adm = [a for a in eng.admissions if a.t0 >= o and a.t1 <= c]
    kinds = {u: runner.unit_step.kind(u) for u in range(U)} if colo else {}
    rec = Record(arch=arch, setup_s=setup_s, window_s=window_s,
                 rounds=rounds, admissions=adm,
                 tokens_out=int(snap["tokens1"] - snap["tokens0"]),
                 units=int(snap["units1"] - snap["units0"]),
                 units_per_iter=U, tokens_per_iter=tokens_per_iter,
                 unit_kinds=kinds,
                 micro_batch=ftc.get("micro_batch", 0),
                 seq_len=ftc.get("seq_len", 0),
                 qos_s=float(ftc["qos_s"]) if colo else None)
    if tracer:
        t = time.perf_counter()
        rec.trace = tracer.summarize()
        log(f"trace summarized in {time.perf_counter() - t:.1f} s")
    del tracer
    log("setup parts (s): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in parts.items()))
    due = [eng.due[p.rid] for p in planned]
    arrived = [p for p, d in zip(planned, due) if o <= d <= c]
    waits = sorted(eng.admissions[i].t0 - eng.admissions[i].due
                   for i in range(len(eng.admissions)))
    waiting = sum(1 for d in due if d <= c) - len(eng.admissions)
    win_waits = [a.t0 - a.due for a in adm]
    half = [a.t0 - a.due for a in adm if a.t0 >= o + window_s / 2]
    log(f"generator: {len(planned)} requests planned, {len(arrived)} due in "
        f"the window, {len(eng.admissions)} admitted in the run; admission "
        f"lateness after the due time: median "
        f"{1e3 * statistics.median(waits) if waits else 0.0:.3f} ms, max "
        f"{1e3 * max(waits) if waits else 0.0:.3f} ms; waiting at the "
        f"window's close: {waiting}")
    ks = Counter(r.k for r in rounds)
    log(f"rounds: {len(rounds)} in the window, by k "
        f"{dict(sorted(ks.items()))}; "
        + (f"over the target: {sum(r.t1 - r.t0 > rec.qos_s for r in rounds)}"
           if colo else "solo"))
    queue = {"waiting_at_close": waiting,
             "lateness_ms_window": 1e3 * statistics.median(win_waits)
             if win_waits else 0.0,
             "lateness_ms_second_half": 1e3 * statistics.median(half)
             if half else 0.0,
             "mean_batch": statistics.mean(len(r.contexts) for r in rounds)
             if rounds else 0.0}
    served = eng.served
    finished = dict(eng.finished)
    metrics = {}
    for m in spec.metrics_for(bench, workload, trace):
        v = spec.reader(root, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = None
    if rec.trace is not None:
        tr = rec.trace
        ops = sorted(tr.op_s.items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:120], s] for n, s in ops],
                     "idle_gaps": sorted(([n, s] for n, s in
                                          tr.idle_s.items()),
                                         key=lambda x: -x[1])[:10]}
        k1s, k1n = tr.device_s("paged_decode")
        k2s, k2n = tr.device_s("lora_matmul")
        k2_calls = sum(len(counts.k2_calls(arch, kinds[u], 1))
                       for r in rounds for u in r.units)
        log(f"trace: window {tr.window_s:.6f} s, busy {tr.busy_s:.6f} s, "
            f"K1 {k1n} kernels {k1s:.6f} s (expected "
            f"{2 * arch.n_layers * len(rounds)}), K2 {k2n} kernels "
            f"{k2s:.6f} s (expected {k2_calls})")

    # ---------------------------------------------------- judge ---------
    dgroup = eng.max_slots
    u_end = units_done()
    prog_steps = steps.read() if steps is not None and judge else None
    del eng, runner, sched, ft, params, steps, seed_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log(f"after freeing the program's state: "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
            f"peak {peak / 1e9:.3f} GB")
    if not judge:
        return {"metrics": metrics, "queue": queue, "peak": peak}
    t_ref = time.perf_counter()
    rng = np.random.default_rng(W.substream(seed, "judge"))
    n_judge = int(mix["judged_requests"])
    if mix["kind"] == "sessions":
        pool = [p.rid for p in planned]
    else:
        pool = [rid for rid, tt in finished.items() if tt >= o]
    if not pool:
        raise RuntimeError("no request finished in the window: nothing to "
                           "judge")
    longest = max(pool, key=lambda rid: len(served[rid]))
    rest = [rid for rid in pool if rid != longest]
    pick = [longest] + [int(x) for x in rng.choice(
        rest, size=min(n_judge - 1, len(rest)), replace=False)]
    by_rid = {p.rid: p for p in planned}
    weights = R.Weights(W.make_params(arch, seed, dev))
    judged = checks.judge_served(
        weights, arch, [(by_rid[r].tokens, served[r]) for r in pick], dgroup,
        dev, control=control)
    numbers = {k: judged[k] for k in ("decode_gap", "decode_gap_mean")}
    extra = {k: v for k, v in judged.items()
             if k not in numbers and k != "per_request"}
    if colo:
        oc = ftc["adamw"]
        opt = R.AdamW(lr=oc["lr"], b1=oc["b1"], b2=oc["b2"], eps=oc["eps"],
                      weight_decay=oc["weight_decay"],
                      grad_clip=oc["grad_clip"],
                      warmup_steps=oc["warmup_steps"])
        rows = {k: torch.as_tensor(v, device=dev) for k, v in W.make_rows(
            arch.vocab, ftc["n_stage"], ftc["micro_batch"], ftc["seq_len"],
            seed).items()}
        tr_nums = checks.judge_training(
            weights, arch, W.make_adapters(arch, seed, dev), rows, opt,
            prog_steps, control=control)
        for k in ("loss_rel", "grad_gap", "change_gap"):
            numbers[k] = tr_nums[k]
        extra.update({k: v for k, v in tr_nums.items() if k not in numbers})
    ref_s = time.perf_counter() - t_ref
    if control:
        # the control in the program's place: its numbers are compared
        for k in list(numbers):
            extra[f"program_{k}"] = numbers[k]
            numbers[k] = extra[f"control_{k}"]
    # the cell's limits name the numbers it compares; the others are
    # printed among the readings
    limits = cell["limits"]
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise ValueError(f"the cell has limits for numbers the run does not "
                         f"make: {missing}")
    extra.update({k: v for k, v in numbers.items() if k not in limits})
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = bool(checked) and all(
        math.isfinite(x["value"]) and x["value"] <= x["limit"]
        for x in checked.values())
    per = judged["per_request"]
    log(f"judged {len(pick)} requests, {int(judged['tokens'])} served "
        f"tokens, in {ref_s:.1f} s (the reference); per request widest gap "
        + ", ".join(f"{g:.5f}" for g in per))
    if extra:
        log("readings " + json.dumps(extra, sort_keys=True))
    bad = forbidden_modules()
    if bad:
        raise RuntimeError("loaded JAX or the JAX package: " + ", ".join(bad))
    devinfo = {"platform": "gpu" if on_card else "cpu",
               "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    if rec.trace is not None:
        devinfo["busy_s"] = rec.trace.busy_s
        devinfo["window_s"] = rec.trace.window_s
    log(f"card: {card()}; peaks {BF16_FLOPS:.4g} FLOP/s bf16, "
        f"{HBM_BYTES:.4g} B/s; window {window_s:.3f} s; units {u_end}")
    out = {"correct": bool(correct),
           "attempted": len(arrived) if mix["kind"] != "sessions"
           else len(planned),
           "failed": sum(g > limits.get("decode_gap", math.inf)
                         for g in per),
           "metrics": metrics, "device": devinfo}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checked
    return out
