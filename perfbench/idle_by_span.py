#!/usr/bin/env python3
"""One window of a cell, read by the program's own spans: where the
device's idle time falls inside the program, and what the spans cost.

  python3 perfbench/idle_by_span.py --workload qwen2.5-7b.colo-chat \
      --seed 11 --seconds 51 --mode traced

`--mode traced`: the benchmark's traced run (`--trace 1`: the profiler
over the window, the program recording its spans and split rounds'
device marks while it records, the reference's judgement), then lines of
their own: the window's idle seconds by the innermost program span and by
the outermost; each outermost span's idle, with the harness's span around
it, beside the trace's `idle_gaps` bucket (the two clocks' agreement);
the program spans' start after the harness's; the busy share of
admissions; the median idle ms of a round; the split rounds' sides and
the unit kinds' device ms; and the window's kernel counters beside the
trace's kernels.
`--mode spans`: an untraced run with the program's spans held on over the
window (`spans.enable()`), the profiler off: its end-to-end metrics give
the spans' cost beside an untraced run (`run.py --trace 0`). Both print
the span calls' cost in ns first. The last line is one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import cell  # noqa: E402
from perfbench.harness import program_spans as PS  # noqa: E402
from perfbench.harness.engine import TimedEngine  # noqa: E402


def log(*a) -> None:
    print(*a, flush=True)


def span_cost(n: int = 200_000) -> dict:
    """ns per `span()` and per `top()`, off and on (no profiler)."""
    from repro_torch import spans
    out = {}
    for on in (False, True):
        (spans.enable if on else spans.disable)()
        for name, fn in (("span", spans.span), ("top", spans.top)):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with fn("cost", k=1):
                    pass
            out[f"{name}_{'on' if on else 'off'}_ns"] = \
                (time.perf_counter_ns() - t0) / n
        spans.disable()
    return out


def counters() -> dict:
    from repro_torch.core import graphs as G
    from repro_torch.kernels import decode_attention as K1
    from repro_torch.kernels import lora_matmul as K2
    return {"k1_launches": K1.LAUNCHES, "k2_launches": K2.LAUNCHES,
            "captures": G.CAPTURES}


def run(root: Path, workload: str, seed: int, seconds: float, mode: str,
        device: str = "cuda", tracer=PS.SpanTracer) -> dict:
    """One window in `mode` ("traced" or "spans"); returns its readings.
    `tracer`: the traced window's `SpanTracer` (a CPU one in tests)."""
    from repro_torch import spans
    box = {}
    at = {}

    def make_tracer():
        box["tracer"] = tracer()
        return box["tracer"]

    arm = TimedEngine.arm

    def armed(self, planned, warmup_s, secs, on_open, on_close, **kw):
        def opened(now):
            at["open"] = counters()
            if mode == "spans":
                spans.enable()
            return on_open(now)

        def closed(now):
            on_close(now)
            if mode == "spans":
                spans.disable()
            at["close"] = counters()
        return arm(self, planned, warmup_s, secs, opened, closed, **kw)

    cell.Tracer, TimedEngine.arm = make_tracer, armed
    try:
        out = cell.run(root, workload, seed, seconds, mode == "traced",
                       T_START, device=device,
                       graphs=None if device == "cuda" else False)
    finally:
        cell.Tracer, TimedEngine.arm = PS.Tracer, arm
    recs = spans.records()
    moved = {k: at["close"][k] - at["open"][k] for k in at["open"]}
    names = {}
    for s in recs:
        names[s.name] = names.get(s.name, 0) + 1
    res = {"correct": out["correct"],
           "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "spans": names, "counters": moved}
    log("spans: " + json.dumps(names, sort_keys=True))
    sides = [m.read() for m in spans.marks()]
    if sides:
        res["split"] = {
            "rounds": len(sides),
            "decode_ms": statistics.median(d for d, _, _ in sides),
            "units_ms": statistics.median(u for _, u, _ in sides),
            "units_set_round": PS.units_set_round(
                [(d, u) for d, u, _ in sides]),
            "unit_ms_by_kind": PS.unit_ms_by_kind(
                [p for _, _, per in sides for p in per])}
        log("split rounds: " + json.dumps(res["split"], sort_keys=True))
    if mode != "traced":
        log("counters (window): " + json.dumps(moved, sort_keys=True))
        return res
    tr = box["tracer"]
    sm = tr.summary
    _, k1n = sm.device_s("paged_decode")
    _, k2n = sm.device_s("lora_matmul")
    log(f"counters (window): {json.dumps(moved, sort_keys=True)}; trace: "
        f"K1 {k1n} kernels, K2 {k2n} kernels")
    res["trace_kernels"] = {"k1": k1n, "k2": k2n}
    res["idle_gaps"] = sm.idle_s
    inner = PS.idle_by_span(tr.window, tr.busy, recs, tr.host)
    outer = PS.idle_by_span(tr.window, tr.busy, recs, tr.host, top=True)
    res["idle_by_span"] = inner
    res["idle_by_top_span"] = outer
    log("idle by program span (s): " + json.dumps(
        dict(sorted(inner.items(), key=lambda kv: -kv[1]))))
    log("idle by outermost span (s): " + json.dumps(
        dict(sorted(outer.items(), key=lambda kv: -kv[1]))))
    clocks = {}
    for span_name, bucket in (("engine.round", "round"),
                              ("engine.admit", "admit")):
        # the harness's span holds the program's and a little of its own
        mine = outer.get(span_name, 0.0)
        rest = outer.get("perfbench." + bucket, 0.0)
        theirs = sm.idle_s.get(bucket, 0.0)
        clocks[span_name] = [mine, rest, theirs]
        gap = 100 * (mine + rest - theirs) / theirs if theirs else 0.0
        log(f"clocks: idle under {span_name} {mine:.6f} s, in the "
            f"harness's span outside it {rest:.6f} s, sum {mine + rest:.6f}"
            f" s, trace's {bucket} {theirs:.6f} s ({gap:+.3f} %)")
    res["clocks"] = clocks
    lead = lead_us(recs, tr.host)
    res["span_lead_us"] = lead
    log("program span start after the harness's span around it (us, "
        "median): " + json.dumps(lead, sort_keys=True))
    rounds = PS.idle_per_span_ms(tr.busy, recs, "engine.round")
    res["span_metrics"] = {
        "admit_busy": PS.busy_share(tr.busy, recs, "engine.admit"),
        "round_idle_ms": statistics.median(rounds) if rounds else None}
    log("span metrics: " + json.dumps(res["span_metrics"], sort_keys=True))
    return res


def lead_us(recs, host) -> dict:
    """Median us from each harness span's start to the program's span
    inside it (>= 0 on one clock, as the nesting says)."""
    pairs = {"perfbench.round": "engine.round",
             "perfbench.admit": "engine.admit"}
    starts = {n: sorted(s.t0 for s in recs if s.name == n)
              for n in pairs.values()}
    out = {}
    for hname, pname in pairs.items():
        leads = []
        mine = starts[pname]
        j = 0
        for h0, h1, n in host:
            if n != hname:
                continue
            while j < len(mine) and mine[j] < h0:
                j += 1
            if j < len(mine) and mine[j] <= h1:
                leads.append((mine[j] - h0) / 1e3)
        if leads:
            out[pname] = statistics.median(leads)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--mode", choices=("traced", "spans"), default="traced")
    args = ap.parse_args()
    cost = span_cost()
    log("span cost (ns a call): " + json.dumps(cost, sort_keys=True))
    res = run(ROOT, args.workload, args.seed, args.seconds, args.mode)
    res["span_cost_ns"] = cost
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "mode": args.mode, **res}), flush=True)


if __name__ == "__main__":
    main()
