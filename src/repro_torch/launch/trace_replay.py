"""Paper-scale experiment in one command: replay a Splitwise-like trace
against the cost model of one H100 under the three deployment modes and
print the Fig. 11 comparison (finetune throughput + decode QoS).

    PYTHONPATH=src python -m repro_torch.launch.trace_replay \
        [--duration 120] [--rps 6] [--inf llama3-8b] [--ft llama3-8b] \
        [--qos-ms 40] [--share-base-weights]

The port's counterpart of `examples/trace_replay.py`, with its flags and
its output. Each instance is one NVIDIA H100 (`SimConfig(tp=1)`) priced by
`core/costmodel.py` with the constants fitted on the card
(`H100_CONSTANTS`). The reference runs tp 2, two 16 GB TPU v5e chips, so
that the instance is as tight in memory as the paper's Ada6000; one 80 GB
H100 is the instance the port serves on. The numbers are the cost model's
prediction, not a measurement of the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.simulator import SimConfig, simulate
from repro_torch.serving.request import Request
from repro_torch.serving.trace import TraceConfig, generate

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--rps", type=float, default=6.0)
    ap.add_argument("--inf", default="llama3-8b")
    ap.add_argument("--ft", default="llama3-8b")
    ap.add_argument("--qos-ms", type=float, default=40.0)
    ap.add_argument("--share-base-weights", action="store_true",
                    help="beyond-paper: share the frozen base between "
                         "serving and finetune (same-model pairs)")
    args = ap.parse_args(argv)

    cfg_i, cfg_f = get_config(args.inf), get_config(args.ft)
    base = generate(TraceConfig(duration_s=args.duration, mean_rps=args.rps,
                                seed=1))
    print(f"{len(base)} requests over {args.duration:.0f}s; "
          f"inference={cfg_i.name} finetune={cfg_f.name} "
          f"QoS={args.qos_ms:.0f}ms TPOT\n")
    out = {}
    for mode in ("separate", "static", "harli"):
        reqs = [Request(rid=r.rid, arrival=r.arrival,
                        prompt_len=r.prompt_len,
                        max_new_tokens=r.max_new_tokens) for r in base]
        res = simulate(cfg_i, cfg_f, reqs, SimConfig(
            mode=mode, qos_s=args.qos_ms / 1e3, seed=2, tp=1,
            share_base_weights=args.share_base_weights))
        out[mode] = res
        p50 = np.percentile(res.tpot, 50) * 1e3 if res.tpot else 0
        p99 = np.percentile(res.tpot, 99) * 1e3 if res.tpot else 0
        print(f"{mode:9s} ft_throughput={res.ft_throughput:6.2f} "
              f"(iters/s x batch)  TPOT p50={p50:5.1f}ms p99={p99:5.1f}ms "
              f"QoS-violations={res.qos_violation_frac*100:5.2f}%  "
              f"completed={res.completed}")
    h, s, st = out["harli"], out["separate"], out["static"]
    print(f"\nHarli vs SeparateMode: "
          f"{(h.ft_throughput/max(s.ft_throughput,1e-9)-1)*100:+.1f}% "
          f"finetune throughput (paper: +46.2% avg, +92.0% max)")
    print(f"Harli vs StaticMode:   "
          f"{(h.ft_throughput/max(st.ft_throughput,1e-9)-1)*100:+.1f}% "
          f"(static also violates QoS on "
          f"{st.qos_violation_frac*100:.1f}% of tokens)")
    return out


if __name__ == "__main__":
    main()
