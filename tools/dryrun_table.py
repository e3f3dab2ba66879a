#!/usr/bin/env python3
"""The dry-run's records as one Markdown table, a row per cell.

  python3 tools/dryrun_table.py [--results-dir dryrun_results_torch]

Reads the records that `python -m repro_torch.launch.dryrun` writes (and
the co-located ones of `launch/colocated_dryrun.py`) and prints, for each
(arch, shape) and each mesh present: ok, the cell's wall time (s), the
resident GB per device (argument + output + temp - alias), the dot FLOPs
per device, the collective GB per device by kind (all-gather, all-reduce,
reduce-scatter, all-to-all) and the ops run replicated, with the device
type the records name; beside the FLOPs, chips x dot FLOPs per device
over the cell's analytic `model_flops` (how much the mesh computes beyond
6N or 2N per token: attention, recompute, work run replicated). A failed
cell shows its error.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

KINDS = (("all-gather", "AG"), ("all-reduce", "AR"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def cell_text(rec) -> str:
    if not rec.get("ok"):
        return f"FAIL {rec['wall_s']} s: {rec['error'][:80]}"
    coll = rec["step"]["collective_bytes"]
    moved = " ".join(f"{short} {coll[k] / 1e9:.3g}" for k, short in KINDS
                     if coll.get(k))
    fb = ", ".join(f"{k} {v}" for k, v in sorted(rec["fallbacks"].items()))
    flops = rec["step"]["dot_flops"]
    share = f" ({flops * rec['chips'] / rec['model_flops']:.3g}x)" \
        if rec.get("model_flops") else ""
    return (f"ok {rec['wall_s']:.0f} s, {rec['memory']['resident_bytes'] / 1e9:.3g}"
            f" GB, {flops:.3g} FLOP{share}, {moved or '-'}; {fb or '-'}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", type=Path,
                    default=Path(__file__).resolve().parents[1]
                    / "dryrun_results_torch")
    a = ap.parse_args(argv)
    recs = [json.loads(p.read_text())
            for p in sorted(a.results_dir.glob("*.json"))]
    meshes = sorted({r["mesh"] for r in recs}, reverse=True)
    rows = {}
    for r in recs:
        name = f"{r['arch']} x {r['shape']}" if "arch" in r else \
            f"colocated {r['inf']} + {r['ft']} k {r['k']}"
        rows.setdefault(name, {})[r["mesh"]] = r
    kinds = sorted({r.get("device_type") for r in recs} - {None})
    print(f"device type {', '.join(kinds)}; per device: ok, wall, resident,"
          f" dot FLOPs (chips x that / model_flops), collective GB (AG "
          f"all-gather, AR all-reduce, RS reduce-scatter, A2A all-to-all); "
          f"ops run replicated")
    print("| cell | " + " | ".join(meshes) + " |")
    print("|---|" + "---|" * len(meshes))
    for name in sorted(rows):
        print(f"| {name} | " + " | ".join(
            cell_text(rows[name][m]) if m in rows[name] else "not run"
            for m in meshes) + " |")


if __name__ == "__main__":
    main()
