"""Multi-pod dry-run: every (arch x shape x mesh) cell's step, run on meta
tensors laid out over the production mesh.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
cell's step for 512 host placeholder devices and reads the compiled
program. The port has no compiler to ask: it lays each cell's stand-ins
(`specs.make_cell_fn`: meta tensors, no memory) out as DTensors over the
production mesh of the single-process `fake` process group (world 512,
`torch.testing._internal.distributed.fake_pg`), runs the step once under
`sharding.use_mesh` and counts it per device (`step_analysis`: matmul
FLOPs, collective bytes by kind, argument / output / alias / temp bytes).
That proves the distribution config is coherent without hardware, as the
reference's compile does: every op of the step runs on its layouts, or
runs replicated by name (`sharding.FALLBACKS`, recorded, whose gathers the
collective bytes count).

  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k \
      --mesh single --device-type cpu
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
Results: dryrun_results_torch/<arch>__<shape>__<mesh>[__kvq].json, an
incremental cache (never the reference's `dryrun_results/`, whose records
its tests hold to a TPU's memory).

The CLI starts the `fake` group; importing this module starts nothing.
`--device-type` names the mesh's device type: "cuda" by default, as every
entry point of the port runs on the card unless asked, "cpu" on a machine
without one. The record keeps it: on a "cpu" mesh DTensor runs an
all-to-all as an all-gather and a chunk (the CPU group has none), so the
collective counts are not NCCL's there. A record holds the reference's
keys where the port has a counterpart; in place of the lowering and
compile times it holds the step's wall time (`step_s`), in place of the
HLO statistics the step's (`step`), and its resident bytes are held to the
H100's memory (`hw.H100_SXM.hbm_bytes`), not a TPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.distributed import partitioning as PT
from repro_torch.distributed import sharding as SH
from repro_torch.hw import H100_SXM
from repro_torch.launch import specs as SP
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results_torch"
FAKE_WORLD = 512


def _analytic_activation_bytes(cfg, cell, mesh) -> int:
    """Per-device activation watermark (the reference's arithmetic, on the
    port's `_plan`). Conservative: working-set terms use x4 headroom."""
    names = SH.mesh_sizes(mesh)
    dp = names.get("data", 1) * names.get("pod", 1)
    tp = names.get("model", 1)
    B, S, d = cell.global_batch, cell.seq_len, cfg.d_model
    V = cfg.vocab_size
    from repro_torch.models.model import _plan
    _, _, n_scan, _ = _plan(cfg)
    dp_eff = dp if B % dp == 0 else 1
    sp_eff = tp if S % tp == 0 else 1
    tok_sp = B * S / dp_eff / sp_eff       # fully sharded token count
    tok_dp = B * S / dp_eff                # dp-sharded only
    if cell.kind == "decode":
        # one-token round: scores + per-layer workset (cache is in args)
        ctx = cfg.effective_cache_len(S)
        scores = (B / dp_eff) * cfg.num_heads * (ctx / sp_eff) * 4
        return int(4 * scores + 8 * (B / dp_eff) * d * 4 + 2 ** 28)
    work = 4 * tok_sp * d * 2 * 4          # per-layer transient (x4 slack)
    if cfg.moe:
        cf = cfg.capacity_factor
        xe = cfg.top_k * cf * tok_dp / tp * (d + cfg.moe_d_ff) * 2
        work += 3 * xe
    if cell.kind == "prefill":
        return int(work + 2 ** 28)
    # train: remat carries + flash bwd accumulators + CE logits
    carries = (n_scan + 1) * tok_sp * d * 2
    flash = 2 * (B / dp_eff) * cfg.effective_cache_len(S) \
        * cfg.num_kv_heads * cfg.head_dim * 4
    vshard = tp if V % tp == 0 else 1
    # CE is fused+chunked (layers.chunked_softmax_xent): per-chunk logits
    ce = 2 * (B / dp_eff) * 256 * (V / vshard) * 4
    return int(carries + 2 * work + flash + ce + 2 ** 28)


# -------------------------------------------------------------- shardings --
def pick_strategy(cfg, cell, mesh) -> str:
    """Per-cell sharding strategy: LoRA train steps whose global batch
    covers the whole mesh go pure-FSDP (no per-layer activation
    collectives). MoE archs join when the per-layer weight gather is
    affordable (mixtral: 2.8 GB/layer; deepseek-v3: 22.5 GB/layer -> EP
    stays)."""
    n_dev = mesh.size()
    if cell.kind == "train" and cell.global_batch % n_dev == 0:
        layer_bytes = cfg.param_count() / max(cfg.num_layers, 1) * 2.0
        if not cfg.moe or layer_bytes < 4e9:
            return "fsdp"
    return "tp"


def replicated(tree):
    """A spec tree that replicates every leaf of `tree`."""
    return tree_map(lambda _: SH.Spec(), tree)


def arg_shardings(cfg, cell_kind, args, mesh, strategy: str = "tp"):
    """Spec trees matching make_cell_fn's arg order."""
    axes = PT.MeshAxes()
    if cell_kind == "train":
        params, adapters, opt, batch = args
        if strategy == "fsdp":
            return (PT.fsdp_param_specs(cfg, params, mesh),
                    PT.adapter_specs(cfg, adapters, mesh, axes),
                    replicated(opt),
                    _walk_batch_fsdp(batch, mesh))
        return (PT.param_specs(cfg, params, mesh, axes),
                PT.adapter_specs(cfg, adapters, mesh, axes),
                replicated(opt),
                PT.batch_specs(batch, mesh, axes))
    if cell_kind == "prefill":
        params, batch, cache = args
        return (PT.param_specs(cfg, params, mesh, axes),
                PT.batch_specs(batch, mesh, axes),
                PT.cache_specs(cfg, cache, mesh, axes))
    params, tokens, positions, cache = args
    tokspec = token_spec(mesh, tokens.shape[0])
    return (PT.param_specs(cfg, params, mesh, axes), tokspec, tokspec,
            PT.cache_specs(cfg, cache, mesh, axes))


def token_spec(mesh, batch: int):
    """The decode tokens' and positions' layout: batch on the data axes."""
    return SH.Spec(SH._fit(mesh, batch, PT.MeshAxes().present(mesh).dp))


def _walk_batch_fsdp(batch, mesh):
    axes = ("pod", "data", "model")
    present = tuple(a for a in axes if a in mesh.mesh_dim_names)

    def spec(path, leaf):
        dims = [None] * leaf.ndim
        if leaf.ndim >= 1 and leaf.shape[0] % SH._axis_size(
                mesh, present) == 0:
            dims[0] = present
        return SH.Spec(*dims)

    return PT._walk(batch, spec)


def lay_out(args, specs, mesh):
    """Each arg tree laid out as DTensors by its spec tree."""
    return tuple(PT.to_named(a, s, mesh) for a, s in zip(args, specs))


def model_flops(cfg, cell) -> float:
    """The analytic workload (6N or 2N per token) of a cell."""
    n_active = cfg.active_param_count()
    tokens = cell.global_batch * cell.seq_len
    if cfg.enc_layers:
        # enc-dec: seq splits enc/dec halves; the (frozen) encoder is
        # forward-only in PEFT training
        d, ff = cfg.d_model, cfg.d_ff
        per_attn = 4 * d * cfg.num_heads * cfg.head_dim
        n_enc = cfg.enc_layers * (per_attn + 3 * d * ff + 2 * d)
        n_dec = n_active - n_enc
        if cell.kind == "train":
            return (6.0 * n_dec + 2.0 * n_enc) * tokens / 2
        if cell.kind == "prefill":
            return 2.0 * n_active * tokens / 2
        return 2.0 * n_dec * cell.global_batch
    if cell.kind == "train":
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch


def analyzed(step, args, mesh, rules=None):
    """(StepStats, fallbacks, wall seconds) of one step run under the mesh
    and the counters."""
    SH.FALLBACKS.clear()
    t0 = time.time()
    with SH.use_mesh(mesh, rules=rules):
        _, stats = SA.run_step(step, args)
    return stats, dict(SH.FALLBACKS), time.time() - t0


def memory_record(stats, act=None) -> dict:
    """The record's memory: the step's per-device bytes held to the H100's
    memory, and with `act` (the analytic activation watermark) the
    reference's analytic resident sum."""
    mem = stats.memory()
    if act is not None:
        weights_cache = (stats.argument_bytes + stats.output_bytes
                         - stats.alias_bytes)
        mem["analytic_activation_bytes"] = int(act)
        mem["resident_analytic_bytes"] = int(weights_cache + act)
    mem["hbm_bytes"] = int(H100_SXM.hbm_bytes)
    mem["fits_hbm"] = mem["resident_bytes"] <= H100_SXM.hbm_bytes
    return mem


# ---------------------------------------------------------------- one cell --
def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             kv_quant: bool = False, results_dir: Path = RESULTS_DIR,
             device_type: str = "cuda"):
    """One cell's record, written to `results_dir` (and read from it unless
    `force`). The default process group must cover the mesh: the CLI
    starts the `fake` group of 512 ranks."""
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    suffix = "__kvq" if kv_quant else ""
    out_path = results_dir / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    if out_path.exists() and not force:
        print(f"[skip] {out_path.name} (cached)")
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    cell = SHAPES[shape]
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "kind": cell.kind, "seq_len": cell.seq_len,
           "global_batch": cell.global_batch, "device_type": device_type}
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type=device_type)
        rec["chips"] = mesh.size()
        step, args = SP.make_cell_fn(cfg, cell)
        strategy = pick_strategy(cfg, cell, mesh)
        rec["strategy"] = strategy
        args = lay_out(args, arg_shardings(cfg, cell.kind, args, mesh,
                                           strategy), mesh)
        stats, fallbacks, step_s = analyzed(
            step, args, mesh, SH.FSDP_RULES if strategy == "fsdp" else None)
        rec.update({
            "ok": True,
            "step_s": round(step_s, 2),
            # per-device buffer sizes (proves the H100's memory holds it)
            "memory": memory_record(stats, _analytic_activation_bytes(
                cfg, cell, mesh)),
            # per-device matmul FLOPs and collectives
            "step": stats.as_dict(),
            # the ops run replicated by name, whose gathers `step` counts
            "fallbacks": fallbacks,
            "model_flops": model_flops(cfg, cell),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
        })
    except Exception as e:  # record failures — they are bugs to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    rec["wall_s"] = round(time.time() - t0, 2)
    out_path.write_text(json.dumps(rec, indent=1))
    print(summary(rec))
    return rec


def summary(rec) -> str:
    """One line: status, wall time and, for an ok record, the resident GB
    per device, dot FLOPs, collective bytes by kind and the fallbacks."""
    name = " x ".join(str(rec.get(k)) for k in ("arch", "shape", "mesh")) \
        if "arch" in rec else f"colocated {rec['inf']}+{rec['ft']} " \
        f"k={rec['k']} {rec['mesh']}"
    head = f"[{'ok' if rec.get('ok') else 'FAIL'}] {name} ({rec['wall_s']}s)"
    if not rec.get("ok"):
        return f"{head}\n  {rec['error']}"
    mem, st = rec["memory"], rec["step"]
    coll = {k: v for k, v in st["collective_bytes"].items() if v}
    return (f"{head} resident {mem['resident_bytes'] / 1e9:.3f} GB/device "
            f"of {mem['hbm_bytes'] / 1e9:.0f}, dot {st['dot_flops']:.4g} "
            f"FLOP/device, collectives {coll} B, fallbacks "
            f"{rec['fallbacks']}")


def start_fake_group(world: int = FAKE_WORLD) -> None:
    """The single-process `fake` process group of `world` ranks (rank 0):
    collectives return without moving data, so one process runs rank 0's
    part of a step laid out over the whole mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache variant (writes __kvq.json)")
    ap.add_argument("--device-type", default="cuda",
                    help="the mesh's device type (cuda, or cpu without a "
                         "card)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = []
    if args.all:
        for arch, shape, skip in cells(include_skipped=True):
            if skip:
                print(f"[SKIP-CELL] {arch} x {shape}: {skip}")
                continue
            todo += [(arch, shape, mk, False) for mk in meshes]
    else:
        todo = [(args.arch, args.shape, mk, args.kv_quant) for mk in meshes]
    import torch.distributed as dist
    start_fake_group()
    ok = fail = 0
    try:
        for arch, shape, mk, kvq in todo:
            rec = run_cell(arch, shape, mk, args.force, kv_quant=kvq,
                           device_type=args.device_type)
            ok += bool(rec.get("ok"))
            fail += not rec.get("ok")
    finally:
        dist.destroy_process_group()
    print(f"done: {ok} ok, {fail} failed")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
