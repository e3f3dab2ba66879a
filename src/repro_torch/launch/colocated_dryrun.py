"""Colocated-step dry-run: the paper's signature step at full scale.

Port of `repro/launch/colocated_dryrun.py`: a llama3-8b decode round (bs
128 over a 32k KV cache) followed by k qwen2.5-7b LoRA layer-units, run
once on meta tensors laid out over the production mesh of the `fake`
process group (`dryrun.py` says how) and counted per device
(`step_analysis`). This is the work the Harli scheduler dispatches per
decode round (`core/colocation.py`); running it on the production layouts
shows the co-location technique itself is mesh-coherent, beyond the
per-phase cells. The finetune state is replicated, as in the reference:
it is tiny beside the weights and the cache.

  python -m repro_torch.launch.colocated_dryrun [--k 4] [--mesh single] \
      [--device-type cpu]
Results: dryrun_results_torch/colocated__<inf>__<ft>__k<k>__<mesh>.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.distributed import partitioning as PT
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as MD
from repro_torch.training import peft as PF
from repro_torch.training.data import DataConfig, Prefetcher, SyntheticCorpus

# the decode round's batch and cache length (the reference's record keys)
BS, S_MAX = 128, 32768


def structs(inf_arch: str, ft_arch: str):
    """(cfg_inf, cfg_ft, pc, (params_inf, params_ft, tokens, positions,
    cache, ft_state)): the step's stand-ins, as meta tensors; the finetune
    state's staged data ring is the only thing drawn (the reference
    stages it too)."""
    cfg_inf, cfg_ft = get_config(inf_arch), get_config(ft_arch)
    pc = PF.PeftConfig(micro_batch=2, seq_len=1024, accum=8)
    params_inf = SP.param_structs(cfg_inf)
    params_ft = SP.param_structs(cfg_ft)
    tokens = torch.empty((BS,), dtype=torch.int32, device="meta")
    positions = torch.empty((BS,), dtype=torch.int32, device="meta")
    cache = SP.cache_structs(cfg_inf, BS, S_MAX)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg_ft.vocab_size, pc.seq_len, pc.micro_batch)).batches(),
        pc.n_stage).stacked()
    ft_state = SP.built(lambda: PF.init_ft_state(
        cfg_ft, pc, {"embed": torch.empty(0)}, 0, staged))
    return cfg_inf, cfg_ft, pc, (params_inf, params_ft, tokens, positions,
                                 cache, ft_state)


def run(inf_arch: str, ft_arch: str, k: int, mesh_kind: str,
        results_dir: Path = DR.RESULTS_DIR, device_type: str = "cuda"):
    """The co-located step's record, written to `results_dir`. The default
    process group must cover the mesh (the CLI starts the `fake` group)."""
    cfg_inf, cfg_ft, pc, args = structs(inf_arch, ft_arch)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=device_type)
    params_inf, params_ft, _, _, cache, ft_state = args

    def step(p_inf, p_ft, tok, pos, cache, ft):
        logits, cache = MD.decode_step(p_inf, cfg_inf, tok, pos, cache)
        unit_step = PF.make_unit_step(cfg_ft, pc, p_ft)
        ft = PF.run_units(unit_step, ft, k)
        return logits, cache, ft

    tokspec = DR.token_spec(mesh, BS)
    shardings = (
        PT.param_specs(cfg_inf, params_inf, mesh),
        PT.param_specs(cfg_ft, params_ft, mesh),
        tokspec, tokspec,
        PT.cache_specs(cfg_inf, cache, mesh),
        DR.replicated(ft_state),   # the ft state is tiny: replicate
    )
    t0 = time.time()
    stats, fallbacks, step_s = DR.analyzed(
        step, DR.lay_out(args, shardings, mesh), mesh)
    rec = {
        "kind": "colocated", "inf": inf_arch, "ft": ft_arch, "k": k,
        "mesh": mesh_kind, "chips": mesh.size(), "device_type": device_type,
        "bs": BS, "s_max": S_MAX, "ok": True,
        "step_s": round(step_s, 2),
        "memory": DR.memory_record(stats),
        "step": stats.as_dict(),
        "fallbacks": fallbacks,
        "wall_s": round(time.time() - t0, 2),
    }
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    out = results_dir / \
        f"colocated__{inf_arch}__{ft_arch}__k{k}__{mesh_kind}.json"
    out.write_text(json.dumps(rec, indent=1))
    print(DR.summary(rec))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--inf", default="llama3-8b")
    ap.add_argument("--ft", default="qwen2.5-7b")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--device-type", default="cuda",
                    help="the mesh's device type (cuda, or cpu without a "
                         "card)")
    a = ap.parse_args(argv)
    import torch.distributed as dist
    DR.start_fake_group()
    try:
        run(a.inf, a.ft, a.k, a.mesh, device_type=a.device_type)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
