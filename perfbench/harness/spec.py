"""Finds a run's parts by the names in BENCHMARK.json.

  perfbench/configs/<config>.json   the configuration, as it is run
  perfbench/traffic/<traffic>.json  the traffic mix's parameters
  perfbench/cells/<workload>.json   the cell's own: its rate, whether a
                                    finetune job is co-located, and the
                                    limits of the numbers compared
  perfbench/metrics/<metric>.py     one reader per metric

A later cell, configuration, mix or metric is a new file of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

from perfbench.reference.model import Arch


def load(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(bench: Dict, key: str, name: str) -> Dict:
    for e in bench[key]:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")


def data(root: Path, kind: str, name: str) -> Dict:
    return json.loads((root / "perfbench" / kind / f"{name}.json").read_text())


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: the end-to-end ones without
    tracing, the per-layer ones with it; each where its `workloads` list
    names the cell, or has none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(root: Path, name: str) -> Callable:
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch_of(cj: Dict) -> Arch:
    """The reference's sizes from a configuration file (keys as in the
    source's config.json)."""
    moe = "num_local_experts" in cj
    ft = cj.get("finetune", {})
    return Arch(d=cj["hidden_size"], n_layers=cj["num_hidden_layers"],
                n_heads=cj["num_attention_heads"],
                n_kv=cj["num_key_value_heads"],
                head_dim=cj["hidden_size"] // cj["num_attention_heads"],
                ff=cj["intermediate_size"], vocab=cj["vocab_size"],
                rope_theta=float(cj["rope_theta"]),
                eps=float(cj["rms_norm_eps"]), moe=moe,
                n_experts=cj.get("num_local_experts", 0),
                top_k=cj.get("num_experts_per_tok", 0),
                moe_ff=cj["intermediate_size"] if moe else 0,
                capacity_factor=float(cj["port"].get("capacity_factor",
                                                     1.25)),
                window=int(cj["port"].get("window", 0)),
                lora_rank=ft.get("lora_rank", 0),
                lora_alpha=float(ft.get("lora_alpha", 0.0)),
                lora_targets=tuple(ft.get("lora_targets", ())))


def model_config(cj: Dict):
    """The program's `ModelConfig` of a configuration file."""
    from repro_torch.models.config import LoRAConfig, ModelConfig
    a = arch_of(cj)
    port = cj["port"]
    return ModelConfig(
        name=cj["name"], family=port["family"], num_layers=a.n_layers,
        d_model=a.d, num_heads=a.n_heads, num_kv_heads=a.n_kv,
        d_ff=a.ff, vocab_size=a.vocab, head_dim=a.head_dim,
        attn_type=port["attn_type"], window=a.window,
        rope_theta=a.rope_theta, norm_eps=a.eps, moe=a.moe,
        num_experts=a.n_experts, top_k=a.top_k, moe_d_ff=a.moe_ff,
        capacity_factor=a.capacity_factor,
        tie_embeddings=bool(cj["tie_word_embeddings"]),
        lora=LoRAConfig(rank=a.lora_rank or 16, alpha=a.lora_alpha or 32.0,
                        targets=a.lora_targets or ("q", "k", "v", "o")))
