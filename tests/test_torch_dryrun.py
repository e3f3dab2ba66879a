"""The port's dry-run tooling against the reference's.

(a) For every cell of the grid (`cells()`, 34), `specs.make_cell_fn`'s
    stand-ins (meta tensors) equal the reference's arg structs leaf by
    leaf, in shape and dtype; so do the co-located step's trees.
(b) One subprocess imports `repro.launch.dryrun`, which forces 512 host
    devices for itself (importing it here would change every later JAX
    test's device count on this worker), and dumps the reference's values
    for every cell on both production meshes: `pick_strategy`,
    `arg_shardings`, `_analytic_activation_bytes`, and `run_cell`'s
    `model_flops` and parameter counts (its lowering and compile stubbed
    out, its records written under tmp_path, never to `dryrun_results/`).
    The port's values, on the `fake` process group's meshes, are equal.
(c) Unsharded dot FLOPs at smoke size (B 4, S 64): the port's step on
    meta tensors (`step_analysis`) against the reference's compiled step
    (`hlo_analysis.analyze(...).dot_flops`, trip counts applied). Decode
    and prefill are equal for qwen3-8b, mixtral-8x7b, deepseek-v3-671b and
    mamba2-780m, but for mamba2's decode, whose depthwise conv over the
    window the reference writes as an einsum (a dot in the HLO) and the
    port as an elementwise product and an f32 sum: the difference is that
    contraction, exactly. The train step's difference is named and held
    exactly (`_train_gap`) for qwen3-8b, mixtral-8x7b and deepseek-v3-671b
    with all its layers in the scanned stack (MLA, MoE and a shared
    expert): what the port's eager recompute runs that XLA's compiled
    step does not (the flash scores q.k^T, which XLA computes once for
    the checkpoint's recompute and the flash backward; the CE logits,
    recomputed by the chunk's checkpoint; a dense MLP's or a shared
    expert's down projection, whose output the backward never reads),
    less what the reference's scan body runs that autograd skips (the
    first layer's input gradient through the attention's input
    projections). deepseek-v3's unscanned "pre" layer and MTP head, and
    mamba2's train step, are left out: not yet attributed.
(d) On the 2x4 fake mesh the per-device counts are per device: n x the
    per-device FLOPs of a sharded step >= its unsharded FLOPs; a
    hand-made all-gather, reduce-scatter and all-reduce count their result
    sizes; the memory counter's peak on a hand-written function with known
    allocations is exact.
(e) `run_cell("mamba2-780m", "decode_32k", "single")` at full size, into
    tmp_path: ok, with the reference's record keys.

The file takes ~100-150 s alone on an idle 8-core machine.
"""

import dataclasses
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as HA  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.training import peft as JPF  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import colocated_dryrun as CD  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import step_analysis as SA  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = str(Path(__file__).parents[1] / "src")
CELLS = [(a, s) for a, s, _ in tconfigs.cells()]
MESHES = ("single", "multi")


# ------------------------------------------------------- tree helpers ----
def _flat(tree, path=""):
    """{path: leaf} of a tree of either side (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, (SH.Spec, PartitionSpec)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, f"{path}/{i}").items()}
    return {path: tree}


def _sig(leaf):
    """(shape, dtype name) of a stand-in of either side; a host counter of
    the port is the reference's int32 scalar."""
    if isinstance(leaf, int):
        return (), "int32"
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


def _canon(axis):
    if isinstance(axis, tuple):
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


def _spec_tuples(tree):
    """{path: spec as a tuple} of a spec tree of either side."""
    return {p: tuple(_canon(a) for a in s) for p, s in _flat(tree).items()}


_PORT_PARAMS, _REF_PARAMS = SP.param_structs, JSP.param_structs


@lru_cache(maxsize=None)
def _port_params(arch):
    return _PORT_PARAMS(tconfigs.get_config(arch))


@lru_cache(maxsize=None)
def _ref_params(arch):
    return _REF_PARAMS(jconfigs.get_config(arch))


@pytest.fixture
def cached_params(monkeypatch):
    """Both sides' `param_structs` built once per arch (deepseek-v3's take
    ~30 s on the port's side)."""
    monkeypatch.setattr(SP, "param_structs", lambda cfg: _port_params(
        cfg.name))
    monkeypatch.setattr(JSP, "param_structs", lambda cfg: _ref_params(
        cfg.name))


# -------------------------------------------------------- (a) stand-ins --
@pytest.mark.parametrize("arch,shape", CELLS)
def test_stand_ins_match_reference(cached_params, arch, shape):
    _, targs = SP.make_cell_fn(tconfigs.get_config(arch),
                               tconfigs.SHAPES[shape])
    _, jargs = JSP.make_cell_fn(jconfigs.get_config(arch),
                                jconfigs.SHAPES[shape])
    got = {p: _sig(v) for p, v in _flat(targs).items()}
    expect = {p: _sig(v) for p, v in _flat(jargs).items()}
    assert got == expect
    assert all(t.device.type == "meta" for t in tree_leaves(targs)
               if isinstance(t, torch.Tensor))


def test_colocated_trees_match_reference(cached_params):
    """`colocated_dryrun.structs` against the reference's `run` (:46-57)."""
    *_, targs = CD.structs("llama3-8b", "qwen2.5-7b")
    ci, cf = (jconfigs.get_config(a) for a in ("llama3-8b", "qwen2.5-7b"))
    pc = JPF.PeftConfig(micro_batch=2, seq_len=1024, accum=8)
    from repro.training.data import DataConfig, Prefetcher, SyntheticCorpus
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cf.vocab_size, pc.seq_len, pc.micro_batch)).batches(),
        pc.n_stage).stacked()
    tok = jax.ShapeDtypeStruct((128,), np.int32)
    jargs = (JSP.param_structs(ci), JSP.param_structs(cf), tok, tok,
             jax.eval_shape(lambda: JMD.init_cache(ci, 128, 32768)),
             jax.eval_shape(lambda: JPF.init_ft_state(
                 cf, pc, None, jax.random.PRNGKey(0), staged)))
    got = {p: _sig(v) for p, v in _flat(targs).items()}
    expect = {p: _sig(v) for p, v in _flat(jargs).items()}
    assert got == expect


# ------------------------------------- (b) the reference's cell values --
REFERENCE_SCRIPT = r"""
import json, sys, types
from pathlib import Path
from repro.launch import dryrun as D          # forces 512 host devices
import jax
from repro.configs import SHAPES, cells, get_config
from repro.launch import specs as SP
from repro.launch.mesh import make_production_mesh

out_dir = Path(sys.argv[1])
D.RESULTS_DIR = out_dir / "records"

# run_cell without lowering or compiling: what it records beside the
# compiled program's numbers (strategy, model_flops, parameter counts)
class _Compiled:
    def memory_analysis(self):
        return types.SimpleNamespace()
    def cost_analysis(self):
        return {}
    def as_text(self):
        return ""
class _Jitted:
    def __init__(self, *a, **k):
        pass
    def lower(self, *a):
        return types.SimpleNamespace(compile=lambda: _Compiled())
jax.jit = _Jitted
built = {}
param_structs = SP.param_structs


def cached(cfg):
    # deepseek-v3's weights are built once for its six cells
    if cfg.name not in built:
        built[cfg.name] = param_structs(cfg)
    return built[cfg.name]


SP.param_structs = cached

def flat(tree, path=""):
    if isinstance(tree, jax.sharding.PartitionSpec):
        return {path: [list(a) if isinstance(a, tuple) else a for a in tree]}
    if isinstance(tree, dict):
        return {p: s for k in sorted(tree) for p, s in flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree) for p, s in flat(v, f"{path}/{i}").items()}
    raise TypeError(type(tree))

res = {}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=(mk == "multi"))
    for arch, shape, _ in cells():
        cfg, cell = get_config(arch), SHAPES[shape]
        step, args = SP.make_cell_fn(cfg, cell)
        strategy = D.pick_strategy(cfg, cell, mesh)
        rec = D.run_cell(arch, shape, mk, force=True)
        assert rec["ok"], rec.get("traceback")
        res[f"{arch}|{shape}|{mk}"] = {
            "strategy": strategy, "recorded_strategy": rec["strategy"],
            "shardings": flat(D.arg_shardings(cfg, cell.kind, args, mesh,
                                              strategy)),
            "act": D._analytic_activation_bytes(cfg, cell, mesh),
            "model_flops": rec["model_flops"],
            "params_total": rec["params_total"],
            "params_active": rec["params_active"],
            "chips": rec["chips"]}
(out_dir / "reference.json").write_text(json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference_values(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reference")
    script = tmp / "reference_dryrun.py"
    script.write_text(REFERENCE_SCRIPT)
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(script), str(tmp)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "reference.json").read_text())


@pytest.fixture(scope="module")
def fake_meshes():
    """{mesh kind: the port's production DeviceMesh} on the `fake` group."""
    import torch.distributed as dist
    DR.start_fake_group()
    try:
        yield {mk: TM.make_production_mesh(multi_pod=(mk == "multi"),
                                           device_type="cpu")
               for mk in MESHES}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_values_match_reference(reference_values, fake_meshes,
                                     cached_params, arch, shape, mesh_kind):
    expect = reference_values[f"{arch}|{shape}|{mesh_kind}"]
    mesh = fake_meshes[mesh_kind]
    cfg, cell = tconfigs.get_config(arch), tconfigs.SHAPES[shape]
    _, args = SP.make_cell_fn(cfg, cell)
    strategy = DR.pick_strategy(cfg, cell, mesh)
    assert strategy == expect["strategy"] == expect["recorded_strategy"]
    got = _spec_tuples(DR.arg_shardings(cfg, cell.kind, args, mesh,
                                        strategy))
    want = {p: tuple(_canon(tuple(a) if isinstance(a, list) else a)
                     for a in s) for p, s in expect["shardings"].items()}
    assert got == want
    assert DR._analytic_activation_bytes(cfg, cell, mesh) == expect["act"]
    assert DR.model_flops(cfg, cell) == expect["model_flops"]
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (expect["params_total"], expect["params_active"])
    assert mesh.size() == expect["chips"]


# ---------------------------------------------- (c) unsharded FLOPs ----
SMOKE_B, SMOKE_S = 4, 64


def _ref_flops(arch, kind, **over):
    cell = jconfigs.ShapeCell("smoke", SMOKE_S, SMOKE_B, kind)
    cfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
    step, args = JSP.make_cell_fn(cfg, cell)
    return HA.analyze(jax.jit(step).lower(*args).compile().as_text()
                      ).dot_flops


def _port_flops(arch, kind, **over):
    cell = tconfigs.ShapeCell("smoke", SMOKE_S, SMOKE_B, kind)
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    step, args = SP.make_cell_fn(cfg, cell)
    return SA.run_step(step, args)[1].dot_flops


def _conv_contraction(cfg):
    """mamba2's decode conv, in every layer: (B, w, channels) x (w,
    channels) -> (B, channels), a dot of 2 B w channels in the reference's
    HLO."""
    channels = cfg.ssm_dinner + 2 * cfg.ssm_state
    return 2 * SMOKE_B * cfg.ssm_conv_width * channels * cfg.num_layers


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b",
                                  "deepseek-v3-671b", "mamba2-780m"])
def test_serving_flops_match_reference(arch, kind):
    gap = 0
    if arch == "mamba2-780m" and kind == "decode":
        gap = -_conv_contraction(tconfigs.smoke_config(arch))
    assert _port_flops(arch, kind) - _ref_flops(arch, kind) == gap


def _train_gap(cfg):
    """What the port's train step counts beyond the reference's, by name
    (see the module's docstring), for a model whose layers are all in the
    scanned stack: per layer the flash scores q.k^T that XLA computes once
    for the recompute and the backward, and what the recompute runs whose
    output the backward never reads (a dense MLP's or a shared expert's
    down projection and the second product of its LoRA); once the CE
    logits of the chunk's checkpoint; less the first layer's input
    gradient through the attention's input projections, which the
    reference's scan body computes for every layer."""
    B, S, d, r = SMOKE_B, SMOKE_S, cfg.d_model, cfg.lora.rank
    T, H = B * S, cfg.num_heads
    if cfg.mla:
        qk, qr, kr = cfg.mla_nope_dim + cfg.mla_rope_dim, cfg.mla_q_rank, \
            cfg.mla_kv_rank
        first_dx = (2 * T * H * qk * qr + 2 * T * r * qr + 2 * T * qr * d
                    + 2 * T * H * (cfg.mla_nope_dim + cfg.mla_v_dim) * kr
                    + 2 * T * (kr + cfg.mla_rope_dim) * d)
    else:
        qk = cfg.head_dim
        first_dx = 2 * T * d * (H + 2 * cfg.num_kv_heads) * qk \
            + 3 * 2 * T * r * d
    ff = cfg.num_shared_experts * cfg.moe_d_ff if cfg.moe else cfg.d_ff
    down = 0 if cfg.moe and not cfg.num_shared_experts else \
        2 * T * ff * d + (2 * T * r * d if cfg.moe else 0)
    per_layer = 2 * B * H * S * S * qk + down
    ce_logits = 2 * B * (S - 1) * d * cfg.vocab_size
    return cfg.num_layers * per_layer + ce_logits - first_dx


# deepseek-v3 with its layers all in the scanned stack: no "pre" layer
# (which the port's checkpoint recomputes and the reference, which scans
# only the stack, never does) and no MTP head
TRAIN_GAP_CASES = {"qwen3-8b": {}, "mixtral-8x7b": {},
                   "deepseek-v3-671b": {"first_dense_layers": 0,
                                        "mtp": False}}


@pytest.mark.parametrize("arch", list(TRAIN_GAP_CASES))
def test_train_flops_gap_is_named(arch):
    over = TRAIN_GAP_CASES[arch]
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **over)
    gap = _port_flops(arch, "train", **over) - \
        _ref_flops(arch, "train", **over)
    assert gap == _train_gap(cfg) > 0


# ------------------------------------- (d) the counters are per device --
@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_sharded_flops_cover_the_step(fake_meshes, kind):
    """On 2x4, 8 x rank 0's FLOPs >= the unsharded step's (a replicated
    op counts on every rank; a sharded one splits)."""
    mesh = TM.make_debug_mesh(2, 4, device_type="cpu")
    cfg = tconfigs.smoke_config("qwen3-8b")
    cell = tconfigs.ShapeCell("smoke", SMOKE_S, 8, kind)
    step, args = SP.make_cell_fn(cfg, cell)
    whole = SA.run_step(step, args)[1].dot_flops
    strategy = DR.pick_strategy(cfg, cell, mesh)
    laid = DR.lay_out(args, DR.arg_shardings(cfg, kind, args, mesh,
                                             strategy), mesh)
    stats, _, _ = DR.analyzed(
        step, laid, mesh, SH.FSDP_RULES if strategy == "fsdp" else None)
    assert 8 * stats.dot_flops >= whole > stats.dot_flops > 0


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_steps_run_where_heads_split_unevenly(fake_meshes, kind):
    """6 heads on the 2x4 mesh's 4-way model axis (qwen3-14b's 40 on 16
    ways at full size): the heads' reshapes run replicated, and so does
    the train step's backward of the attention output's merge, which
    autograd's own view of the gradient could not split."""
    mesh = TM.make_debug_mesh(2, 4, device_type="cpu")
    cfg = dataclasses.replace(tconfigs.smoke_config("qwen3-8b"),
                              num_heads=6, num_kv_heads=2)
    step, args = SP.make_cell_fn(cfg, tconfigs.ShapeCell(
        "smoke", SMOKE_S, SMOKE_B, kind))
    laid = DR.lay_out(args, DR.arg_shardings(cfg, kind, args, mesh), mesh)
    stats, fallbacks, _ = DR.analyzed(step, laid, mesh)
    assert stats.dot_flops > 0 and "reshape" in fallbacks


def test_collective_bytes_are_result_sizes(fake_meshes):
    """Each collective counts its result: a (16, 32) f32 tensor is 2 KB."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = TM.make_debug_mesh(2, 4, device_type="cpu")
    rep = [Replicate(), Replicate()]
    rows = SH.distribute(torch.empty(16, 32, device="meta"), mesh,
                         SH.Spec("data"))
    partial = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                                 [Replicate(), Partial()], run_check=False)
    cases = {"all-gather": (rows, rep, 16 * 32 * 4),
             "reduce-scatter": (partial, [Replicate(), Shard(0)],
                                4 * 32 * 4),
             "all-reduce": (partial, rep, 16 * 32 * 4)}
    for kind, (x, to, nbytes) in cases.items():
        _, st = SA.run_step(lambda t: t.redistribute(mesh, to), (x,))
        assert st.collective_bytes[kind] == st.collective_total == nbytes
        assert st.collective_counts[kind] == \
            sum(st.collective_counts.values()) == 1


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_memory_counter_is_exact(device):
    """x (64, 32) and w (32, 48) f32 in; a = x @ w and b = 2 a live
    together (24,576 bytes), a freed, b summed to 48 floats out."""
    def fn(x, w, cache):
        a = x @ w
        b = a * 2
        del a
        cache[:, 0] = 1.0               # an input updated in place
        return b.sum(0), cache
    x = torch.zeros(64, 32, device=device)
    w = torch.zeros(32, 48, device=device)
    cache = torch.zeros(8, 4, device=device)
    _, st = SA.run_step(fn, (x, w, cache))
    assert st.argument_bytes == (64 * 32 + 32 * 48 + 32) * 4
    assert st.peak_bytes == 2 * 64 * 48 * 4
    assert st.output_bytes == (48 + 32) * 4
    assert st.alias_bytes == 32 * 4
    assert st.temp_bytes == 2 * 64 * 48 * 4 - 48 * 4
    assert st.resident_bytes == st.argument_bytes + st.peak_bytes
    assert st.dot_flops == 2 * 64 * 32 * 48


# ----------------------------------------------------- (e) one record --
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "kind", "seq_len",
                  "global_batch", "strategy", "ok", "memory", "model_flops",
                  "params_total", "params_active", "wall_s"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes", "resident_bytes",
               "analytic_activation_bytes", "resident_analytic_bytes"}


def test_run_cell_records_a_full_size_cell(fake_meshes, tmp_path):
    rec = DR.run_cell("mamba2-780m", "decode_32k", "single",
                      results_dir=tmp_path, device_type="cpu")
    assert rec.get("ok"), rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    assert rec["chips"] == 256 and rec["device_type"] == "cpu"
    assert json.loads((tmp_path / "mamba2-780m__decode_32k__single.json")
                      .read_text()) == rec
    mem = rec["memory"]
    assert 0 < mem["resident_bytes"] <= mem["hbm_bytes"] and \
        mem["fits_hbm"]
    assert rec["step"]["dot_flops"] > 0
    assert set(rec["step"]["collective_bytes"]) == \
        set(SA.COLLECTIVES) | {"total"}
