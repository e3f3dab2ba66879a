"""The ops that the sharded path once ran replicated, partitioned.

`sharding._ReplicatedFallback` ran every `gather` and scatter replicated,
and a reshape that split a sharded heads dim unevenly too: each rank
gathered the whole input. Three call sites did so at full size: the
loss's gold logit (`layers._xent_chunk_sum`), the MoE's slot plan,
dispatch and combine (`moe.py`), and the grouped view of GQA heads that
the model axis does not divide (`layers._flash_fwd`, the K/V
projections). Here:

* On the fake 2x4 mesh (`launch/dryrun.py`'s harness, meta tensors): no
  op runs replicated in the train and prefill steps of qwen3-8b (the loss
  and 2 K/V heads on a 4-way model axis), mixtral-8x7b and
  deepseek-v3-671b (the MoE), on both strategies, and each step's
  resident bytes per device stay under the bound stated beside it (set
  from the reading after the repair, between it and the reading before).
* On 8 gloo ranks (one fork of a process that has imported the port):
  `sharding.gather` in its three layouts (rows split alike, the gathered
  dim split with the index whole, the index split along it with the
  input whole) against the plain gather, values and the input's
  gradient; a scatter run group by group (`sharding.per_group`); an
  in-place scatter into a partial sum, which runs replicated and must
  raise or land in the caller's tensor; and the sharded train step of
  deepseek-v3-671b (TP; in bf16 with its routing pinned to the single
  device's, and in f32) and of qwen3-8b on the FSDP rules against the
  single-device step, at `tests/test_torch_sharding.py`'s tolerances or
  tighter, with no op replicated, and against the same sharded step with
  every gather and scatter run replicated: AdamW's moments bit-equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402

SRC = str(Path(__file__).parents[1] / "src")


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    DR.start_fake_group()
    try:
        yield TM.make_debug_mesh(2, 4, device_type="cuda")
    finally:
        dist.destroy_process_group()


# (arch, kind, strategy, config overrides, B, S) -> the bound on the
# step's resident bytes per device. The loss cases widen the vocabulary
# to 8,192 and the MoE cases lengthen the rows to 256 tokens, so that the
# repaired ops' tensors weigh in the step. Each bound lies between the
# reading before the repair and the reading after it (bytes per device,
# beside each): about a third of the way up from the latter.
CASES = {
    # the loss: each rank held the whole (8, 63, 8,192) f32 chunk logits
    # (the gold logit's gather and DTensor's logsumexp)
    ("qwen3-8b", "train", "tp", (("vocab_size", 8192),), 8, 64):
        12_000_000,         # 52,353,456 / 9,000,384
    ("qwen3-8b", "train", "fsdp", (("vocab_size", 8192),), 8, 64):
        16_000_000,         # 60,315,500 / 11,792,264
    # GQA: 4 heads over 2 K/V heads on the 4-way model axis
    ("qwen3-8b", "prefill", "tp", (), 8, 64):
        600_000,            # 1,534,464 / 463,360
    # the MoE: each rank held every group's (E x C, d) dispatch
    ("mixtral-8x7b", "train", "tp", (), 8, 256):
        6_500_000,          # 19,591,060 / 5,230,740
    ("mixtral-8x7b", "train", "fsdp", (), 8, 256):
        5_700_000,          # 6,797,628 / 5,108,612
    ("mixtral-8x7b", "prefill", "tp", (), 8, 256):
        6_000_000,          # 17,328,768 / 4,721,280
    ("deepseek-v3-671b", "train", "tp", (), 8, 256):
        7_500_000,          # 8,248,732 / 6,902,892
    ("deepseek-v3-671b", "prefill", "tp", (), 8, 256):
        6_600_000,          # 7,277,568 / 6,056,960
}


def _run(mesh, arch, kind, strategy, over, B, S):
    cfg = dataclasses.replace(tconfigs.smoke_config(arch), **dict(over))
    step, args = SP.make_cell_fn(cfg, tconfigs.ShapeCell("smoke", S, B,
                                                         kind))
    laid = DR.lay_out(args, DR.arg_shardings(cfg, kind, args, mesh,
                                             strategy), mesh)
    stats, fallbacks, _ = DR.analyzed(
        step, laid, mesh, SH.FSDP_RULES if strategy == "fsdp" else None)
    return stats, fallbacks


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: "-".join(
    map(str, c[:3])))
def test_no_op_runs_replicated(fake_mesh, case):
    stats, fallbacks = _run(fake_mesh, *case)
    assert fallbacks == {}, fallbacks
    assert 0 < stats.resident_bytes < CASES[case], stats.resident_bytes


# The routed experts' weights are gathered on use (d whole) where they
# move fewer bytes than the product's slots, (E, G·C, d) against (E, d,
# ff): with more slots an expert than the ff width. mixtral-8x7b's cells
# on the single mesh (per device, `launch/dryrun.py`): decode_32k moves
# 0.43 GB a step with its slots moved, 5.94 GB with the weights gathered;
# train_4k held 32.0 GB with the slots moved, 8.23 GB with the weights
# gathered.
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_expert_weights_are_gathered_on_use_where_they_are_smaller(arch):
    from repro_torch.distributed import partitioning as PT
    cfg = tconfigs.get_config(arch)
    assert PT.expert_use_specs(cfg, cfg.moe_d_ff) is None
    use = PT.expert_use_specs(cfg, cfg.moe_d_ff + 1)
    assert use == {"gate": ("expert", None, "ff"),
                   "up": ("expert", None, "ff"),
                   "down": ("expert", "ff", None)}


# A redistribution from Shard(a) to Shard(b) on one mesh dim is an
# all-to-all (`_dtensor.shard_dim_alltoall`). NCCL returns a buffer the
# size of its input; the op's meta kernel, to Shard(0), returns a view of
# a storage the size of the whole group's (mesh size x the local result).
# The counter holds the result at its own size.
@pytest.mark.parametrize("mesh_dim,src,dst", [(1, 1, 0), (0, 2, 0),
                                              (1, 0, 2)])
def test_an_all_to_all_result_counts_its_own_bytes(fake_mesh, mesh_dim, src,
                                                   dst):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import step_analysis as SA
    local = [8, 8, 8]
    local[src] //= fake_mesh.size(mesh_dim)
    before, after = [Replicate()] * 2, [Replicate()] * 2
    before[mesh_dim], after[mesh_dim] = Shard(src), Shard(dst)
    x = DTensor.from_local(torch.empty(local, device="meta",
                                       dtype=torch.bfloat16), fake_mesh,
                           before, run_check=False)
    with SA.analyze((x,)) as a:
        y = x.redistribute(fake_mesh, after).to_local()
        own = y.numel() * y.element_size()
        assert a.live == own == 8 * 8 * 8 * 2 // fake_mesh.size(mesh_dim), \
            (a.live, own, y.untyped_storage().nbytes())
        assert a.stats.collective_bytes["all-to-all"] == own


# ---------------------------------------------- one spawn of 8 CPU ranks --
SPAWN_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def ops(mesh):
    # the partitioned gather in each layout it takes, against the plain op
    # on the full tensors: values, and the input's gradient; a scatter run
    # group by group (`per_group`); and an in-place scatter that runs
    # replicated into a target that holds a partial sum, which must land
    # in the caller's tensor or raise, never write a copy
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed import sharding as SH
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 12, 16, generator=g)
    idx = torch.randint(0, 16, (8, 12, 8), generator=g)
    dy = torch.randn(8, 12, 8, generator=g)
    want = torch.gather(x, 2, idx)
    x_ref = x.clone().requires_grad_()
    (torch.gather(x_ref, 2, idx) * dy).sum().backward()
    layouts = {"rows": (SH.Spec("data", "model"), SH.Spec("data", "model")),
               "gathered_dim": (SH.Spec("data", None, "model"),
                                SH.Spec("data")),
               "index_split_along_dim": (SH.Spec("data"),
                                         SH.Spec("data", None, "model"))}
    res = {}
    SH.FALLBACKS.clear()
    for name, (xs, ids) in layouts.items():
        xd = SH.distribute(x, mesh, xs).detach().requires_grad_()
        dyd = SH.distribute(dy, mesh, ids)
        with SH.use_mesh(mesh):
            got = SH.gather(xd, 2, SH.distribute(idx, mesh, ids))
            (got * dyd).sum().backward()
        res[name] = {"value": float((got.full_tensor() - want).abs().max()),
                     "grad": float((xd.grad.full_tensor()
                                    - x_ref.grad).abs().max()),
                     "layout": str(got.placements)}
    e = idx[..., 0]
    want = torch.zeros(8, 20, dtype=torch.long).scatter_add_(
        1, e, torch.ones_like(e))
    with SH.use_mesh(mesh):
        got, = SH.per_group(lambda el: (torch.zeros(
            el.shape[0], 20, dtype=torch.long).scatter_add_(
                1, el, torch.ones_like(el)),), SH.distribute(e, mesh,
                                                             SH.Spec()))
    res["scatter_add_rows"] = {"value": float((got.full_tensor()
                                               - want).abs().max()),
                               "layout": str(got.placements)}
    res["fallbacks"] = dict(SH.FALLBACKS)
    # each rank holds the whole target divided by the world: a partial sum
    t = torch.randn(8, 20, generator=g)
    src = torch.randn(8, 12, generator=g)
    want = t.clone().scatter_add_(1, e, src)
    td = DTensor.from_local(t / mesh.size(), mesh, [Partial()] * mesh.ndim,
                            run_check=False)
    try:
        with SH.use_mesh(mesh):
            td.scatter_add_(1, SH.distribute(e, mesh, SH.Spec("data")),
                            SH.distribute(src, mesh, SH.Spec("data")))
        raised = False
    except RuntimeError:
        raised = True
    res["scatter_add_partial_target"] = {
        "value": float((td.full_tensor() - want).abs().max()),
        "raised": raised}
    return res


def sharded_step(arch, mesh, fsdp, dtype=torch.bfloat16):
    # the single-device step and the sharded one; a sharded MoE step takes
    # the routing of the single-device step's (the k experts each token's
    # router chose), as a MoE's routing is discontinuous: in bf16 the
    # sharded step's own reduction order flips a few near-tied choices,
    # each of which moves that token's gradient by O(1) (the count of
    # choices that differ is reported)
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    from repro_torch.models import moe as MO
    from repro_torch.training import peft as P
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves
    from torch.distributed.tensor import DTensor, distribute_tensor
    cfg = smoke_config(arch)
    params = MD.init_params(cfg, 0, device="cpu", dtype=dtype)
    adapters = MD.init_adapters(cfg, 0, device="cpu")
    opt = adamw_init(adapters)
    g = torch.Generator().manual_seed(0)
    B, S = 8, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    specs = PT.fsdp_param_specs(cfg, params, mesh) if fsdp else \
        PT.param_specs(cfg, params, mesh)
    p_sh = PT.to_named(params, specs, mesh)
    a_sh = PT.to_named(adapters, PT.adapter_specs(cfg, adapters, mesh), mesh)
    o_sh = PT.to_named(opt, PT.adapter_specs(cfg, opt, mesh), mesh)
    b_sh = PT.to_named(batch, PT.batch_specs(batch, mesh), mesh)
    SH.FALLBACKS.clear()
    step = P.make_train_step(cfg, AdamWConfig(lr=1e-3, grad_clip=0.0),
                             remat=True)
    top_k, routes, at, flips = MO._top_k, [], [0], [0, 0]

    def routed(scores, k):
        w, i = top_k(scores, k)
        if not isinstance(scores, DTensor):
            routes.append(i)
            return w, i
        want = distribute_tensor(routes[at[0]],
                                 scores.device_mesh, i.placements)
        at[0] += 1
        flips[0] += int((torch.sort(i.full_tensor(), -1).values != torch.sort(
            want.full_tensor(), -1).values).any(-1).sum())
        flips[1] += want.full_tensor()[..., 0].numel()
        return SH.gather(scores, -1, want), want
    MO._top_k = routed
    try:
        ad_ref, opt_ref, m_ref = step(params, adapters, opt, batch)
        rules = SH.FSDP_RULES if fsdp else None
        with SH.use_mesh(mesh, rules):
            ad_sh, opt_sh, m_sh = step(p_sh, a_sh, o_sh, b_sh)
        fallbacks = dict(SH.FALLBACKS)
        assert at[0] == len(routes), (at, len(routes))
        route_flips, route_choices = flips
        # the same sharded step with every gather and scatter run
        # replicated, as before their partitioned forms
        saved = SH.gather, SH.per_group
        SH.gather = torch.gather
        SH.per_group = lambda fn, *a: fn(*a)
        at[0] = 0
        try:
            with SH.use_mesh(mesh, rules):
                _, opt_rep, _ = step(p_sh, a_sh, o_sh, b_sh)
        finally:
            SH.gather, SH.per_group = saved
    finally:
        MO._top_k = top_k
    worst = max(float(((a.full_tensor().float() - b.float()).abs()
                       - 5e-2 * b.float().abs()).max())
                for a, b in zip(tree_leaves(ad_sh), tree_leaves(ad_ref)))
    def m_rel(ms, ref):
        rel = 0.0
        for a, b in zip(tree_leaves(ms), tree_leaves(ref)):
            b = b.full_tensor() if hasattr(b, "full_tensor") else b
            top = float(b.abs().max())
            diff = float((a.full_tensor() - b).abs().max())
            rel = max(rel, diff / top if top > 0 else diff)
        return rel
    return {"loss_ref": float(m_ref["loss"]),
            "loss_sharded": float(m_sh["loss"].full_tensor()),
            "adapter_excess": worst, "m_rel": m_rel(opt_sh["m"], opt_ref["m"]),
            "m_rel_replicated": m_rel(opt_sh["m"], opt_rep["m"]),
            "route_flips": route_flips, "route_choices": route_choices,
            "fallbacks": fallbacks}


def run(rank, world, store_path, out_path):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    res = {"ops": ops(mesh),
           "deepseek-v3-671b": sharded_step("deepseek-v3-671b", mesh, False),
           "deepseek-v3-671b-f32": sharded_step(
               "deepseek-v3-671b", mesh, False, torch.float32),
           "qwen3-8b-fsdp": sharded_step("qwen3-8b", mesh, True)}
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # imported once here and forked into the ranks (see
    # tests/test_torch_sharding.py)
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.distributed import partitioning  # noqa: F401
    from repro_torch.training import peft  # noqa: F401
    store_path, out_path = sys.argv[1:3]
    mp.start_processes(run, args=(8, store_path, out_path), nprocs=8,
                       start_method="fork")
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spawn")
    script = tmp / "spawn8.py"
    script.write_text(SPAWN_SCRIPT)
    out = tmp / "result.json"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(tmp / "store"),
                        str(out)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0 and out.exists(), r.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("layout", ["rows", "gathered_dim",
                                    "index_split_along_dim",
                                    "scatter_add_rows"])
def test_local_gathers_and_scatters_equal_the_plain_op(spawned, layout):
    r = spawned["ops"]
    assert r["fallbacks"] == {}, r
    assert r[layout]["value"] == 0.0, r
    assert r[layout].get("grad", 0.0) <= 1e-6, r


def test_in_place_scatter_into_a_partial_sum_never_writes_a_copy(spawned):
    r = spawned["ops"]["scatter_add_partial_target"]
    assert r["raised"] or r["value"] == 0.0, r


# The bounds of tests/test_torch_sharding.py: loss 5e-2; adapters atol
# 5e-3 past rtol 5e-2; AdamW's first moment, which carries the gradient
# with the clip off, within 0.1 of each leaf's largest |value| of the
# single-device step's (deepseek-v3 in bf16 reads 0.037 with its routing
# pinned to the single device's, 0.198 without; qwen3-8b 0.0046). In f32
# the sharded step differs by its reduction order alone: deepseek-v3
# reads 1.9e-6 there, held to 1e-4, where a `sharding.gather` whose
# blocks are not summed reads 0.89 (0.86 in bf16). The routing: in bf16
# the sharded step's own choice differs from the single device's in 16
# of 2,048 (token, layer) choices (0.8 %), in f32 in none; with
# the blocks not summed, in 354-364.
MOMENT_REL = {"deepseek-v3-671b": 0.1, "deepseek-v3-671b-f32": 1e-4,
              "qwen3-8b-fsdp": 0.1}
ROUTE_FLIPS = {"deepseek-v3-671b": 0.02, "deepseek-v3-671b-f32": 0.0,
               "qwen3-8b-fsdp": 0.0}


@pytest.mark.parametrize("name", list(MOMENT_REL))
def test_sharded_train_step_matches_single_device(spawned, name):
    r = spawned[name]
    assert abs(r["loss_ref"] - r["loss_sharded"]) < 5e-2, r
    assert r["adapter_excess"] <= 5e-3, r
    assert r["m_rel"] <= MOMENT_REL[name], r
    assert r["m_rel_replicated"] == 0.0, r
    assert r["route_flips"] <= ROUTE_FLIPS[name] * r["route_choices"], r
    assert r["fallbacks"] == {}, r
