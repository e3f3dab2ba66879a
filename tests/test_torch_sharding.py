"""The port's mesh layout layer against the reference's.

* Layouts: for every shipped config, with and without an int8 KV cache,
  `param_specs`, `fsdp_param_specs`, `adapter_specs` and `cache_specs` of
  the port's own trees (built under `FakeTensorMode`: shapes, no memory)
  equal the reference's of its trees, leaf by leaf, on the production
  meshes 16x16 and 2x16x16 and the debug mesh 2x4. The reference runs on
  `AbstractMesh`; the port on DeviceMeshes of the single-process `fake`
  process group (world 512).
* One start of 8 CPU ranks (gloo, a FileStore under tmp_path; forked from
  one process that has imported the port): the sharded
  train step on a 2x4 mesh against the single-device step for qwen3-8b,
  mixtral-8x7b and mamba2-780m at smoke size, at the reference's
  tolerances (loss 5e-2; adapters atol 5e-3, rtol 5e-2), and the AdamW
  moments of a step with the clip off (which carry the gradient) leaf by
  leaf within 0.1 of each leaf's largest |value|, with the ops that ran
  replicated exactly the expected ones; and a checkpoint restored onto
  (2, 4), then (1, 4), bit-equal to what was saved.
"""

import dataclasses
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import partitioning as JPT  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import partitioning as TPT  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

SRC = str(Path(__file__).parents[1] / "src")
ARCHS = tuple(jconfigs._MODULES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CACHE_BATCH, CACHE_SMAX, CACHE_ENC = 32, 1024, 256


@pytest.fixture(scope="module")
def meshes():
    """{name: (the port's DeviceMesh, the reference's AbstractMesh)}."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        out = {"16x16": TM.make_production_mesh(device_type="cpu"),
               "2x16x16": TM.make_production_mesh(multi_pod=True,
                                                  device_type="cpu"),
               "2x4": TM.make_debug_mesh(2, 4, device_type="cpu")}
        yield {k: (m, AbstractMesh(*MESHES[k])) for k, m in out.items()}
    finally:
        dist.destroy_process_group()


def _flat(tree, path=""):
    """{path: spec as a plain tuple} of a spec tree (either side)."""
    if isinstance(tree, (SH.Spec, PartitionSpec)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: s for i, v in enumerate(tree)
                for p, s in _flat(v, f"{path}/{i}").items()}
    raise TypeError(f"{path}: {type(tree)}")


@lru_cache(maxsize=None)
def _port_weights(arch):
    """The port's params and adapters of the full config, as fake tensors
    (shapes and dtypes only; `kv_quant` changes neither)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = tconfigs.get_config(arch)
    with FakeTensorMode():
        return (TMD.init_params(cfg, 0, device="cpu"),
                TMD.init_adapters(cfg, 0, device="cpu"))


def _port_trees(arch, kv_quant):
    """The config, and the port's params, adapters and cache of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dataclasses.replace(tconfigs.get_config(arch), kv_quant=kv_quant)
    with FakeTensorMode():
        cache = TMD.init_cache(cfg, CACHE_BATCH, CACHE_SMAX,
                               enc_len=CACHE_ENC if cfg.enc_layers else 0,
                               device="cpu")
    return (cfg,) + _port_weights(arch) + (cache,)


@lru_cache(maxsize=None)
def _reference_trees(arch, kv_quant):
    cfg = dataclasses.replace(jconfigs.get_config(arch), kv_quant=kv_quant)
    cache = jax.eval_shape(lambda: JMD.init_cache(
        cfg, CACHE_BATCH, CACHE_SMAX,
        enc_len=CACHE_ENC if cfg.enc_layers else 0))
    return cfg, JSP.param_structs(cfg), JSP.adapter_structs(cfg), cache


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_match_reference(meshes, arch, kv_quant, mesh_name):
    tmesh, jmesh = meshes[mesh_name]
    tcfg, tp, ta, tc = _port_trees(arch, kv_quant)
    jcfg, jp, ja, jc = _reference_trees(arch, kv_quant)
    pairs = {
        "param_specs": (TPT.param_specs(tcfg, tp, tmesh),
                        JPT.param_specs(jcfg, jp, jmesh)),
        "fsdp_param_specs": (TPT.fsdp_param_specs(tcfg, tp, tmesh),
                             JPT.fsdp_param_specs(jcfg, jp, jmesh)),
        "adapter_specs": (TPT.adapter_specs(tcfg, ta, tmesh),
                          JPT.adapter_specs(jcfg, ja, jmesh)),
        "cache_specs": (TPT.cache_specs(tcfg, tc, tmesh),
                        JPT.cache_specs(jcfg, jc, jmesh)),
    }
    for name, (got, expect) in pairs.items():
        assert _flat(got) == _flat(expect), name
    # the layouts are real: some parameter leaf is sharded
    assert any(any(a is not None for a in s)
               for s in _flat(pairs["param_specs"][0]).values())


def test_placements_of_a_spec(meshes):
    """One Shard(dim) per mesh axis a dim names, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = meshes["2x16x16"][0]
    assert SH.placements(mesh, SH.Spec(("pod", "data"), None, "model"),
                         3) == [Shard(0), Shard(0), Shard(2)]
    assert SH.placements(mesh, SH.Spec(None, "data"), 3) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        SH.placements(mesh, SH.Spec(("data", "pod")), 1)


@pytest.mark.parametrize("shape,logical,expect", [
    ((32, 8, 4, 16), ("batch", "expert", None, None), ("S0", "R")),
    ((32, 64, 4, 16), ("batch", "expert", None, None), ("S0", "S1")),
    ((32, 10, 96), ("batch", "seq_sp", None), ("S0", "R")),
    ((3, 16, 96), ("batch", "seq_sp", None), ("R", "S1")),
], ids=["mixtral_experts", "experts", "seq_ragged", "batch_ragged"])
def test_constrain_lays_out_by_rules(meshes, shape, logical, expect):
    """Under `use_mesh` a plain tensor comes back a DTensor laid out by the
    rules, an axis that does not divide its dim dropped (mixtral's 8
    experts on a 16-way axis); without a mesh, the tensor itself."""
    from torch.distributed.tensor import Shard
    x = torch.zeros(shape)
    assert SH.constrain(x, logical) is x
    with SH.use_mesh(meshes["16x16"][0]):
        y = SH.constrain(x, logical)
    got = tuple(f"S{p.dim}" if isinstance(p, Shard) else "R"
                for p in y.placements)
    assert got == expect and tuple(y.shape) == shape


def test_only_named_ops_run_replicated(meshes):
    """A reshape that splits a sharded dim unevenly runs replicated and is
    counted; the same split as a `view`, which is not named, raises."""
    mesh = meshes["16x16"][0]
    x = SH.distribute(torch.zeros(2, 32), mesh, SH.Spec(None, "model"))
    SH.FALLBACKS.clear()
    with SH.use_mesh(mesh):
        assert tuple(x.reshape(2, 2, 16).shape) == (2, 2, 16)
        assert dict(SH.FALLBACKS) == {"reshape": 1}
        with pytest.raises(RuntimeError, match="unevenly sharded"):
            x.view(2, 2, 16)
    assert dict(SH.FALLBACKS) == {"reshape": 1}


def test_kernel_wrappers_refuse_dtensors(meshes):
    """The sharded path keeps the kernels off: a DTensor reaching a
    kernel's wrapper raises, whatever its device."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops as kops
    mesh = meshes["16x16"][0]
    rep = [Replicate()] * 2

    def dt(*shape):
        return DTensor.from_local(torch.zeros(shape), mesh, rep,
                                  run_check=False)
    with pytest.raises(TypeError, match="DTensor"):
        kops.lora_matmul(dt(4, 8), dt(8, 8), dt(8, 2), dt(2, 8), 1.0)
    with pytest.raises(TypeError, match="DTensor"):
        kops.decode_attention(dt(1, 2, 8), dt(1, 4, 1, 8), dt(1, 4, 1, 8),
                              dt(1, 4), dt(1))


def test_mesh_needs_a_world_that_covers_it(meshes):
    with pytest.raises(RuntimeError, match="needs 1024 ranks, have 512"):
        TM.make_debug_mesh(32, 32, device_type="cpu")


# ---------------------------------------------- one spawn of 8 CPU ranks --
SPAWN_SCRIPT = r"""
import json, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("qwen3-8b", "mixtral-8x7b", "mamba2-780m")


def sharded_step(arch, mesh, rank):
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves
    cfg = smoke_config(arch)
    params = MD.init_params(cfg, 0, device="cpu")
    adapters = MD.init_adapters(cfg, 0, device="cpu")
    opt = adamw_init(adapters)
    g = torch.Generator().manual_seed(0)
    B, S = 8, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    specs = PT.param_specs(cfg, params, mesh)
    p_sh = PT.to_named(params, specs, mesh)
    a_sh = PT.to_named(adapters, PT.adapter_specs(cfg, adapters, mesh), mesh)
    o_sh = PT.to_named(opt, PT.adapter_specs(cfg, opt, mesh), mesh)
    b_sh = PT.to_named(batch, PT.batch_specs(batch, mesh), mesh)
    SH.FALLBACKS.clear()
    res = {}
    # the reference's step; then the same with the clip off, whose moments
    # carry the gradient itself (m = 0.1 g, v = 1e-3 g^2 after one step:
    # the clip scales every smoke config's gradient to unit norm, which
    # would hide a gradient wrong by a common factor)
    for clip in (1.0, 0.0):
        step = P.make_train_step(cfg, AdamWConfig(lr=1e-3, grad_clip=clip),
                                 remat=True)
        ref = step(params, adapters, opt, batch)
        with SH.use_mesh(mesh):
            res[clip] = (ref, step(p_sh, a_sh, o_sh, b_sh))
    (ad_ref, _, m_ref), (ad_sh, _, m_sh) = res[1.0]
    ad_sh = [t.full_tensor() for t in tree_leaves(ad_sh)]
    worst = max(float(((a.float() - b.float()).abs()
                       - 5e-2 * b.float().abs()).max())
                for a, b in zip(ad_sh, tree_leaves(ad_ref)))
    # each moment leaf's worst |diff| over its largest |value|, or |diff|
    # where the reference's leaf is all zero (A's, whose grad is 0 while
    # B = 0)
    (_, opt_ref, _), (_, opt_sh, _) = res[0.0]
    moments = {}
    for key in ("m", "v"):
        rel = 0.0
        for a, b in zip(tree_leaves(opt_sh[key]), tree_leaves(opt_ref[key])):
            a = a.full_tensor()
            top = float(b.abs().max())
            diff = float((a - b).abs().max())
            rel = max(rel, diff / top if top > 0 else diff)
        moments[key] = rel
    gn = float(sum(float(x.square().sum())
                   for x in tree_leaves(opt_ref["m"]))) ** 0.5 / 0.1
    sharded = sum(1 for leaf in tree_leaves(p_sh)
                  if leaf.to_local().numel() < leaf.numel())
    return {"loss_ref": float(m_ref["loss"]),
            "loss_sharded": float(m_sh["loss"].full_tensor()),
            "adapter_excess": worst, "m_rel": moments["m"],
            "v_rel": moments["v"], "grad_norm": gn,
            "sharded_leaves": sharded, "fallbacks": dict(SH.FALLBACKS)}


def elastic(mesh_shapes, ckpt_dir, rank):
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves
    cfg = smoke_config("qwen3-8b")
    params = MD.init_params(cfg, 0, device="cpu")
    mgr = CheckpointManager(ckpt_dir)
    if rank == 0:
        mgr.save(1, params)
    dist.barrier()
    out = {}
    for shape in mesh_shapes:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        if rank >= shape[0] * shape[1]:
            continue
        restored = mgr.restore(params, mesh=mesh,
                               specs=PT.param_specs(cfg, params, mesh))
        leaves = tree_leaves(restored)
        out["x".join(map(str, shape))] = {
            "bit_equal": all(torch.equal(a, b.full_tensor())
                             for a, b in zip(tree_leaves(params), leaves)),
            "sharded_leaves": sum(1 for b in leaves
                                  if b.to_local().numel() < b.numel())}
    return out


def run(rank, world, store_path, out_path, ckpt_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    res = {arch: sharded_step(arch, mesh, rank) for arch in ARCHS}
    res["elastic"] = elastic(((2, 4), (1, 4)), ckpt_dir, rank)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # imported once here and forked into the ranks, not imported by each
    # (which keeps the start inside its timeout on a loaded machine); this
    # process runs no tensor op first, so no thread pool is forked
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.distributed import fault_tolerance  # noqa: F401
    from repro_torch.distributed import partitioning  # noqa: F401
    from repro_torch.training import peft  # noqa: F401
    store_path, out_path, ckpt_dir = sys.argv[1:4]
    mp.start_processes(run, args=(8, store_path, out_path, ckpt_dir),
                       nprocs=8, start_method="fork")
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spawn")
    script = tmp / "spawn8.py"
    script.write_text(SPAWN_SCRIPT)
    out = tmp / "result.json"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(script), str(tmp / "store"),
                        str(out), str(tmp / "ckpt")], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0 and out.exists(), r.stderr[-4000:]
    return json.loads(out.read_text())


# the ops that run replicated (`sharding._ReplicatedFallback`) in the step
# of each arch on the 2x4 mesh: qwen3's and mixtral's smoke heads split
# unevenly on the 4-way model axis (reshape), the loss's vocab gather, and
# mixtral's slot plan (the scatters) and dispatch/combine gathers
FALLBACK_OPS = {
    "qwen3-8b": {"reshape", "gather"},
    "mixtral-8x7b": {"reshape", "gather", "scatter_", "scatter_add_",
                     "scatter_reduce_"},
    "mamba2-780m": {"gather"},
}
# a moment leaf's worst |diff| over its largest |value|: the sharded
# step's bf16 reductions in another order give <= 0.03 on these configs;
# a gradient with no all-reduce over the ranks, or half the batch's
# labels changed, gives 0.79-2.2
MOMENT_REL = 0.1


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b", "mamba2-780m"])
def test_sharded_train_step_matches_single_device(spawned, arch):
    r = spawned[arch]
    assert abs(r["loss_ref"] - r["loss_sharded"]) < 5e-2, r
    assert r["adapter_excess"] <= 5e-3, r
    assert r["m_rel"] <= MOMENT_REL and r["v_rel"] <= MOMENT_REL, r
    assert r["grad_norm"] > 0, r
    assert set(r["fallbacks"]) == FALLBACK_OPS[arch], r
    assert r["sharded_leaves"] > 0, r


@pytest.mark.parametrize("shape", ["2x4", "1x4"])
def test_elastic_restore_onto_two_meshes(spawned, shape):
    r = spawned["elastic"][shape]
    assert r["bit_equal"] and r["sharded_leaves"] > 0, r
