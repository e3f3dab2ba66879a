"""Decode on a sequence-sharded cache (`sharding.write_slots`).

`partitioning.cache_specs` lays a KV cache out with its batch on "data"
and its sequence on "model", and DTensor refuses the one-token in-place
`index_put_` on that layout. `write_slots` writes it block by block: each
rank writes the tokens whose slot falls in its own sequence range.

* On one device `write_slots` is the `index_put_` the cache writes were
  before, bit for bit, and the decode write still equals the reference's
  `.at[].set`.
* One start of 8 CPU ranks (gloo, a FileStore under tmp_path; forked from
  one process that has imported the port, in a subprocess with its own
  timeout): `write_slots` on a laid-out buffer equals the plain write bit
  for bit on every rank; and a smoke decode step (two tokens after a
  prefill) on the 2x4 mesh, its cache laid out by `cache_specs` and its
  tokens and positions by the dry-run's `token_spec`, against the
  single-device step, for qwen3-8b, deepseek-v3-671b (the MLA latent
  cache), h2o-danube-1.8b past its window (rings) and qwen3-8b with an
  int8 cache (`kv_quant`). The steps run in f32 (weights and caches), so
  that the sharded step's other summation order stays far inside the
  reference's sharded-step bounds (atol 5e-3, rtol 5e-2): in bf16 the
  same steps differ by up to 0.06 in a logit, the partial sums of a
  row-sharded product rounded to bf16 before their all-reduce. Every slot
  the decode did not write is bit-equal after `full_tensor()` on every
  rank, kv_pos bit-equal everywhere. The written slots hold k/v that the
  sharded projections summed in another order, so they are not bit-equal
  (the write itself is, above): they are held within `WRITE_REL` of
  their leaf's largest |value| (the f32 steps read at most 8.2e-7; a
  value rounded to bf16 before the write is ~4e-3 off), an int8 code
  within one step. The ops run replicated are the expected set per
  model, with no `index_put_` among them.
* In the same start, `constrain` on the MoE's transposed expert layout
  of a partial sum, forward and backward, runs no op replicated and
  equals the single-device step.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

SRC = str(Path(__file__).parents[1] / "src")


def _index_put(buf, slots, values):
    """The cache write as it was before `write_slots`."""
    bidx = torch.arange(buf.shape[0])[:, None]
    buf[bidx, slots] = values.to(buf.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.int32])
def test_single_device_write_is_the_index_put(dtype):
    g = torch.Generator().manual_seed(3)
    buf = torch.randn(4, 16, 2, 8, generator=g).mul(40).to(dtype)
    slots = torch.randint(0, 16, (4, 1), generator=g)
    values = torch.randn(4, 1, 2, 8, generator=g).mul(40).to(dtype)
    scale = torch.randn(4, 16, 2, generator=g).to(dtype)
    scale_values = torch.randn(4, 1, 2, generator=g).to(dtype)
    expect, expect_scale = buf.clone(), scale.clone()
    _index_put(expect, slots, values)
    _index_put(expect_scale, slots, scale_values)
    SH.write_slots({"k": buf, "k_scale": scale}, slots,
                   {"k": values, "k_scale": scale_values})
    assert torch.equal(buf, expect) and torch.equal(scale, expect_scale)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_write_matches_reference(quantized):
    """`_cache_write_bulk` (decode's write, now through `write_slots`)
    against the reference's `.at[].set` on a ring, token after token."""
    jcfg, tcfg = jsmoke("qwen3-8b"), smoke_config("qwen3-8b")
    W, B = 16, 3
    rng = np.random.default_rng(7)
    cj = JA.make_cache(jcfg, B, W, jnp.float32, window=W,
                       quantized=quantized)
    ct = TA.make_cache(tcfg, B, W, torch.float32, "cpu", window=W,
                       quantized=quantized)
    for p in range(W + 5):
        shape = (B, 1, tcfg.num_kv_heads, tcfg.head_dim)
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        pos = np.full((B, 1), p, np.int32)
        cj = JA._cache_write_bulk(cj, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(pos), W)
        TA._cache_write_bulk(ct, *to_torch((k, v, pos)), W)
    for name, t in ct.items():
        assert torch.equal(t, to_torch(np.asarray(cj[name]))), name


# ---------------------------------------------- one spawn of 8 CPU ranks --
SPAWN_SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# name -> (arch, kv_quant, prompt tokens, s_max): danube's smoke window is
# 64, so its rings hold 64 slots and a 70-token prompt wraps them
CASES = {"qwen3-8b": ("qwen3-8b", False, 20, 64),
         "deepseek-v3-671b": ("deepseek-v3-671b", False, 20, 64),
         "h2o-danube-1.8b": ("h2o-danube-1.8b", False, 70, 96),
         "qwen3-8b-int8": ("qwen3-8b", True, 20, 64)}
B, STEPS = 4, 2


def clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def all_ranks(flag):
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def write_check(mesh):
    # write_slots on a (batch on data, sequence on model) buffer against
    # the plain write, two tokens a row, slots in every rank's range
    from repro_torch.distributed import sharding as SH
    g = torch.Generator().manual_seed(5)
    buf = torch.randn(4, 64, 2, 8, generator=g)
    slots = torch.randint(0, 64, (4, 2), generator=g)
    slots[:, 1] = (slots[:, 0] + 17) % 64
    values = torch.randn(4, 2, 2, 8, generator=g)
    sh = SH.distribute(buf.clone(), mesh, SH.Spec("data", "model"))
    SH.write_slots({"k": buf}, slots, {"k": values})
    with SH.use_mesh(mesh):
        SH.write_slots({"k": sh}, slots, {"k": values})
    return all_ranks(torch.equal(sh.full_tensor(), buf))


def constrain_check(mesh):
    # the MoE's expert layout (`moe._constrain_ecf`) of a partial sum: a
    # transposed activation laid out anew, then flattened twice, forward
    # and backward, against the same step on one device
    from repro_torch.distributed import sharding as SH
    E, G, C, F, f = 32, 8, 6, 8, 12
    g = torch.Generator().manual_seed(9)
    h0 = torch.randn(E, G * C, F, generator=g)
    d0 = torch.randn(E, F, f, generator=g)

    def step(h, d):
        t = torch.bmm(h, d).reshape(E, G, C, f).transpose(0, 1)
        t = SH.constrain(t, ("batch", "expert", None, None))
        z = t.transpose(0, 1).reshape(E, G * C, f)
        z = z.reshape(E, G, C, f).transpose(0, 1).reshape(G, E * C, f)
        return (z * z).sum()
    h, d = (t.clone().requires_grad_() for t in (h0, d0))
    loss = step(h, d)
    loss.backward()
    ref = (loss.detach(), h.grad, d.grad)
    SH.FALLBACKS.clear()
    with SH.use_mesh(mesh):
        h = SH.distribute(h0, mesh, SH.Spec("data", None, "model"))
        d = SH.distribute(d0, mesh, SH.Spec("data", "model", None))
        h.requires_grad_()
        d.requires_grad_()
        loss = step(h, d).full_tensor()
        loss.backward()
    got = (loss.detach(), h.grad.full_tensor(), d.grad.full_tensor())
    return {"rel": [float((a - b).abs().max() / a.abs().max())
                    for a, b in zip(ref, got)],
            "fallbacks": dict(SH.FALLBACKS)}


def case(name, mesh):
    from repro_torch.configs import smoke_config
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import token_spec
    from repro_torch.models import model as MD
    from repro_torch.tree import tree_leaves
    arch, kvq, P, s_max = CASES[name]
    cfg = dataclasses.replace(smoke_config(arch), kv_quant=kvq)
    params = MD.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    cache = MD.init_cache(cfg, B, s_max, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           dtype=torch.int32)
    logits, cache = MD.prefill(params, cfg, {"tokens": prompt}, cache)
    ref = clone(cache)
    sh = PT.to_named(clone(cache), PT.cache_specs(cfg, cache, mesh), mesh)
    p_sh = PT.to_named(params, PT.param_specs(cfg, params, mesh), mesh)
    spec = token_spec(mesh, B)
    tok = logits.argmax(-1).to(torch.int32)
    SH.FALLBACKS.clear()
    excess = 0.0
    written = []
    for s in range(STEPS):
        pos = torch.full((B,), P + s, dtype=torch.int32)
        l_ref, _ = MD.decode_step(params, cfg, tok, pos, ref)
        with SH.use_mesh(mesh):
            l_sh, _ = MD.decode_step(p_sh, cfg,
                                     SH.distribute(tok, mesh, spec),
                                     SH.distribute(pos, mesh, spec), sh)
        l_sh = l_sh.full_tensor()
        excess = max(excess, float(((l_sh - l_ref).abs()
                                    - 5e-2 * l_ref.abs()).max()))
        written.append(P + s)
        tok = l_ref.argmax(-1).to(torch.int32)
    fallbacks = dict(SH.FALLBACKS)
    paths = tree_leaves(PT._walk(ref, lambda p, t: p))
    leaves = {}
    for path, a, b in zip(paths, tree_leaves(ref), tree_leaves(sh)):
        b = b.full_tensor()
        seq = 2 if path.startswith("scan") else 1
        n = a.shape[seq]
        # the slots the decode wrote (a ring's p % n)
        hit = torch.zeros(n, dtype=torch.bool)
        hit[[p % n for p in written]] = True
        hit = hit.reshape((1,) * seq + (n,) + (1,) * (a.ndim - seq - 1))
        rest_equal = torch.equal(torch.where(hit, 0, a),
                                 torch.where(hit, 0, b))
        d = (a.float() - b.float()).abs()
        leaves[path] = {
            "rest_equal": all_ranks(rest_equal),
            "equal": all_ranks(torch.equal(a, b)),
            "max_diff": float(d.max()),
            "max_abs": float(a.float().abs().max())}
    return {"logit_excess": excess, "cache": leaves,
            "fallbacks": fallbacks}


def run(rank, world, store_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    res = {"write_slots": write_check(mesh),
           "constrain": constrain_check(mesh)}
    res.update({name: case(name, mesh) for name in CASES})
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # imported once here and forked into the ranks; this process runs no
    # tensor op first, so no thread pool is forked
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.launch import dryrun  # noqa: F401
    from repro_torch.models import model  # noqa: F401
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
                       timeout=150, env=env)
    assert r.returncode == 0 and out.exists(), r.stderr[-4000:]
    return json.loads(out.read_text())


def test_write_slots_on_a_laid_out_buffer(spawned):
    assert spawned["write_slots"] is True


def test_constrain_lays_out_a_transposed_activation(spawned):
    """`constrain` redistributes a contiguous tensor and makes its gradient
    contiguous: a redistribution leaves a contiguous local shard under
    its input's global strides, and without either repair DTensor then
    refuses a later reshape's local view (forward or backward), which
    runs replicated, gathering the whole activation."""
    r = spawned["constrain"]
    assert r["fallbacks"] == {}, r
    assert max(r["rel"]) <= 1e-5, r


# the ops that run replicated in each decode step on the 2x4 mesh: none.
# qwen3's and danube's smoke k/v heads, which split unevenly on the 4-way
# model axis, are gathered before their reshape (`sharding.even_split`),
# and deepseek's MoE slot plan, dispatch and combine run on the shards
# (`sharding.per_group`, `sharding.gather`)
FALLBACK_OPS = {
    "qwen3-8b": set(),
    "deepseek-v3-671b": set(),
    "h2o-danube-1.8b": set(),
    "qwen3-8b-int8": set(),
}


# the written slots' bound, relative to their leaf's largest |value|
WRITE_REL = 1e-5


@pytest.mark.parametrize("name", list(FALLBACK_OPS))
def test_sharded_decode_matches_single_device(spawned, name):
    r = spawned[name]
    assert r["logit_excess"] <= 5e-3, r
    assert set(r["fallbacks"]) == FALLBACK_OPS[name], r
    assert not any(op.startswith("index_put") for op in r["fallbacks"])
    for path, leaf in r["cache"].items():
        assert leaf["rest_equal"], (path, leaf)
        if path.endswith("kv_pos"):
            assert leaf["equal"], (path, leaf)
        elif path.endswith(("/k", "/v")) and name.endswith("int8"):
            # int8 codes: a value on a rounding boundary may move by one
            assert leaf["max_diff"] <= 1.0, (path, leaf)
        else:
            assert leaf["max_diff"] <= WRITE_REL * leaf["max_abs"], \
                (path, leaf)
