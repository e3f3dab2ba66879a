"""Paged decode attention (K1): the port's plain version against the Pallas
kernel (interpret mode) and its jnp oracle, the dense-cache adapter against
the reference adapter. f32 at 2e-5, bf16 at 2e-2 (as in
tests/test_kernels.py). The CUDA kernel itself is held against the plain
version in tests/test_torch_gpu.py, on a card."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ref import paged_decode_attention_ref  # noqa: E402
from repro_torch.interop import to_numpy, to_torch  # noqa: E402
from repro_torch.kernels import decode_attention as K  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# tests/test_kernels.py's four cases, a g = 7 group and a row of -1 pages
CASES = [
    (2, 8, 2, 64, 32, 4, "float32", "permuted"),
    (3, 4, 4, 32, 16, 3, "float32", "permuted"),
    (1, 16, 1, 128, 64, 2, "float32", "permuted"),   # MQA, hd 128
    (2, 8, 2, 64, 32, 4, "bfloat16", "permuted"),
    (2, 14, 2, 32, 16, 3, "float32", "permuted"),    # g = 7
    (3, 8, 2, 32, 16, 3, "float32", "empty_row"),    # row 1 has no page
]


def _inputs(B, H, KV, hd, ptok, npg, dtype, layout, seed=0):
    rng = np.random.default_rng(seed)
    P = npg * B + 2
    jd = jnp.dtype(dtype)
    q = np.asarray(jnp.asarray(rng.normal(size=(B, H, hd))).astype(jd))
    kp = np.asarray(jnp.asarray(rng.normal(size=(P, ptok, KV, hd))).astype(jd))
    vp = np.asarray(jnp.asarray(rng.normal(size=(P, ptok, KV, hd))).astype(jd))
    pt = rng.permutation(P)[:B * npg].reshape(B, npg).astype(np.int32)
    pt[0, -1] = -1
    lengths = rng.integers(1, npg * ptok, size=(B,)).astype(np.int32)
    if layout == "empty_row":
        pt[1] = -1
    return q, kp, vp, pt, lengths


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


@pytest.mark.parametrize("B,H,KV,hd,ptok,npg,dtype,layout", CASES)
def test_plain_matches_pallas_and_ref(B, H, KV, hd, ptok, npg, dtype, layout):
    q, kp, vp, pt, lengths = _inputs(B, H, KV, hd, ptok, npg, dtype, layout)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pt, lengths)]
    pallas = pallas_decode(*jargs, interpret=True)
    oracle = paged_decode_attention_ref(*jargs)
    before = K.PLAIN_CALLS
    out = K.paged_decode_attention(*to_torch([q, kp, vp, pt, lengths]))
    assert K.PLAIN_CALLS == before + 1           # CPU tensors: plain version
    assert out.dtype == to_torch(q).dtype
    got = np.asarray(to_numpy(out), np.float32)
    for expect in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    if layout == "empty_row":
        assert np.all(got[1] == 0)               # nothing valid -> 0


@pytest.mark.parametrize("S", [128, 160])
def test_dense_adapter_matches_reference(S):
    """At S=160 the reference adapter falls back to its dense oracle; the
    port's adapter still goes through the paged wrapper (one page/slot)."""
    rng = np.random.default_rng(S)
    B, H, KV, hd = 3, 8, 2, 16
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    positions = np.asarray([0, S // 2, S - 1], np.int32)
    kv_pos = np.where(np.arange(S)[None] <= positions[:, None],
                      np.arange(S)[None], -1).astype(np.int32)
    expect = jops.decode_attention(*(jnp.asarray(a) for a in
                                     (q, kc, vc, kv_pos, positions)))
    before = K.PLAIN_CALLS
    got = tops.decode_attention(*to_torch([q, kc, vc, kv_pos, positions]))
    assert K.PLAIN_CALLS == before + 1
    np.testing.assert_allclose(to_numpy(got), np.asarray(expect),
                               atol=2e-5, rtol=2e-5)


def test_adapter_raises_where_the_kernel_does_not_apply():
    kc = torch.zeros(1, 64, 1, 16)
    args = (torch.zeros(1, 2, 16), kc, kc, torch.zeros(1, 64, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):    # a ring is <= window
        tops.decode_attention(*args, window=8)
    with pytest.raises(ValueError, match="no int8 path"):
        tops.decode_attention(*args, scales=(torch.ones(1, 64),) * 2)


def test_wrapper_rejects_bad_inputs():
    q, kp, vp, pt, lengths = to_torch(_inputs(1, 4, 2, 16, 8, 2, "float32",
                                              "permuted"))
    with pytest.raises(TypeError):
        K.paged_decode_attention(q.double(), kp, vp, pt, lengths)
    with pytest.raises(TypeError):
        K.paged_decode_attention(q, kp, vp, pt.long(), lengths)
    with pytest.raises(ValueError):
        K.paged_decode_attention(q[:, :3], kp, vp, pt, lengths)
    with pytest.raises(ValueError):
        K.paged_decode_attention(q, kp, vp[:, :4], pt, lengths)


# The split-KV plan, from the table's width, the (sequence, KV head) pairs
# and a position's K/V bytes alone (the host never reads the lengths):
# splits reading SPLIT_BYTES of K/V, shorter where a full-length grid would
# hold under MIN_CTAS CTAs, longer where it would need over MAX_SPLITS
# splits, each a multiple of the 64-position tile, covering every position
# once.
@pytest.mark.parametrize("n_pages,ptok,pairs,row_bytes,plan", [
    (16, 64, 64, 512, (4, 256)),     # llama3-8b serving: 8 slots x 8 KV heads
    (1, 160, 6, 64, (3, 64)),        # one page per slot (S not a multiple of 64)
    (4, 32, 4, 256, (2, 64)),
    (64, 64, 128, 512, (16, 256)),   # qwen2.5-7b colo-chat: 32 slots, s_max 4096
    (128, 64, 128, 512, (32, 256)),  # qwen2.5-7b decode-long: s_max 8192
    (3, 1000, 8, 512, (24, 128)),    # few pairs: shorter splits fill the card
    (200, 64, 128, 1024, (50, 256)),  # f32: longer, at most MAX_SPLITS
    (1, 8, 1, 64, (1, 64)),
    (0, 64, 8, 512, (1, 64)),        # an empty table still launches one split
    (32, 64, 8, 1024, (32, 64)),     # recurrentgemma-2b: MQA, hd 256, 8 slots
])
def test_split_plan(n_pages, ptok, pairs, row_bytes, plan):
    n_splits, split = K._k1_splits(n_pages, ptok, pairs, row_bytes)
    assert (n_splits, split) == plan
    total = n_pages * ptok
    assert 1 <= n_splits <= K.MAX_SPLITS and split % K.SPLIT_TILE == 0
    assert n_splits * split >= total and (n_splits - 1) * split < max(total, 1)


# The kernel a CUDA call takes, by dtype and shape: every attention family
# the port serves in bf16 is on the tensor cores; f32 and the shapes the
# 16-row MMA tile does not take stay on the CUDA cores.
@pytest.mark.parametrize("dtype,hd,g,path", [
    (torch.bfloat16, 128, 7, "mma"),     # qwen2.5-7b
    (torch.bfloat16, 128, 5, "mma"),     # qwen3-14b
    (torch.bfloat16, 128, 4, "mma"),     # llama3, mixtral, qwen3-8b
    (torch.bfloat16, 80, 4, "mma"),      # h2o-danube
    (torch.bfloat16, 256, 10, "mma"),    # recurrentgemma
    (torch.bfloat16, 96, 1, "mma"),      # phi-3-vision
    (torch.bfloat16, 64, 1, "mma"),      # seamless
    (torch.bfloat16, 16, 16, "mma"),
    (torch.float32, 128, 7, "fma"),      # tensor cores would round to TF32
    (torch.float32, 64, 1, "fma"),
    (torch.bfloat16, 128, 17, "fma"),    # more heads than the tile's rows
    (torch.bfloat16, 40, 2, "fma"),      # hd not in 16-wide steps
])
def test_k1_path_by_dtype_and_shape(dtype, hd, g, path):
    assert K._k1_path(dtype, hd, g) == path


def test_cpu_calls_launch_nothing():
    q, kp, vp, pt, lengths = to_torch(_inputs(2, 8, 2, 64, 32, 4, "bfloat16",
                                              "permuted"))
    before = (K.LAUNCHES, K.LAUNCHES_MMA, K.PLAIN_CALLS)
    K.paged_decode_attention(q, kp, vp, pt, lengths)
    assert (K.LAUNCHES, K.LAUNCHES_MMA, K.PLAIN_CALLS) == \
        (before[0], before[1], before[2] + 1)
