"""Paged GQA flash-decode attention: the decode-phase hot-spot kernel (K1).

`paged_decode_attention` launches the hand-written CUDA kernel in
`csrc/decode_attention.cu` (the port of the Pallas kernel
`repro/kernels/decode_attention.py::_kernel`) for CUDA tensors, and uses
`paged_decode_attention_plain`, the plain torch version beside it, only for
CPU tensors. The kernel is built at first launch (`kernels/build.py`).

`_k1_path` picks the kernel before the launch, from the dtype and the
shape alone: bf16 with hd a multiple of 16 and g <= MMA_GROUP goes to the
tensor-core kernel (the g heads of a KV head are the n side of mma.sync
tiles), f32 and every other bf16 shape to the CUDA-core kernel. Each call
counts once in `LAUNCHES`, and the tensor-core calls in `LAUNCHES_MMA` too.

Both kernels split each sequence's positions across CTAs (flash-decoding):
`_k1_splits` picks the number of splits and their length from the table's
width, the batch's (sequence, KV head) pairs and a position's K/V bytes
alone, so the wrapper never reads `lengths` on the host (that would
synchronise every layer of every round). The wrapper allocates an f32
workspace for the partials, and a call makes two device launches (the
splits, then their combination).

Layout:
  q           (B, H, hd)
  k/v pages   (P, ptok, KV, hd)      one layer's pool
  page_table  (B, n_pages) int32     physical page per logical block, -1 = skip
  lengths     (B,) int32             tokens valid per sequence
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# Counts of kernel launches and of plain-version calls made by the wrapper,
# so that a run can show which path it took. Reset by assigning 0.
LAUNCHES = 0
LAUNCHES_MMA = 0        # the calls that took the tensor-core kernel
PLAIN_CALLS = 0
# A CUDA graph that captured calls adds their launches to these at every
# replay (`core/graphs.py`).
COUNTERS = ("LAUNCHES", "LAUNCHES_MMA", "PLAIN_CALLS")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_BYTES = 128 * 1024  # K and V bytes of its KV head a split reads, at least
MIN_CTAS = 264          # two CTAs on each of an H100's 132 SMs
SPLIT_TILE = 64         # split lengths are multiples of the MMA kernel's tile
MAX_SPLITS = 64         # the combine kernel's limit
MAX_GROUP_DIMS = 4096   # g * hd: the CUDA-core kernel's accumulators of a CTA
MMA_GROUP = 16          # g: two 8-head n tiles of the MMA kernel


def _k1_path(dtype: torch.dtype, hd: int, g: int) -> str:
    """The kernel a CUDA call launches: "mma" (bf16 on tensor cores: hd in
    16-wide steps, the g heads within two 8-wide n tiles) or "fma" (the
    CUDA-core kernel: f32, whose products tensor cores would round to TF32,
    and bf16 shapes the tile does not take)."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and g <= MMA_GROUP:
        return "mma"
    return "fma"


def _k1_splits(n_pages: int, ptok: int, pairs: int, row_bytes: int) -> tuple:
    """(n_splits, split_tokens) for a table of n_pages pages of ptok
    positions, `pairs` (sequence, KV head) pairs and `row_bytes` K and V
    bytes per position of one KV head: splits that read SPLIT_BYTES, shorter
    where a grid of full-length sequences would hold fewer than MIN_CTAS
    CTAs, longer where there would be more than MAX_SPLITS; always a
    multiple of SPLIT_TILE positions."""
    def tiles(n):           # n positions, rounded up to whole tiles
        return max(1, -(-n // SPLIT_TILE)) * SPLIT_TILE
    total = n_pages * ptok
    want = -(-MIN_CTAS // max(pairs, 1))     # splits a sequence would need
    split = tiles(-(-SPLIT_BYTES // row_bytes))
    split = min(split, tiles(-(-total // want)))
    split = max(split, tiles(-(-total // MAX_SPLITS)))
    return max(1, -(-total // split)), split


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    args = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + \
        [ctypes.c_float, ctypes.c_void_p]
    lib.repro_paged_decode_attention.argtypes = args
    lib.repro_paged_decode_attention.restype = ctypes.c_int
    lib.repro_paged_decode_attention_mma.argtypes = args[:7] + args[8:]
    lib.repro_paged_decode_attention_mma.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 scale: Optional[float] = None):
    """Dense gather + softmax in f32 (the reference's `ref.py` oracle)."""
    B, H, hd = q.shape
    _, ptok, KV, _ = k_pages.shape
    n_pages = page_table.shape[1]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    pt = page_table.long().clamp(min=0)
    k = k_pages[pt].reshape(B, n_pages * ptok, KV, hd).float()
    v = v_pages[pt].reshape(B, n_pages * ptok, KV, hd).float()
    pos = torch.arange(n_pages * ptok, device=q.device)[None, :]
    valid = (pos < lengths[:, None]) & \
        (page_table >= 0).repeat_interleave(ptok, dim=1)
    valid = valid[:, None, None, :]
    s = torch.einsum("bkgh,bskh->bkgs", q.reshape(B, KV, g, hd).float(),
                     k) * scale
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", e, v)
    o = o / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return o.reshape(B, H, hd).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.dim() != 3 or k_pages.dim() != 4 or page_table.dim() != 2 or \
            lengths.dim() != 1:
        raise ValueError("expected q (B,H,hd), pages (P,ptok,KV,hd), "
                         "page_table (B,n_pages), lengths (B,)")
    B, H, hd = q.shape
    _, _, KV, khd = k_pages.shape
    if v_pages.shape != k_pages.shape or khd != hd or H % KV or \
            page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}, page_table {tuple(page_table.shape)}, "
            f"lengths {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of float32 or bfloat16, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    devices = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Returns (B, H, hd) in q's dtype. CUDA tensors go through the kernel
    (errors raise), CPU tensors through the plain version."""
    global LAUNCHES, LAUNCHES_MMA, PLAIN_CALLS
    _check(q, k_pages, v_pages, page_table, lengths)
    B, H, hd = q.shape
    _, ptok, KV, _ = k_pages.shape
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        PLAIN_CALLS += 1
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if hd > 256 or (hd * q.element_size()) % 16 or \
            k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the kernel needs hd <= 256, rows of a multiple of "
                         "16 bytes and 16-byte aligned K/V pages")
    g = H // KV
    path = _k1_path(q.dtype, hd, g)
    if path == "fma" and g * hd > MAX_GROUP_DIMS:
        raise ValueError(f"the kernel needs g * hd <= {MAX_GROUP_DIMS}, got "
                         f"{g} * {hd}")
    n_pages = page_table.shape[1]
    n_splits, split_tokens = _k1_splits(n_pages, ptok, B * KV,
                                        2 * hd * q.element_size())
    # inside a CUDA graph both come from the graph's pool: their addresses
    # are fixed at capture, and the memory is scratch of one replay
    out = torch.empty_like(q)
    work = torch.empty(n_splits * B * H * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _lib()
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr())
    shape = (B, KV, g, hd, n_pages, ptok, k_pages.shape[0], n_splits,
             split_tokens, float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if path == "mma":
            err = lib.repro_paged_decode_attention_mma(*ptrs, *shape)
        else:
            err = lib.repro_paged_decode_attention(*ptrs, _DTYPES[q.dtype],
                                                   *shape)
    if err:
        raise RuntimeError("paged_decode_attention launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    LAUNCHES += 1
    if path == "mma":
        LAUNCHES_MMA += 1
    return out
