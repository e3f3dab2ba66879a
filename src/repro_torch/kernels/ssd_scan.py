"""Mamba2 SSD chunked scan: the SSM family's prefill hot spot (K3).

`ssd_scan` launches the hand-written CUDA kernel in `csrc/ssd_scan.cu` (the
port of the Pallas kernel `repro/kernels/ssd_scan.py::ssd_scan_chunked`)
for CUDA tensors, and uses `ssd_scan_plain`, the plain torch version beside
it, only for CPU tensors. The kernel is built at first launch
(`kernels/build.py`).

K3 is forward-only, as the Pallas kernel is: asking `ssd_scan` for a
gradient raises. `ssd_scan_plain` is differentiable (plain autograd) and is
what `models/ssm.py::ssd_chunked`, the training path, runs.

Layout (the contract of the reference's `models/ssm.py::ssd_chunked`):
  xs (B, S, nh, hd)   dt (B, S, nh) f32, softplus applied   A (nh,) f32, < 0
  Bt, Ct (B, S, ds)   h0 (B, nh, hd, ds) f32 or None (zeros)
Returns y (B, S, nh, hd) f32 and hT (B, nh, hd, ds) f32. The chunk is
c = min(chunk, S); a ragged last chunk is padded with dt = 0 (no state
update, decay 1), so hT is exact. The kernel reads xs, Bt and Ct through
their strides (slices of the conv output need no copy) and takes any c up
to `MAX_CHUNK`.

`_k3_path` picks the kernel before the launch: bf16 xs/Bt/Ct whose rows
16-byte copies can read (base addresses and strides in multiples of 16
bytes, as slices of the conv output are) go to the chunk-parallel
tensor-core kernel (three launches: chunk states, state passing, chunk
scan); f32 inputs and other bf16 rows to the FMA kernel. Each call counts once in
`LAUNCHES` and once in its kernel's counter (`LAUNCHES_TC`,
`LAUNCHES_F32`). A kernel that fails raises: no other kernel is tried.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

# Counts of kernel calls (in all, and by kernel) and of plain-version calls
# made by the wrapper, so that a run can show which path it took. Reset by
# assigning 0.
LAUNCHES = 0
LAUNCHES_TC = 0
LAUNCHES_F32 = 0
PLAIN_CALLS = 0
# A CUDA graph that captured calls adds their launches to these at every
# replay (`core/graphs.py`).
COUNTERS = ("LAUNCHES", "LAUNCHES_TC", "LAUNCHES_F32", "PLAIN_CALLS")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 2048


def _strides(xs, Bt, Ct):
    """The strides the kernels read xs (batch, row, head), Bt and Ct (batch,
    row) through, in elements."""
    return (xs.stride(0), xs.stride(1), xs.stride(2), Bt.stride(0),
            Bt.stride(1), Ct.stride(0), Ct.stride(1))


def _k3_path(xs, Bt, Ct) -> str:
    """The kernel a CUDA call launches: "tc" (bf16 on tensor cores, its
    tiles copied 16 bytes at a time: every stride of xs/Bt/Ct a multiple
    of 8 elements and every base address of 16 bytes) or "f32" (the FMA
    kernel: f32 inputs, or bf16 rows those copies cannot read). Both take
    any hd <= MAX_HEAD_DIM and ds <= MAX_STATE (tiles are zero-filled up
    to them); the wrapper refuses larger ones."""
    if xs.dtype != torch.bfloat16 or \
            any(s % 8 for s in _strides(xs, Bt, Ct)) or \
            any(t.data_ptr() % 16 for t in (xs, Bt, Ct)):
        return "f32"
    return "tc"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
        [ctypes.c_longlong] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_ssd_scan_tc
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + \
        [ctypes.c_longlong] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_ssd_scan_tc_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    lib.repro_ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.repro_ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_plain(xs, dt, A, Bt, Ct, chunk: int, h0=None):
    """The reference's chunked SSD in plain torch, step for step: the
    intra-chunk quadratic form with the decay masked to -inf before exp,
    the chunk-final states, then the inter-chunk recurrence."""
    B, S, nh, hd = xs.shape
    ds = Bt.shape[-1]
    c = min(chunk, S)
    n = -(-S // c)
    pad = n * c - S
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bt = F.pad(Bt, (0, 0, 0, pad))
        Ct = F.pad(Ct, (0, 0, 0, pad))
    xs = xs.reshape(B, n, c, nh, hd).float()
    dt = dt.reshape(B, n, c, nh).float()
    Bt = Bt.reshape(B, n, c, ds).float()
    Ct = Ct.reshape(B, n, c, ds).float()

    cum = torch.cumsum(dt * A, dim=2)             # inclusive (B, n, c, nh)
    scores = torch.einsum("bncs,bnms->bncm", Ct, Bt)
    causal = torch.ones((c, c), dtype=torch.bool, device=xs.device).tril()
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,n,c,c,nh)
    decay = torch.where(causal[:, :, None], decay, -torch.inf)
    M = torch.where(causal[:, :, None], scores[..., None] * torch.exp(decay),
                    0.0)
    y_intra = torch.einsum("bncmh,bnmh,bnmhp->bnchp", M, dt, xs)

    dec_end = torch.exp(cum[:, :, -1:, :] - cum)
    hc = torch.einsum("bnch,bnch,bnchp,bncs->bnhps", dec_end, dt, xs, Bt)
    a_chunk = torch.exp(cum[:, :, -1, :])           # (B, n, nh)
    h = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=xs.device) \
        if h0 is None else h0.float()
    y_inter = []
    for k in range(n):
        y_inter.append(torch.einsum("bcs,bhps,bch->bchp", Ct[:, k], h,
                                    torch.exp(cum[:, k])))
        h = a_chunk[:, k, :, None, None] * h + hc[:, k]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(B, n * c, nh, hd)
    return y[:, :S], h


def _check(xs, dt, A, Bt, Ct, h0):
    if xs.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bt.dim() != 3 or \
            Ct.dim() != 3:
        raise ValueError("expected xs (B,S,nh,hd), dt (B,S,nh), A (nh,), "
                         "Bt/Ct (B,S,ds)")
    B, S, nh, hd = xs.shape
    ds = Bt.shape[-1]
    if dt.shape != (B, S, nh) or A.shape != (nh,) or \
            Bt.shape != (B, S, ds) or Ct.shape != (B, S, ds) or \
            (h0 is not None and h0.shape != (B, nh, hd, ds)) or S < 1:
        raise ValueError(
            f"shape mismatch: xs {tuple(xs.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bt {tuple(Bt.shape)}, Ct {tuple(Ct.shape)}, "
            f"h0 {None if h0 is None else tuple(h0.shape)}")
    tensors = [t for t in (xs, dt, A, Bt, Ct, h0) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def _refuse_grad(*tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "ssd_scan (K3) is forward-only, as the Pallas kernel it ports "
            "is; it has no backward (ROADMAP.md, TPU kernels, K3). "
            "Differentiate through models/ssm.py::ssd_chunked instead")


def ssd_scan(xs, dt, A, Bt, Ct, chunk: int,
             h0: Optional[torch.Tensor] = None):
    """Returns (y, hT), both f32. CUDA tensors go through the kernel
    `_k3_path` names (errors raise), CPU tensors through the plain version;
    a gradient is refused on either."""
    global LAUNCHES, LAUNCHES_TC, LAUNCHES_F32, PLAIN_CALLS
    _refuse_grad(xs, dt, A, Bt, Ct, h0)
    _check(xs, dt, A, Bt, Ct, h0)
    if xs.device.type == "cpu":
        PLAIN_CALLS += 1
        return ssd_scan_plain(xs, dt, A, Bt, Ct, chunk, h0)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    B, S, nh, hd = xs.shape
    ds = Bt.shape[-1]
    c = min(chunk, S)
    if xs.dtype not in _DTYPES or Bt.dtype != xs.dtype or \
            Ct.dtype != xs.dtype:
        raise TypeError(f"xs/Bt/Ct must share one dtype of float32 or "
                        f"bfloat16, got {xs.dtype}, {Bt.dtype}, {Ct.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or \
            (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("dt, A and h0 must be float32")
    if xs.stride(3) != 1 or Bt.stride(2) != 1 or Ct.stride(2) != 1 or \
            not (dt.is_contiguous() and A.is_contiguous()) or \
            (h0 is not None and not h0.is_contiguous()):
        raise ValueError("xs/Bt/Ct need unit stride in their last dim; dt, "
                         "A and h0 must be contiguous")
    if hd > MAX_HEAD_DIM or ds > MAX_STATE or c > MAX_CHUNK:
        raise ValueError(f"the kernel takes hd <= {MAX_HEAD_DIM}, ds <= "
                         f"{MAX_STATE} and chunk <= {MAX_CHUNK}, got hd {hd}, "
                         f"ds {ds}, chunk {c}")
    dev = xs.device
    strides = _strides(xs, Bt, Ct)
    path = _k3_path(xs, Bt, Ct)
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=dev)
    hT = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=dev)
    lib = _lib()
    common = (xs.data_ptr(), dt.data_ptr(), A.data_ptr(), Bt.data_ptr(),
              Ct.data_ptr(), None if h0 is None else h0.data_ptr(),
              y.data_ptr(), hT.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tc":
            # the chunk states, entering states, cumsums and decays passed
            # between the three kernels (the layout is the C side's)
            scratch = torch.empty(
                lib.repro_ssd_scan_tc_scratch_bytes(B, S, nh, hd, ds, c),
                dtype=torch.uint8, device=dev)
            err = lib.repro_ssd_scan_tc(
                *common, scratch.data_ptr(), B, S, nh, hd, ds, c, *strides,
                stream)
        else:
            err = lib.repro_ssd_scan(*common, _DTYPES[xs.dtype], B, S, nh, hd,
                                     ds, c, *strides, stream)
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.repro_ssd_scan_error_string(err).decode())
    LAUNCHES += 1
    if path == "tc":
        LAUNCHES_TC += 1
    else:
        LAUNCHES_F32 += 1
    return y, hT
