"""Fused LoRA matmul y = x @ W + s * (x @ A) @ B: the finetune hot spot (K2).

`lora_matmul` launches a hand-written CUDA kernel of `csrc/lora_matmul.cu`
(the port of the Pallas kernel `repro/kernels/lora_matmul.py::_kernel`) for
CUDA tensors, and uses `lora_matmul_plain`, the plain torch version beside
it, only for CPU tensors. The kernels are built at first launch
(`kernels/build.py`).

`_k2_path` picks the kernel from the shape before the launch: bf16 shapes
whose rows TMA can describe (K, N and r multiples of 8) go to the
persistent wgmma + TMA kernel (which picks its own tile width: 256 where
the tiles fill the card, 128 where they would not, as at N = 1024); other
bf16 shapes to the WMMA kernel; f32 to the FMA kernel. Each launch counts in
`LAUNCHES` and in its kernel's own counter (`LAUNCHES_WGMMA`,
`LAUNCHES_WMMA`, `LAUNCHES_F32`). A kernel that fails raises: no other
kernel is tried.

`LoRAMatmul` is the autograd Function around it. The Pallas kernel has no
backward; the port's input gradient has the forward's fused form,
  dx = dy @ W^T + s * (dy @ B^T) @ A^T = lora_matmul(dy, W^T, B^T, A^T, s),
so it launches the same kernel, reading the frozen W transposed in place.
dA = x^T @ (s * dy @ B^T) and dB = s * (x @ A)^T @ dy are rank-r products,
left to `torch.matmul` as the JAX package leaves them to XLA. W gets no
gradient.

Layout: x (M, K); w (K, N), contiguous or the transpose of a contiguous
(N, K) tensor; a (K, r); b (r, N); all of one dtype. Returns (M, N).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# Counts of kernel launches (in all, and by kernel) and of plain-version
# calls made by the wrapper, so that a run can show which path it took.
# Reset by assigning 0.
LAUNCHES = 0
LAUNCHES_WGMMA = 0
LAUNCHES_WMMA = 0
LAUNCHES_F32 = 0
PLAIN_CALLS = 0
# A CUDA graph that captured calls adds their launches to these at every
# replay (`core/graphs.py`).
COUNTERS = ("LAUNCHES", "LAUNCHES_WGMMA", "LAUNCHES_WMMA", "LAUNCHES_F32",
            "PLAIN_CALLS")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64
# kernel codes of the C entry point
_KERNELS = {"f32": 0, "wmma": 1, "wgmma": 2}


def _k2_path(M: int, N: int, K: int, r: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of this shape launches: "f32" (FMA),
    "wmma" (bf16 rows TMA cannot describe: K, N or r not a multiple of 8),
    or "wgmma"."""
    if dtype == torch.float32:
        return "f32"
    if K % 8 or N % 8 or r % 8:
        return "wmma"
    return "wgmma"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lora_matmul")
    fn = lib.repro_lora_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_lora_matmul_error_string.argtypes = [ctypes.c_int]
    lib.repro_lora_matmul_error_string.restype = ctypes.c_char_p
    return lib


def lora_matmul_plain(x, w, a, b, scale: float) -> torch.Tensor:
    """The kernel's function in plain torch, with its rounding points: f32
    products, xa rounded to b's dtype, one rounding of the sum to x's."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.to(f) @ w.to(f)
    xa = (x.to(f) @ a.to(f)).to(b.dtype)
    y = y + scale * (xa.to(f) @ b.to(f))
    return y.to(x.dtype)


def _check(x, w, a, b):
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("expected x (M,K), w (K,N), a (K,r), b (r,N)")
    M, K = x.shape
    N = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != K or a.shape[0] != K or b.shape != (r, N):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not (x.dtype == w.dtype == a.dtype == b.dtype):
        raise TypeError(f"x/w/a/b must share one dtype, got {x.dtype}, "
                        f"{w.dtype}, {a.dtype}, {b.dtype}")
    devices = {t.device for t in (x, w, a, b)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def lora_matmul(x, w, a, b, scale: float) -> torch.Tensor:
    """Returns (M, N) in x's dtype. CUDA tensors go through the kernel
    (errors raise), CPU tensors through the plain version."""
    global LAUNCHES, LAUNCHES_WGMMA, LAUNCHES_WMMA, LAUNCHES_F32, PLAIN_CALLS
    _check(x, w, a, b)
    if x.device.type == "cpu":
        PLAIN_CALLS += 1
        return lora_matmul_plain(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    if w.is_contiguous():
        w_trans = 0
    elif w.t().is_contiguous():
        w_trans = 1                     # w: the transpose of an (N, K) buffer
    else:
        raise ValueError("w must be contiguous or the transpose of a "
                         "contiguous tensor")
    if not (x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, a and b must be contiguous")
    if r > MAX_RANK:
        raise ValueError(f"the kernel takes rank <= {MAX_RANK}, got {r}")
    if any(t.data_ptr() % 16 for t in (x, w, a, b)):
        raise ValueError("the kernel needs 16-byte aligned inputs")
    path = _k2_path(M, N, K, r, x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.repro_lora_matmul(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), _DTYPES[x.dtype], M, N, K, r, w_trans,
            _KERNELS[path], float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lora_matmul launch failed ({path} kernel): "
                           + lib.repro_lora_matmul_error_string(err).decode())
    LAUNCHES += 1
    if path == "f32":
        LAUNCHES_F32 += 1
    elif path == "wmma":
        LAUNCHES_WMMA += 1
    else:
        LAUNCHES_WGMMA += 1
    return out


class LoRAMatmul(torch.autograd.Function):
    """Differentiable `lora_matmul` (2-D x). W is frozen: asking for its
    gradient raises."""

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale = scale
        return lora_matmul(x, w, a, b, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scale
        if ctx.needs_input_grad[1]:
            raise RuntimeError("lora_matmul: W is frozen and has no gradient")
        dy = dy.contiguous()
        if dy.data_ptr() % 16:          # a view at an odd offset: realign
            dy = dy.clone()
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = lora_matmul(dy, w.t(), b.t().contiguous(),
                             a.t().contiguous(), s)
        if ctx.needs_input_grad[2]:
            da = x.t() @ (s * (dy @ b.t()))
        if ctx.needs_input_grad[3]:
            db = s * ((x @ a).t() @ dy)
        return dx, None, da, db, None
