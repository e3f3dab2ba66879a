"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of `repro/models/rglru.py`, with its functions and parameter names,
so that `interop.to_torch` carries the reference's trees across one to one.

Block layout (Griffin "recurrent block"):
    x -> branch A: linear(d->w) -> GeLU
      -> branch B: linear(d->w) -> causal conv1d(width 4) -> RG-LRU
    out = (A * B_rglru) @ out_proj

RG-LRU (per channel, diagonal recurrence):
    r_t = sigmoid(block_diag_linear_a(x_t))        recurrence gate
    i_t = sigmoid(block_diag_linear_x(x_t))        input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))       in (0,1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans prefill and training with `jax.lax.associative_scan`,
which is no Pallas kernel: no TPU kernel covers the RG-LRU, and the port's
scan is plain torch too. `linear_scan` is a log-depth (Hillis-Steele
doubling) scan in f32, differentiable through autograd; `linear_scan_loop`
is the step-by-step recurrence it is tested against. Neither goes through
log space: log a_t reaches -8 softplus(4) ~ -32 per step, and the exp of
its prefix sums overflows. GeLU is the tanh approximation, `jax.nn.gelu`'s
default. Decode is the O(1) update. The state is {"h": (B, w) f32,
"conv": (B, 3, w) bf16}.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_C = 8.0
_NUM_BLOCKS = 16
_CONV = 4                      # the causal conv's width


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int = 0,
               dtype=torch.bfloat16) -> Dict:
    """Block weights at the reference's scales, drawn on `gen`'s device
    one layer at a time; n_layers > 0 stacks them on a leading axis.
    `lamb` is f32, the rest `dtype`."""
    d, w = cfg.d_model, _width(cfg)
    nb = _NUM_BLOCKS if w % _NUM_BLOCKS == 0 else 1
    bs = w // nb
    dev = gen.device
    lead = (n_layers,) if n_layers else ()

    def normal(shape, std):
        out = torch.empty(lead + shape, dtype=dtype, device=dev)
        for sub in (out if n_layers else [out]):
            sub.copy_(torch.randn(shape, generator=gen, device=dev) * std)
        return out

    return {
        "in_y": normal((d, w), d ** -0.5),
        "in_x": normal((d, w), d ** -0.5),
        "conv_w": normal((_CONV, w), 0.1),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "gate_a": normal((nb, bs, bs), bs ** -0.5),
        "gate_x": normal((nb, bs, bs), bs ** -0.5),
        "lamb": torch.linspace(-4.0, 4.0, w, device=dev).expand(
            lead + (w,)).clone(),
        "out_proj": normal((w, d), w ** -0.5),
    }


def make_rglru_state(cfg: ModelConfig, batch: int, device=None) -> Dict:
    w = _width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV - 1, w), dtype=torch.bfloat16,
                            device=device),
    }


def _block_diag(x, w):
    """x: (..., W) with W = nb*bs; w: (nb, bs, bs)."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return y.reshape(*x.shape[:-1], nb * bs)


def _gates(p, xb):
    """(a, sqrt(1 - a^2) * i * x), both f32; 1 - a^2 clamped at 1e-12
    before the square root, as in the reference."""
    r = torch.sigmoid(_block_diag(xb, p["gate_a"]).float())
    i = torch.sigmoid(_block_diag(xb, p["gate_x"]).float())
    log_a = -_C * F.softplus(p["lamb"]) * r                # (..., w), <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * xb.float()


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in
    ceil(log2 S) doubling steps: after the step of offset o, element t
    holds the combination of elements t - 2o + 1..t (the reference's
    `comb`: (a1 a2, a2 b1 + b2)). Out of place, so autograd takes it."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def linear_scan_loop(a, b, h0=None):
    """The same recurrence one step at a time (the test oracle)."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def _gelu(t, dtype):
    return F.gelu(t.float(), approximate="tanh").to(dtype)


def rglru_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d) -> (out, new_state); new_state is None when no state
    is given (training). With a state its h0 enters as a virtual step 0
    and the new conv state is the last 3 rows of the padded input, however
    short the prompt."""
    B, S, _ = x.shape
    y_branch = _gelu(x @ p["in_y"].to(x.dtype), x.dtype)
    xb = x @ p["in_x"].to(x.dtype)

    # causal conv1d of width 4: 4 products summed in xb's dtype
    pad = torch.zeros((B, _CONV - 1, xb.shape[-1]), dtype=xb.dtype,
                      device=x.device) if state is None \
        else state["conv"].to(xb.dtype)
    xp = torch.cat([pad, xb], dim=1)
    conv = sum(xp[:, i:i + S] * p["conv_w"][i].to(xb.dtype)
               for i in range(_CONV)) + p["conv_b"].to(xb.dtype)

    a, bx = _gates(p, conv)                                # (B, S, w) f32
    if state is not None:
        ones = torch.ones((B, 1, a.shape[-1]), dtype=torch.float32,
                          device=x.device)
        h = linear_scan(torch.cat([ones, a], dim=1),
                        torch.cat([state["h"][:, None], bx], dim=1))[:, 1:]
    else:
        h = linear_scan(a, bx)

    out = (y_branch.float() * h).to(x.dtype) @ p["out_proj"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"h": h[:, -1], "conv": xp[:, S:].to(torch.bfloat16)}
    return out, new_state


def rglru_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). O(1) recurrent update."""
    y_branch = _gelu(x[:, 0] @ p["in_y"].to(x.dtype), x.dtype)
    xb = x[:, 0] @ p["in_x"].to(x.dtype)
    buf = torch.cat([state["conv"].to(xb.dtype), xb[:, None]], dim=1)
    # one contraction over the width: an f32 sum, rounded once
    conv = (buf.float() * p["conv_w"].to(xb.dtype).float()).sum(dim=1) \
        .to(xb.dtype)
    conv = conv + p["conv_b"].to(xb.dtype)
    a, bx = _gates(p, conv)
    h = a * state["h"] + bx
    out = (y_branch.float() * h).to(x.dtype) @ p["out_proj"].to(x.dtype)
    return out[:, None], {"h": h, "conv": buf[:, 1:].to(torch.bfloat16)}
