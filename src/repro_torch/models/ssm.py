"""Mamba2 (SSD, state-space duality) mixer.

Port of `repro/models/ssm.py`. Prefill and training use the chunked SSD
algorithm (intra-chunk quadratic form + inter-chunk recurrence); decode is
the O(1)-per-token recurrent update, the most bandwidth-bound decode of the
model zoo (where Harli's harvesting margin is largest).

`ssm_prefill(use_kernel=True)` runs the scan through the forward-only SSD
kernel (`kernels/ops.ssd_scan`, K3); otherwise through `ssd_chunked`, the
plain and differentiable chunked form. Rounding follows the reference: the
prefill's causal conv is `w` products summed in the activation dtype while
decode's is one contraction (f32 sum, one rounding); silu runs in f32 and
is cast back; the gated RMSNorm sees `y` cast to the activation dtype
times silu(z). The state is `{"h": (B, nh, hd, ds) f32, "conv": (B, w-1,
dinner + 2 ds) bf16}` whatever dtype the cache was asked for.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def ssm_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
             dtype=torch.bfloat16) -> Dict:
    """Mixer weights of `n_layers` layers stacked on a leading axis, at the
    reference's scales, drawn on `gen`'s device one layer at a time.
    A_log, dt_bias and D are f32, the rest `dtype`."""
    d = cfg.d_model
    dinner, ds, nh = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads
    convdim = dinner + 2 * ds
    dev = gen.device

    def normal(shape, std):
        out = torch.empty((n_layers,) + shape, dtype=dtype, device=dev)
        for sub in out:
            sub.copy_(torch.randn(shape, generator=gen, device=dev) * std)
        return out

    def full(shape, value, dt):
        return torch.full((n_layers,) + shape, value, dtype=dt, device=dev)

    A_log = torch.log(torch.linspace(1.0, 16.0, nh)).to(dev)
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": normal((d, 2 * dinner + 2 * ds + nh), d ** -0.5),
        "conv_w": normal((cfg.ssm_conv_width, convdim), 0.1),
        "conv_b": full((convdim,), 0.0, dtype),
        "A_log": A_log.expand(n_layers, nh).clone(),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "D": full((nh,), 1.0, torch.float32),
        "gate_norm": full((dinner,), 1.0, dtype),
        "out_proj": normal((dinner, d), dinner ** -0.5),
    }


def make_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict:
    dinner, ds, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                          cfg.ssm_headdim)
    return {
        "h": torch.zeros((batch, nh, hd, ds), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, dinner + 2 * ds),
                            dtype=torch.bfloat16, device=device),
    }


def _split_proj(p, x, cfg: ModelConfig):
    dinner, ds, nh = cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :dinner]
    xbc = zxbcdt[..., dinner:dinner + dinner + 2 * ds]
    dt = zxbcdt[..., -nh:]
    return z, xbc, dt


def _gated_out(p, y, z, x_dtype, cfg: ModelConfig):
    """Gated RMSNorm of y (cast to the activation dtype) times silu(z),
    then the out-projection."""
    y = L.rms_norm(y * F.silu(z.float()).to(x_dtype), p["gate_norm"],
                   cfg.norm_eps)
    return y @ p["out_proj"].to(x_dtype)


def ssm_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Dict] = None, use_kernel: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). Returns (y, final_state); final_state is None when no
    state is given."""
    B, S, _ = x.shape
    dinner, ds, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                          cfg.ssm_headdim)
    z, xbc, dt = _split_proj(p, x, cfg)

    # causal depthwise conv1d of width w: w products summed in xbc's dtype
    w = cfg.ssm_conv_width
    pad = torch.zeros((B, w - 1, xbc.shape[-1]), dtype=xbc.dtype,
                      device=x.device) if state is None \
        else state["conv"].to(xbc.dtype)
    xbc_p = torch.cat([pad, xbc], dim=1)
    conv = sum(xbc_p[:, i:i + S] * p["conv_w"][i].to(xbc.dtype)
               for i in range(w)) + p["conv_b"].to(xbc.dtype)
    conv = F.silu(conv.float()).to(x.dtype)
    xs = conv[..., :dinner].reshape(B, S, nh, hd)
    Bt = conv[..., dinner:dinner + ds]
    Ct = conv[..., dinner + ds:]

    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,nh)
    A = -torch.exp(p["A_log"])                                     # (nh,)
    h0 = None if state is None else state["h"]
    scan = kops.ssd_scan if use_kernel else ssd_chunked
    y, hT = scan(xs, dt, A, Bt, Ct, cfg.ssm_chunk, h0=h0)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(B, S, dinner).to(x.dtype)
    out = _gated_out(p, y, z, x.dtype, cfg)
    new_state = None
    if state is not None:
        new_state = {"h": hT, "conv": xbc_p[:, S:].to(state["conv"].dtype)}
    return out, new_state


# The plain chunked SSD under the reference's name: the differentiable
# path, and K3's plain version. xs (B,S,nh,hd), dt (B,S,nh), A (nh,),
# Bt/Ct (B,S,ds) -> y (B,S,nh,hd) f32, hT (B,nh,hd,ds) f32.
ssd_chunked = ssd_scan_plain


def ssm_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent update. x: (B, 1, d)."""
    B = x.shape[0]
    dinner, ds, nh, hd = (cfg.ssm_dinner, cfg.ssm_state, cfg.ssm_nheads,
                          cfg.ssm_headdim)
    z, xbc, dt = _split_proj(p, x[:, 0], cfg)

    conv_buf = torch.cat([state["conv"].to(xbc.dtype), xbc[:, None]],
                         dim=1)                                   # (B, w, cd)
    # one contraction over w: an f32 sum, rounded once to xbc's dtype
    conv = (conv_buf.float() * p["conv_w"].to(xbc.dtype).float()
            ).sum(dim=1).to(xbc.dtype)
    conv = conv + p["conv_b"].to(xbc.dtype)
    conv = F.silu(conv.float()).to(x.dtype)
    xsv = conv[..., :dinner].reshape(B, nh, hd).float()
    Btv = conv[..., dinner:dinner + ds].float()
    Ctv = conv[..., dinner + ds:].float()

    dtv = F.softplus(dt.float() + p["dt_bias"])                  # (B, nh)
    a = torch.exp(dtv * (-torch.exp(p["A_log"])))                 # (B, nh)
    h = a[:, :, None, None] * state["h"] + \
        (dtv[:, :, None] * xsv)[..., None] * Btv[:, None, None, :]
    y = torch.einsum("bs,bhps->bhp", Ctv, h) + xsv * p["D"][None, :, None]
    y = y.reshape(B, dinner).to(x.dtype)
    out = _gated_out(p, y, z, x.dtype, cfg)[:, None]
    return out, {"h": h, "conv": conv_buf[:, 1:].to(state["conv"].dtype)}
