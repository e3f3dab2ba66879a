"""Roofline cost model of decode rounds, prefills and finetune units.

The port's own copy of `repro/core/costmodel.py` (plain numpy; keep the two
in step), with the reference's formulas unchanged. Two things differ:

* The instance defaults to one NVIDIA H100 (`hw.H100_SXM`, tp 1), not the
  reference's TPU group.
* The reference's seven engineering constants (`costmodel.py:33-39`:
  MXU_EFF, BW_EFF, OVERLAP_EFF, STEP_OVERHEAD_S, PER_LAYER_OVERHEAD_S,
  UNIT_OVERHEAD_S, BW_SAT_QUANTUM) are TPU figures. Here they are the
  fields of `CostConstants`, which `InstanceSpec` carries, so a spec and
  its constants travel together; the tests build the reference's TPU
  instance from `repro.hw` and `repro.core.costmodel` and hold every method
  against the reference's.

`H100_CONSTANTS` were fitted by least squares to rounds and units that
`chip_smoke.py` measured on the card (its cost-model fit, after phase 12);
the comment above them names the run and the card. The model keeps the
reference's shape: a co-located round overlaps decode with its k units
(OVERLAP_EFF), while the port runs them one after the other on one
stream, and no term prices the HEAD unit. Both show in the fitted values
and their errors (`PERF.md` §6).

The measurement source of the reference's predictor fit
(`TwoStageLatencyPredictor.fit_from_costmodel`), and the price of a
checkpoint commit (`checkpoint_time`, `distributed/fault_tolerance.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.hw import H100_SXM, ChipSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Achievable fractions of the chip's peaks and fixed overheads."""
    mxu_eff: float               # effective fraction of peak FLOP/s
    bw_eff: float                # effective fraction of HBM bandwidth
    overlap_eff: float           # share of the smaller roofline term hidden
    step_overhead_s: float       # per decode round
    per_layer_overhead_s: float  # per layer of a decode round
    unit_overhead_s: float       # per finetune unit
    bw_sat_quantum: float        # share of the chip that saturates HBM


# Fitted by `chip_smoke.py` (`fit_h100_constants`, its "costmodel fit:"
# line) in run r1 of PR 18 on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit, from graphed llama3-8b and mamba2-780m solo rounds (8 slots),
# llama3-8b's graphed FWD and BWD units (micro-batch 2 x 1024) and its
# co-located rounds (k = 1, 3, 6):
#   bw_eff 1.0: the least squares wanted more than the HBM peak, so it is
#     pinned there, and the rounds' time beyond the weight stream falls to
#     the step and per-layer overheads (the round barely moves with batch
#     and context);
#   overlap_eff 0.21: the port runs a round's units after its decode step,
#     so the near-serial sum shows as little overlap.
# bw_sat_quantum is the paper's Fig. 9 share, not a fit: the port never
# runs decode on part of the card, so the predictor's solo levels below
# quantum 1 are modelled, not measured.
H100_CONSTANTS = CostConstants(
    mxu_eff=0.2535178282619821,
    bw_eff=1.0,
    overlap_eff=0.20912353056268074,
    step_overhead_s=0.0013103564320780213,
    per_layer_overhead_s=0.000186140996996152,
    unit_overhead_s=0.000737871129290758,
    bw_sat_quantum=0.45,
)


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """A serving/finetune deployment unit: a TP group of `tp` chips."""
    chip: ChipSpec = H100_SXM
    tp: int = 1
    consts: CostConstants = H100_CONSTANTS

    @property
    def peak_flops(self) -> float:
        return self.chip.peak_flops_bf16 * self.tp * self.consts.mxu_eff

    @property
    def hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.tp * self.consts.bw_eff

    @property
    def hbm_bytes(self) -> float:
        return self.chip.hbm_bytes * self.tp

    @property
    def host_dma_bw(self) -> float:
        return self.chip.host_dma_bw * self.tp


@dataclasses.dataclass
class DecodeWork:
    """Bytes/FLOPs of one decode round."""
    bytes_hbm: float
    flops: float
    ici_s: float          # TP collective time per round


@dataclasses.dataclass
class UnitWork:
    """Bytes/FLOPs of one finetune layer-unit (fwd or bwd avg)."""
    bytes_hbm: float
    flops: float
    layer_weight_bytes: float   # for window swap timing


class CostModel:
    def __init__(self, cfg: ModelConfig, inst: InstanceSpec = InstanceSpec(),
                 noise_sigma: float = 0.015, seed: int = 0):
        self.cfg = cfg
        self.inst = inst
        self.c = inst.consts
        self.noise_sigma = noise_sigma
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------- workloads ----
    def decode_work(self, bs: int, mean_ctx: float) -> DecodeWork:
        cfg = self.cfg
        active = cfg.active_param_count()
        w_bytes = active * 2.0                           # bf16 weight stream
        ctx_eff = cfg.effective_cache_len(int(mean_ctx))
        kv_bytes = bs * ctx_eff * cfg.cache_bytes_per_token() \
            + bs * cfg.state_bytes()
        flops = 2.0 * active * bs \
            + 4.0 * bs * ctx_eff * len(cfg.attn_layer_indices()) \
            * cfg.num_kv_heads * cfg.head_dim * max(cfg.q_per_kv, 1)
        # TP all-reduce of (bs, d) per layer, 2x, ring over tp chips
        ar_bytes = 2 * cfg.num_layers * bs * cfg.d_model * 2.0
        link = self.inst.chip.ici_bw_per_link * max(self.inst.tp, 1)
        ici_s = 0.0 if (self.inst.tp <= 1 or link <= 0) else \
            2 * (self.inst.tp - 1) / self.inst.tp * ar_bytes / link
        return DecodeWork(bytes_hbm=w_bytes + kv_bytes, flops=flops,
                          ici_s=ici_s)

    def prefill_latency(self, prompt_len: int, bs: int = 1) -> float:
        cfg = self.cfg
        active = cfg.active_param_count()
        flops = 2.0 * active * prompt_len * bs \
            + 4.0 * prompt_len * cfg.effective_cache_len(prompt_len) / 2 \
            * len(cfg.attn_layer_indices()) * cfg.num_heads * cfg.head_dim * bs
        bytes_hbm = active * 2.0 + bs * prompt_len * cfg.d_model * 2 * 8
        return max(flops / self.inst.peak_flops,
                   bytes_hbm / self.inst.hbm_bw) + self.c.step_overhead_s

    def checkpoint_time(self) -> float:
        """Device->host commit of the PEFT training state: bf16 trainable
        weights plus fp32 Adam moments stream over the host DMA link (the
        frozen base weights need no commit)."""
        trainable = self.cfg.lora_param_count() or self.cfg.param_count()
        ckpt_bytes = trainable * (2.0 + 8.0)
        return ckpt_bytes / self.inst.host_dma_bw

    def adapter_load_time(self, adapter_bytes: float,
                          setup_s: float = 0.001) -> float:
        """Host->HBM hot-load of one LoRA adapter's weights: the bf16
        adapter tensors stream over the host DMA link after a fixed
        dispatch/registration handshake. Deterministic (no ``_noise()``)."""
        return setup_s + adapter_bytes / self.inst.host_dma_bw

    def kv_migration_time(self, context_tokens: int, bw_bytes_per_s: float,
                          setup_s: float = 0.0) -> float:
        """Live KV transfer of one request to a peer instance: the
        context's KV pages plus the per-request decode state stream at the
        given point-to-point bandwidth, after a fixed handshake.
        Deterministic (no ``_noise()``)."""
        kv_bytes = context_tokens * self.cfg.cache_bytes_per_token() \
            + self.cfg.state_bytes()
        return setup_s + kv_bytes / max(bw_bytes_per_s, 1.0)

    def prefill_batch_latency(self, prompt_lens: Sequence[int]) -> float:
        """One fused prefill launch over a batch of (possibly ragged)
        prompts: token work is additive across requests, the weight stream
        and dispatch overhead are paid once. Reduces exactly to
        ``prefill_latency(p, bs=1)`` for a single prompt."""
        if not prompt_lens:
            return 0.0
        cfg = self.cfg
        active = cfg.active_param_count()
        flops = bytes_hbm = 0.0
        for p in prompt_lens:
            flops += 2.0 * active * p \
                + 4.0 * p * cfg.effective_cache_len(p) / 2 \
                * len(cfg.attn_layer_indices()) * cfg.num_heads * cfg.head_dim
            bytes_hbm += p * cfg.d_model * 2 * 8
        bytes_hbm += active * 2.0
        return max(flops / self.inst.peak_flops,
                   bytes_hbm / self.inst.hbm_bw) + self.c.step_overhead_s

    def unit_work(self, micro_batch: int, seq_len: int,
                  backward: bool = False) -> UnitWork:
        """One layer fwd (bwd ≈ 2x flops: recompute + grads)."""
        cfg = self.cfg
        per_layer_params = cfg.active_param_count() / max(cfg.num_layers, 1)
        tokens = micro_batch * seq_len
        f = 2.0 * per_layer_params * tokens
        if backward:
            f *= 3.0   # recompute fwd + dx + dW(adapters)
        w_bytes = per_layer_params * 2.0
        act_bytes = 4 * tokens * cfg.d_model * 2.0
        return UnitWork(bytes_hbm=w_bytes + act_bytes, flops=f,
                        layer_weight_bytes=w_bytes)

    def avg_unit_work(self, micro_batch: int, seq_len: int) -> UnitWork:
        f = self.unit_work(micro_batch, seq_len, backward=False)
        b = self.unit_work(micro_batch, seq_len, backward=True)
        return UnitWork(bytes_hbm=(f.bytes_hbm + b.bytes_hbm) / 2,
                        flops=(f.flops + b.flops) / 2,
                        layer_weight_bytes=f.layer_weight_bytes)

    # -------------------------------------------------------- latencies ---
    def _noise(self) -> float:
        if self.noise_sigma <= 0:
            return 1.0
        return float(np.exp(self.rng.normal(0.0, self.noise_sigma)))

    def decode_solo(self, bs: int, mean_ctx: float, quantum: float = 1.0,
                    noisy: bool = True) -> float:
        """Decode-round latency with fraction `quantum` of the instance
        (paper Fig. 9: sublinear in the compute share, because decode is
        memory-bound and BW saturates below full allocation)."""
        w = self.decode_work(bs, mean_ctx)
        q = max(quantum, 1e-3)
        bw = self.inst.hbm_bw * min(1.0, q / self.c.bw_sat_quantum)
        t = max(w.bytes_hbm / bw, w.flops / (self.inst.peak_flops * q))
        t += w.ici_s + self.c.step_overhead_s \
            + self.cfg.num_layers * self.c.per_layer_overhead_s
        return t * (self._noise() if noisy else 1.0)

    def _fused(self, d: DecodeWork, total_bytes: float, total_flops: float,
               k_units: int) -> float:
        """A fused round: the larger roofline term, the part of the smaller
        one that is not hidden under it, and the overheads."""
        t_mem = total_bytes / self.inst.hbm_bw
        t_comp = total_flops / self.inst.peak_flops
        t = max(t_mem, t_comp) \
            + (1.0 - self.c.overlap_eff) * min(t_mem, t_comp)
        return t + (d.ici_s + self.c.step_overhead_s
                    + self.cfg.num_layers * self.c.per_layer_overhead_s
                    + k_units * self.c.unit_overhead_s)

    def colocated_round(self, bs: int, mean_ctx: float, k_units: int,
                        micro_batch: int, seq_len: int,
                        unit_weights_resident: bool = True,
                        noisy: bool = True) -> float:
        """Fused decode + k finetune-unit round latency (Eq. 5 analogue).
        `unit_weights_resident` is the reference's argument, which no term
        reads (a window's streaming is on the host-DMA channel)."""
        d = self.decode_work(bs, mean_ctx)
        u = self.avg_unit_work(micro_batch, seq_len)
        t = self._fused(d, d.bytes_hbm + k_units * u.bytes_hbm,
                        d.flops + k_units * u.flops, k_units)
        return t * (self._noise() if noisy else 1.0)

    def chunk_work(self, chunk_tokens: int, chunk_ctx: float) -> DecodeWork:
        """Bytes/FLOPs of a prefill chunk processed inside a decode round
        (chunked prefill): dense FLOPs per token plus attention of the
        chunk against the ``chunk_ctx`` tokens already resident. The weight
        stream is not charged here; the fused round pays it once."""
        cfg = self.cfg
        active = cfg.active_param_count()
        flops = 2.0 * active * chunk_tokens \
            + 4.0 * chunk_tokens * cfg.effective_cache_len(
                int(chunk_ctx + chunk_tokens / 2)) \
            * len(cfg.attn_layer_indices()) * cfg.num_heads * cfg.head_dim
        bytes_hbm = chunk_tokens * cfg.d_model * 2 * 8
        return DecodeWork(bytes_hbm=bytes_hbm, flops=flops, ici_s=0.0)

    def mixed_round_latency(self, bs: int, mean_ctx: float,
                            chunk_tokens: int, chunk_ctx: float = 0.0,
                            k_units: int = 0, micro_batch: int = 2,
                            seq_len: int = 1024,
                            noisy: bool = True) -> float:
        """One decode round with ``chunk_tokens`` of prefill work mixed in,
        and optionally k finetune units, in one fused launch; ``bs == 0``
        is a prefill-only round (weight stream still paid). Reduces to
        ``colocated_round``/``decode_solo`` at chunk_tokens=0."""
        d = self.decode_work(bs, mean_ctx) if bs > 0 else DecodeWork(
            bytes_hbm=self.cfg.active_param_count() * 2.0, flops=0.0,
            ici_s=0.0)
        c = self.chunk_work(chunk_tokens, chunk_ctx) if chunk_tokens > 0 \
            else DecodeWork(0.0, 0.0, 0.0)
        total_bytes = d.bytes_hbm + c.bytes_hbm
        total_flops = d.flops + c.flops
        if k_units > 0:
            u = self.avg_unit_work(micro_batch, seq_len)
            total_bytes += k_units * u.bytes_hbm
            total_flops += k_units * u.flops
        t = self._fused(d, total_bytes, total_flops, k_units)
        return t * (self._noise() if noisy else 1.0)

    def unit_solo(self, micro_batch: int, seq_len: int,
                  backward: bool = False, noisy: bool = True) -> float:
        u = self.unit_work(micro_batch, seq_len, backward)
        t = max(u.bytes_hbm / self.inst.hbm_bw,
                u.flops / self.inst.peak_flops) + self.c.unit_overhead_s
        return t * (self._noise() if noisy else 1.0)

    def layer_swap_time(self, micro_batch: int, seq_len: int) -> float:
        """Host->HBM streaming of one layer's frozen weights (window swap)."""
        u = self.unit_work(micro_batch, seq_len)
        return u.layer_weight_bytes / self.inst.host_dma_bw

    # --------------------------------------------------------- utilization
    def decode_utilization(self, bs: int, mean_ctx: float):
        """(sm_util, bw_util) of a solo decode round — paper Fig. 4."""
        w = self.decode_work(bs, mean_ctx)
        t = self.decode_solo(bs, mean_ctx, noisy=False)
        bw_util = w.bytes_hbm / (t * self.inst.chip.hbm_bw * self.inst.tp)
        sm_util = w.flops / (t * self.inst.chip.peak_flops_bf16 * self.inst.tp)
        return sm_util, bw_util
