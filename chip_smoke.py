#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (`src/repro_torch`).

  python3 chip_smoke.py          # from the repository root, on a machine with one card

Phases, in order; any failure ends the run with a nonzero exit:
  1. environment: torch, the card, its power limit; build the CUDA kernels
     from `src/repro_torch/kernels/csrc` and print the build time;
  2. the paged decode kernel (K1, split-KV) against its plain torch version
     on the card at serving shapes (llama3-8b and qwen2.5-7b heads, bf16
     and f32, B in {1, 8}, 16 pages of 64 tokens; and B 1 with all 16 pages
     full, the long context where splitting matters most), timed beside its
     HBM bound, the plain version and one SDPA call over the same cache (a
     yardstick the port never calls); at the long context, K1 at split
     lengths of 32-1024 positions (the scan behind its split length);
  3. the main path: `ServingEngine(use_kernels=True)` captures its decode
     step as a CUDA graph (capture time and memory printed) and serves 16
     requests on full-width llama3-8b (random seeded bf16 weights, 8 slots,
     s_max 1024) by replaying it, with the kernel's launch count read just
     before and after (a replay counts its captured launches); then 20
     solo rounds at 8 slots eager and 20 graphed, in turns, and a profiler
     window over 5 of each (median, p90, busy share); then one decode step
     with and without the kernel on the same cache, and K1 timed on that
     cache, also at split lengths of 32-1024;
  4. a profiler window over decode steps: device time by kernel, the
     device's busy share, and the host's CUDA launch/copy/sync calls;
  5. the LoRA matmul kernels (K2) against their plain torch version on the
     card at the training path's shapes (M 2048: gate 4096->14336, k/v
     4096->1024, q/o 4096->4096, down 14336->4096, bf16; the transposed-W dx
     form of gate and down; q/o in both forms at scales 0.75, 1/3 and 0),
     each asserted by its counter to run on the wgmma kernel; a ragged
     37x200x130 bf16 case on the WMMA kernel; ragged
     37x200x130 and 128x256x128 in f32 on the FMA kernel; timed beside the
     bound, the plain version and a torch.matmul yardstick the port never
     calls; and the autograd Function's backward against autograd of the
     plain version;
  6. training at full width: one PEFT iteration of llama3-8b (the weights
     of phase 3, micro-batch 2 x 1024 tokens, accum 1) through the layer
     units with K2, its launches counted (32 x 7 + 32 x 14 = 672, all on the
     wgmma kernel), then the next microbatch's units with and without K2
     from that state, loss and grads held against each other, and the
     ratio of their times printed; then a profiler window over BWD units
     on both routes: their wall time beside the device's busy time; then
     the units captured as CUDA graphs (one per unit of the iteration) and
     two iterations eager and two replayed, in turns, synchronized per
     unit: medians by kind, K2's 672 launches per iteration either way;
  7. co-located serving: `ColocatedRunner(k_max=6, use_kernels=True)`
     captures the decode graph and the unit graphs (`precompile`), rounds
     with k = 0 and k > 0 units replayed and profiled, the latency
     predictor fit from them, and 16 requests (then more waves of 16,
     until the serving has run an iteration's worth of units and an OPT)
     served through graphed rounds and the QoS scheduler (the target by
     PRs 12-15's rule), K1 and K2 launches counted; and the mean k the
     fitted predictor admits under the paper's 40 ms. Then the reference's
     route: `fit_from_costmodel` on the cost model of llama3-8b on the H100
     spec with the committed constants, held beside the profile fit (solo
     and co-located error on the measured points, mean k under 40 ms), and
     16 requests served co-located with it under the same target.
Then the llama3 objects are freed and the peak-memory count reset:
  8. the SSD scan kernels (K3) against their plain torch version on the
     card at mamba2-780m's prefill shapes (nh 48, hd 64, ds 128, chunk 256;
     B 1 and 2, S 64/71/256/300/512; xs/Bt/Ct bf16 slices of one conv
     output and dt f32, h0 zeros; a random h0; one all-f32 case), each
     asserted by its counters to run the chunk-parallel tensor-core kernel
     (bf16) or the FMA kernel (f32), and both against an f64 token-by-token
     recurrence (the witness), timed beside the bound (bf16 tensor-core
     peak for bf16, f32 peak for f32; the f32-peak figure printed beside
     it) and the plain version (no single torch call computes the SSD
     scan, so there is no library yardstick); at B 1 S 512 K3 also against
     `ssd_split_emulation` (its own arithmetic in plain torch), and a
     profiler window over that case: each of its three kernels' device us
     per launch and the three together per call;
  9. the SSM serving path: `ServingEngine(use_kernels=True)` serves 16
     requests on full-width mamba2-780m (48 layers, d 1536, random seeded
     bf16 weights, 8 slots, s_max 1024) from its decode graph, every
     admission's prefill (eager) through K3's tensor-core kernel (48
     launches each, asserted by the counters); the eager/graphed A/B of
     phase 3;
     a profiled prefill of 1 x 300 tokens (K3's share of its device time);
     then 4 prompts of 300 tokens prefilled with K3,
     with the plain f32 scan, with the f64 witness and with the split
     emulation as the scan, on the same weights (logits and final state
     held against the witness's; the emulation's own distance printed
     beside K3's, to tell the split's expected error from a fault), and
     a profiler window over 5 decode steps (plain torch: the reference's
     SSM decode has no kernel);
 10. co-located mamba2-780m: phase 7 on phase 9's weights and engine
     (LoRA is the parallel `ssm_io` adapter, so the units launch no K2;
     they keep the differentiable plain scan), K3's launches from the
     admissions counted (48 per prefill), no plain call.
Then the mamba2 objects are freed:
 11. h2o-danube-1.8b, whole (24 layers, d 2560, 32 heads / 8 KV of hd 80,
     window 4096), served past its window: `ServingEngine(use_kernels=
     True)` with 8 slots and s_max 4608, so each slot's cache is a ring of
     4096; 16 requests of 3,900-4,500 prompt tokens (seeded) and 32 new
     tokens from the decode graph, K1's launches held at 24 per round;
     then 8 prompts of 4,097-4,500 tokens admitted and K1 on their layer-0
     rings (wrapped by the prefill's split write) against its plain
     version and the windowed dense oracle, timed beside its byte bound,
     the plain version and SDPA, and again on their layer-0 and last
     layer's rings after 8 served decode rounds; the eager/graphed A/B
     and a graphed decode step bit-equal to the eager one;
 12. mixtral-8x7b at published width (d 4096, 32 heads / 8 KV of 128, 8
     experts of 14336, top-2, window 4096) with 16 of its 32 layers (all
     32 are 93.4 GB of bf16 weights; one card has 80 GB): every MoE
     layer's expert shares, dropped share and token cosine on 2 x 1024
     uniform and corpus tokens, `moe_forward` on the first and the last
     layer held against `moe_plain` (a per-expert loop); served as
     phase 3 (graphed, the A/B, a decode step bit-equal to the eager one;
     the MoE layers' dropped share in the admissions' prefills); its
     finetune units (LoRA r 16 on q/k/v/o, micro-batch 2 x 1024, accum 1,
     36 units per iteration): one eager iteration (K2's launches by
     route, all wgmma; the dropped share in training), then eager and
     graphed iterations in turns, medians by kind; then co-located as
     phase 7, with a graphed 6-unit round bit-equal to the eager one.
Then the cost model's H100 constants are fitted by least squares from the
graphed solo rounds of phases 7 and 10 (mixtral's are printed, not fitted),
phase 6's FWD and BWD units and phase 7's co-located rounds, and the
committed and fitted constants' error printed at every profiled point.
Then the mixtral objects are freed:
 13. the finetune entry point, `launch/train.py`'s `main(argv)` on
     full-width llama3-8b with `--use-kernels` (micro-batch 2 x 1024): 6
     steps uninterrupted (a checkpoint every 3), and 3 steps then
     `--resume` to 6 in a second directory, the two final states held leaf
     by leaf (adapters, m, v, t) and their checkpoints file by file; K2's
     launches per step, all wgmma by its counters; 2 steps of
     `--layer-units` (graphed units); a blocking save of the state timed
     (the device-to-host copy alone and the whole commit) beside
     `CostModel.checkpoint_time()` on the H100 spec.
Then the llama3 state is freed:
 14. deepseek-v3-671b at published width (d 7168, 128 heads, MLA q/kv
     rank 1536/512, rope 64, nope 128, v 128; 3 dense layers of d_ff
     18432; 256 experts of 2048, top-8, sigmoid router, one shared expert;
     vocab 129280; MTP) with 5 of its 61 layers (its 3 dense layers and 2
     MoE: 54.6 GB of bf16 weights, one card holds about 3 MoE layers):
     its bytes by part beside the reckoning; both MoE layers against
     `moe_plain` and their expert shares; served as phase 12 (16 requests
     from the decode graph, no K1 or other kernel: MLA decode has none in
     the reference either; the A/B, a graphed step bit-equal to the eager
     one), the solo round beside its weight-read bound and the cost
     model's solo round; the absorbed MLA decode against the unabsorbed
     form (K/V expanded from the latent) on the first and last layer's
     served caches; a 300-token prefill and a decode step against the
     full forward's logit at the served top-8 (both paths' routing of
     the decoded token printed per MoE layer; where a bf16 rounding swaps
     an expert, the decode is held with its routing pinned to the
     forward's); its units (LoRA r 16 on q/o/gate/up/down:
     EMBED and EMBED_BWD run the 3 dense layers' adapters) by kind with
     K2's launches held at the plan's count, all wgmma; one one-shot
     `make_train_step` step (its MTP loss on the card); then co-located
     as phase 7. Phase 5 also holds K2 at every shape phase 14 launches
     it at (MLA q 1536 -> 24576, o 16384 -> 7168, dense 7168 <-> 18432,
     shared expert 7168 <-> 2048, each forward and in the dx form W^T),
     and the Function's backward at MLA q and the dense down; and at the
     projections of phases 15-16 (recurrentgemma q/o 2560 -> 2560, k/v
     2560 -> 256, gate/up 2560 -> 7680, down 7680 -> 2560; phi-3-vision
     q/k/v/o 3072 -> 3072, gate/up 3072 -> 8192, down 8192 -> 3072;
     seamless-m4t-large-v2 q/k/v/o 1024 -> 1024, gate/up 1024 -> 8192,
     down 8192 -> 1024), each forward and W^T.
Then the deepseek objects are freed:
 15. recurrentgemma-2b, whole (26 layers: 8 "rra" superblocks of two
     RG-LRU layers and local attention, then 2 RG-LRU layers in "post";
     d 2560, 10 heads / 1 KV of hd 256, window 2048, vocab 256000 tied):
     its parameter count against the configuration's; served from the
     decode graph at 8 slots and s_max 3072 (rings of 2048), 16 prompts
     of 1,900-2,600 tokens (seeded) and 32 new tokens, K1's launches held
     at 8 (its attention layers) per round; 8 prompts of 2,049-2,600
     tokens admitted and served 8 rounds, then K1 at hd 256 (MQA, g 10)
     on the first and last attention layer's wrapped rings against its
     plain version and the windowed oracle, timed beside its byte bound,
     the plain version and SDPA; the A/B, the solo round beside its
     read bound and the cost model's, a graphed step bit-equal to the
     eager one; a 2,100-token prefill and a decode step against the
     forward; the units by kind (LoRA r 16 on gate/up/down, q/k/v/o and
     the parallel rg_io; K2 at the plan's count, 324 an iteration, all
     wgmma), one step of `launch/train.py` (330 K2 launches), and
     co-located as phase 7 (peak memory printed).
Then the recurrentgemma objects are freed:
 16. phi-3-vision-4.2b, whole (32 layers, d 3072, 32 heads of hd 96,
     d_ff 8192, vocab 32064), each request with 576 stub patch
     embeddings ahead of its prompt: served from the decode graph at 8
     slots and s_max 1152, 16 prompts of 64-500 tokens, K1 on every layer
     of every round, each slot's last position written held at the
     patches + prompt + decoded tokens; K1 at hd 96 on the served caches
     of 8 requests after 8 rounds (first and last layer) against its
     plain version and the dense oracle, timed beside its bound and
     SDPA; the A/B, a graphed step bit-equal to the eager one; a
     500-token prefill after 576 patches and a decode step against the
     forward; units whose microbatch holds 576 + 1,024 positions by kind
     (672 K2 launches an iteration), one `launch/train.py` step (669),
     and a co-located serve as phase 7.
Then the phi-3-vision objects are freed:
 17. seamless-m4t-large-v2, whole (24 encoder and 24 decoder layers, d
     1024, 16 heads of hd 64, d_ff 8192, vocab 256206 untied; 2.03 B
     parameters), each request with 256 stub encoder frames: its
     parameter count held at the configuration's; served from the decode
     graph at 8 slots and s_max 1024, 16 prompts of 64-512 tokens, K1 on
     every decoder layer's self-attention (24 launches a round; the
     cross-attention reads the cached K/V in plain torch, as in the
     reference); a 300-token prefill split into the encoder and the
     decoder; K1 at hd 64 (g 1) on the served caches of 8 requests after 8
     rounds against its plain version and the dense oracle, timed beside
     its bound and SDPA; the A/B, the round beside the bytes it reads by
     part, a graphed step bit-equal to the eager one; a 300-token prefill
     and a decode step against the forward; the units by kind (EMBED runs
     the 24-layer encoder over 2 x 512 frames; 504 K2 launches an
     iteration), two one-shot steps of `launch/train.py` (501 each) and
     one --layer-units step, and a co-located serve as phase 7.
Then the seamless objects are freed:
 18. llama3-8b with an int8 KV cache (`kv_quant`; the weights of phase 3,
     made anew from seed 0): its cache bytes beside phase 3's bf16 cache;
     phase 3's 16 requests served from the decode graph, every attention
     layer's decode through `decode_attn_ref` with the scales (32 oracle
     decodes a round, counted; no K1: the reference has no int8 kernel
     path either), the greedy tokens against phase 3's; the A/B and a
     graphed step bit-equal to the eager one; the first decode step's
     logits from an int8 and a bf16 cache on 8 prompts of 300 tokens,
     within 5 % of the largest |logit|; 16 requests served co-located with
     the predictor fit from the cost model (no profiling).
 19. the recompute-backward flash attention (`layers.flash_attention`, an
     autograd Function whose backward recomputes the softmax blocks from
     the saved log-sum-exp) against `flash_attention_plain` (its forward
     under plain autograd) at llama3-8b's training shape (B 2, S 1024, 32
     heads / 8 KV of hd 128) and deepseek-v3's dense MLA shape (128 heads,
     qk 192, v 128), bf16: o, dq, dk, dv at 3e-2 of the largest |value|,
     forward + backward timed (CUDA events, median of 30), the memory
     each allocates above its inputs, and the forward alone under no_grad.
     Phases 6, 12 and 14-17 print each unit kind's graphed time and the
     peaks; EMBED_BWD recomputes no layer, so K2 launches twice for each
     adapted projection of a "pre" layer there.
 20. the mesh layout layer on the one card: a 1x1 ("data", "model")
     DeviceMesh on cuda (NCCL, world size 1); phase 13's checkpoint
     restored onto it with `adapter_specs`, bit-equal to the single-card
     restore; llama3-8b's weights laid out by `param_specs`; one one-shot
     train step under `use_mesh` against the plain step (kernels off,
     none launched): loss, adapters and AdamW moments bit-equal, only the
     loss's `gather` run replicated; times printed. Nothing here measures a layout over
     more than one card.
 21. the dry-run tooling: on the single-process `fake` process group
     (world 512) and a "cuda"-typed 16x16 mesh, `launch/dryrun.py`'s
     qwen3-8b x decode_32k x single cell and `launch/colocated_dryrun.py`'s
     llama3-8b decode round + 4 qwen2.5-7b units, each on meta tensors
     (ok, wall time, resident GB per device against 80 GB, dot FLOPs,
     collective bytes by kind and the ops run replicated printed; a cell
     that fails fails the run); then the per-device counts held against
     the card: qwen3-8b's decode_32k step at batch 4 (16.4 GB of weights,
     a 19.3 GB cache) and train_4k step at batch 1, each counted once on
     meta tensors (`step_analysis`) and once for real on the card with
     random weights and no kernel under the same counters: the FLOPs
     equal, the resident estimate within 1 % of `max_memory_allocated`
     above what was allocated before the inputs; each step's time (CUDA
     events, median of 5) beside its roofline bound.
The second line from the end lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the repository
around it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain: bf16 rounds the output once (2^-8 relative); f32 sums in
# another order than the plain einsum
K1_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the same, as max error over the RMS of the plain output: a dropped page or
# a wrong tile moves outputs by about their own size; one bf16 rounding of
# an element a few times the RMS stays under 2e-2
K1_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# decode step with the kernel vs the dense oracle, full width: the oracle
# rounds its softmax weights to bf16 before PV and the kernel keeps them in
# f32; 32 bf16 layers carry that difference to logits of size ~4
LOGIT_TOL = 0.25
K1_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
K1_REPLACES = "src/repro/kernels/decode_attention.py:76"
K2_SOURCE = "src/repro_torch/kernels/csrc/lora_matmul.cu"
K2_REPLACES = "src/repro/kernels/lora_matmul.py:52"
# K2 vs plain (tests/test_kernels.py's tolerances): bf16 rounds the output
# (and xa) once, f32 sums in another order. Also max error over the RMS,
# against the plain version before its final rounding: half a bf16 ulp of
# an output up to 8x the RMS is 1.6e-2, while against the rounded plain
# output a single flipped rounding of an output in [4, 8) x RMS (thousands
# of them among 29M Gaussian outputs) would read 3.1e-2
K2_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
K2_REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# the Function's backward vs autograd of the plain version: dA and dB are
# bf16 products of bf16-rounded rank-r intermediates on the kernel side
K2_BWD_REL_TOL = 5e-2
# phase 6, units with K2 vs without: the loss relative, each accumulated
# grad by its relative Frobenius error. The two paths round the adapted
# projections at other points (once vs three times), and that bf16 noise
# alone moves single grad entries: on the CPU at smoke width the per-leaf
# max error over RMS is 0.14-0.20 while the Frobenius error is 0.02-0.03
# (tests/test_torch_training.py measures the same against the reference).
# The max error over RMS is printed beside it.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_FROB_TOL = 5e-2
K3_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
K3_REPLACES = "src/repro/kernels/ssd_scan.py:71"
# K3 vs plain (tests/test_kernels.py's SSD tolerance, atol and rtol): both
# compute in f32 from the same inputs, in another order of the sums (and
# the kernel's decay cumsum in double; on the tensor-core kernel, each f32
# operand of a product as bf16 hi + lo, ~2^-17 relative)
K3_TOL = 2e-3
# phase 9, a full-width mamba2 prefill of 4 x 300 tokens with K3, held
# against the same prefill with its scan in float64 (`ssd_f64_witness`).
# Layer 0's state sees identical inputs on both: K3's tolerance. Deeper,
# each bf16 rounding that falls the other way is carried through 48
# layers. On the H100 the plain f32 scan, the reference's own form, reads
# 0.2109 in the logits and 3.5e-2 in all layers' h from the witness, K3
# 0.1523 and 2.3e-2 (PERF.md, section 6): the limits admit the plain
# scan's own distance, with the logits at K1's decode-step limit
MAMBA_H0_TOL = K3_TOL
MAMBA_LOGIT_TOL = LOGIT_TOL
MAMBA_H_TOL = 5e-2


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


_FLUSH = None


# cycles of the device-side wait before each timed call: ~1 ms at the
# H100's 1.98 GHz, more than a call's host work (a K3 call: ~0.14 ms)
HOST_LEAD_CYCLES = 2_000_000


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call, by CUDA events; the 50 MB L2 is
    overwritten before each call, as a decode round's weight reads do.
    Then the device waits ~1 ms before the start event, so that the host
    has enqueued the whole call by the time the device reaches it: the
    events time the device, not the host's work between launches."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_rows(prof):
    """(name, device us, count) of a profiler window's device-side events
    (a host op's row repeats its kernels' time, so those are left out)."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


def captured(label, precompile):
    """Run a `precompile` (CUDA graph capture: a warm-up for real, then
    the captures) and print its wall time and memory (`graphs.measured`).
    """
    from repro_torch.core import graphs as G
    secs, alloc, reserved = G.measured(precompile, "cuda")
    log(f"graphs: {label} captured in {secs:.2f} s; memory_allocated "
        f"+{alloc / 1e6:.1f} MB (static buffers), memory_reserved "
        f"+{reserved / 1e6:.1f} MB (the graph pool and those buffers)")


def peaks(label):
    log(f"{label}: max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} "
        f"max_memory_reserved_gb={torch.cuda.max_memory_reserved() / 1e9:.3f}"
        f" (graphs held)")


def clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def same_bits(a, b) -> bool:
    """Two trees of tensors and host ints, bit for bit."""
    from repro_torch.tree import tree_leaves
    return all((x == y) if isinstance(x, int) else torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def graphed_decode_bits(label, params, cfg, cache, tok, pos):
    """A decode step captured anew on `cache` and replayed, against the
    eager step on a copy of the cache: logits and cache bit for bit."""
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import DecodeGraph
    cache_e = clone_tree(cache)
    logits_e, _ = MD.decode_step(params, cfg, tok, pos, cache_e,
                                 use_kernels=True)
    graph = DecodeGraph(params, cfg, cache, use_kernels=True)
    logits_g = graph(tok, pos, cache)
    torch.cuda.synchronize()
    ok = torch.equal(logits_g, logits_e) and same_bits(cache, cache_e)
    log(f"{label}: a graphed decode step vs the eager step at full width, "
        f"logits and cache bit-equal: {ok}")
    if not ok:
        raise AssertionError(f"{label}: the graphed decode step differs "
                             "from the eager one")


def ab_solo_rounds(eng, cfg, label, rounds=20, block=5, profiled=5):
    """Solo decode rounds at 8 full slots, eager (`eng.graphs = False`) and
    replayed from the decode graph, in turns (E G G E ...: blocks of
    `block` rounds, `rounds` of each), then a profiler window over
    `profiled` rounds of each: round median, p90 and the device's busy
    share. The 8 requests are admitted first and finish in the last
    round."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.request import Request
    rng = np.random.default_rng(11)
    n_rounds = 2 * (rounds + profiled)
    reqs = [Request(rid=10_000 + i, arrival=0.0,
                    prompt_len=int(rng.integers(64, 513)),
                    max_new_tokens=n_rounds + 1) for i in range(8)]
    for r in reqs:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32),
                             eng._stub_extras(r)):
            raise AssertionError("the A/B's requests were not admitted")
    times = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager") * \
            (rounds // (2 * block)):
        eng.graphs = mode == "graphed"
        for _ in range(block):
            eng.decode_round()
            times[mode].append(eng.metrics.round_s[-1])
    busy = {}                   # mode: (share, device ms, events) per round
    for mode in ("eager", "graphed"):
        eng.graphs = mode == "graphed"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(profiled):
                eng.decode_round()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        rows = device_rows(prof)
        busy[mode] = (sum(r[1] for r in rows) / 1e6 / window,
                      sum(r[1] for r in rows) / 1e3 / profiled,
                      sum(r[2] for r in rows) / profiled)
    eng.graphs = True
    if not all(r.phase.value == "done" for r in reqs):
        raise AssertionError("the A/B's requests did not finish")
    out = {}
    for mode in ("eager", "graphed"):
        ts = times[mode]
        out[mode] = (statistics.median(ts), float(np.percentile(ts, 90)))
        log(f"{label} A/B {mode:7s}: {len(ts)} solo rounds at 8 slots in "
            f"turns, round_ms_median={1e3 * out[mode][0]:.3f} "
            f"round_ms_p90={1e3 * out[mode][1]:.3f}; profiled "
            f"{profiled} rounds: busy share {busy[mode][0]:.3f} (of the "
            f"profiled window, the profiler's host cost in it), device busy "
            f"{busy[mode][1]:.3f} ms per round = "
            f"{busy[mode][1] / 1e3 / out[mode][0]:.3f} of the unprofiled "
            f"median round, device events per round {busy[mode][2]:.1f}")
    log(f"{label} A/B: graphed / eager round median "
        f"{out['graphed'][0] / out['eager'][0]:.3f}")
    return out


def k1_bound_ms(q, k_pages, page_table, lengths):
    """Least time for the same work: each input byte read once (q, the K/V
    rows that are valid in this run's data, table, lengths), the output
    written once; flops 4 * valid tokens * H * hd over the type's peak."""
    B, H, hd = q.shape
    ptok, KV = k_pages.shape[1], k_pages.shape[2]
    pt = page_table.cpu().numpy()
    ln = lengths.cpu().numpy()
    per_page = np.clip(ln[:, None] - ptok * np.arange(pt.shape[1])[None],
                       0, ptok)
    tokens = int((per_page * (pt >= 0)).sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * tokens * KV * hd * item
              + page_table.numel() * 4 + lengths.numel() * 4)
    flops = 4 * tokens * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_call(q, k_pages, v_pages, page_table, lengths):
    """One scaled_dot_product_attention over the dense gather of the same
    pages (gathered outside the timed call)."""
    B, n = page_table.shape
    _, ptok, KV, hd = k_pages.shape
    idx = page_table.long().clamp(min=0)
    k = k_pages[idx].reshape(B, n * ptok, KV, hd).transpose(1, 2).contiguous()
    v = v_pages[idx].reshape(B, n * ptok, KV, hd).transpose(1, 2).contiguous()
    pos = torch.arange(n * ptok, device=q.device)
    valid = (pos[None] < lengths[:, None]) & \
        (page_table >= 0).repeat_interleave(ptok, dim=1)
    mask = valid[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def check_k1(K, q, kp, vp, pt, lengths, label):
    """Kernel vs plain on one input; returns the kernels-line numbers."""
    got = K.paged_decode_attention(q, kp, vp, pt, lengths)
    expect = K.paged_decode_attention_plain(q, kp, vp, pt, lengths)
    torch.cuda.synchronize()
    err = (got.float() - expect.float()).abs().max().item()
    tol, rel_tol = K1_TOL[q.dtype], K1_REL_TOL[q.dtype]
    rel = err / expect.float().square().mean().sqrt().item()
    ok = torch.allclose(got.float(), expect.float(), atol=tol, rtol=tol) \
        and rel <= rel_tol
    lib = sdpa_call(q, kp, vp, pt, lengths)
    lib_err = (lib().float() - expect.float()).abs().max().item()
    ms = time_ms(lambda: K.paged_decode_attention(q, kp, vp, pt, lengths))
    plain_ms = time_ms(
        lambda: K.paged_decode_attention_plain(q, kp, vp, pt, lengths))
    library_ms = time_ms(lib)
    bound_ms, bound_by = k1_bound_ms(q, kp, pt, lengths)
    log(f"K1 {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"max_err_over_rms={rel:.3e} (tol {rel_tol}) ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(sdpa err {lib_err:.3e}) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"bound_share={bound_ms / ms:.3f}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def k1_split_scan(K, args, label):
    """K1 on one input at split lengths of 32 (one tile) to 1024 (one split
    of the whole table), each held against the plain version and timed: the
    scan behind `SPLIT_TOKENS`, which is set for the scan and restored."""
    chosen = K.SPLIT_TOKENS
    expect = K.paged_decode_attention_plain(*args).float()
    tol, rel_tol = K1_TOL[args[0].dtype], K1_REL_TOL[args[0].dtype]
    times = {}
    try:
        for split in (32, 64, 128, 256, 1024):
            K.SPLIT_TOKENS = split
            got = K.paged_decode_attention(*args).float()
            rel = (got - expect).abs().max().item() / \
                expect.square().mean().sqrt().item()
            if not torch.allclose(got, expect, atol=tol, rtol=tol) or \
                    rel > rel_tol:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at split length {split}: {label}")
            times[split] = time_ms(lambda: K.paged_decode_attention(*args))
    finally:
        K.SPLIT_TOKENS = chosen
    log(f"K1 split scan, {label}: ms by split length "
        f"{ {k: round(v, 4) for k, v in times.items()} } (SPLIT_TOKENS "
        f"{chosen}), each within tolerance of the plain version")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def k1_inputs(B, H, KV, hd, ptok, npg, dtype, seed, full=False):
    """Random q, pages and a permuted page table; a skipped page and random
    lengths (the last sequence of 1 token), or with `full` every page real
    and every sequence at the table's length."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = B * npg + 2

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, kp, vp = randn(B, H, hd), randn(P, ptok, KV, hd), randn(P, ptok, KV, hd)
    pt = torch.randperm(P, generator=g, device="cuda")[:B * npg]
    pt = pt.reshape(B, npg).to(torch.int32)
    if full:
        return q, kp, vp, pt, torch.full((B,), npg * ptok, dtype=torch.int32,
                                         device="cuda")
    pt[0, -1] = -1                                  # a skipped page
    lengths = torch.randint(1, npg * ptok + 1, (B,), generator=g,
                            device="cuda").to(torch.int32)
    if B > 1:
        lengths[-1] = 1
    return q, kp, vp, pt, lengths


# ------------------------------------------------------------------ K2 ----
def k2_bound_ms(M, K, N, r, dtype):
    """Least time for the same work: x, W, A, B read once and y written
    once; 2*M*K*N + 2*M*K*r + 2*M*r*N flops over the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (M * K + K * N + K * r + r * N + M * N) * item
    flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k2_inputs(M, K, N, r, dtype, trans, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)
    x = randn(M, K)
    # W at the model's init scale; A as the adapters' init, B drawn too
    w = randn(N, K, scale=K ** -0.5).t() if trans else \
        randn(K, N, scale=K ** -0.5)
    return x, w, randn(K, r, scale=K ** -0.5), randn(r, N, scale=0.05)


K2_COUNTERS = ("LAUNCHES_WGMMA", "LAUNCHES_WMMA", "LAUNCHES_F32")


def check_k2(K2, x, w, a, b, scale, label, kernel):
    """K2 vs plain on one input, timed; asserts by the counters that the
    call ran on `kernel` ("wgmma", "wmma" or "f32"); returns the
    kernels-line numbers."""
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    before = [getattr(K2, c) for c in K2_COUNTERS]
    got = K2.lora_matmul(x, w, a, b, scale)
    ran = [getattr(K2, c) - n for c, n in zip(K2_COUNTERS, before)]
    expect_ran = [int(c == f"LAUNCHES_{kernel.upper()}") for c in K2_COUNTERS]
    expect = K2.lora_matmul_plain(x, w, a, b, scale)
    unrounded = K2.lora_matmul_plain(x.float(), w, a, b, scale)
    torch.cuda.synchronize()
    err = (got.float() - expect.float()).abs().max().item()
    rel = (got.float() - unrounded).abs().max().item() / \
        unrounded.square().mean().sqrt().item()
    tol, rel_tol = K2_TOL[x.dtype], K2_REL_TOL[x.dtype]
    ok = torch.allclose(got.float(), expect.float(), atol=tol, rtol=tol) \
        and rel <= rel_tol
    ms = time_ms(lambda: K2.lora_matmul(x, w, a, b, scale))
    plain_ms = time_ms(lambda: K2.lora_matmul_plain(x, w, a, b, scale),
                       iters=10)
    library_ms = time_ms(lambda: x @ w + scale * ((x @ a) @ b))
    bound_ms, bound_by = k2_bound_ms(M, K, N, r, x.dtype)
    log(f"K2 {label}: M={M} K={K} N={N} r={r} {str(x.dtype)[6:]} "
        f"w_trans={int(not w.is_contiguous())} kernel="
        f"{K2._k2_path(M, N, K, r, x.dtype)} (launches wgmma/wmma/f32 "
        f"{ran}, expected {kernel}) max_abs_err={err:.3e} "
        f"(tol {tol}) max_err_over_rms={rel:.3e} (vs the unrounded plain "
        f"output; tol {rel_tol}) ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) "
        f"bound_share={bound_ms / ms:.3f} "
        f"tflops={2 * M * K * N / ms / 1e9:.1f}")
    if ran != expect_ran:
        raise AssertionError(f"K2 {label} did not run on the {kernel} kernel")
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {label}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_k2_backward(K2, kops, M, K, N, r):
    """The Function's backward (dx through K2 with W read transposed, dA and
    dB by torch.matmul) against autograd of the plain version, bf16."""
    x, w, a, b = k2_inputs(M, K, N, r, torch.bfloat16, False, seed=21)
    dy = k2_inputs(M, N, 1, 1, torch.bfloat16, False, seed=22)[0]
    out = {}
    for name, fn in (("kernel", kops.lora_matmul),
                     ("plain", K2.lora_matmul_plain)):
        xs, as_, bs = (t.detach().clone().requires_grad_() for t in (x, a, b))
        fn(xs, w, as_, bs, 2.0).backward(dy)
        out[name] = (xs.grad, as_.grad, bs.grad)
    torch.cuda.synchronize()
    for what, got, expect in zip(("dx", "dA", "dB"), out["kernel"],
                                 out["plain"]):
        err = (got.float() - expect.float()).abs().max().item()
        rel = err / expect.float().square().mean().sqrt().item()
        log(f"K2 backward {what}: M={M} K={K} N={N} r={r} bf16 "
            f"max_abs_err={err:.3e} max_err_over_rms={rel:.3e} "
            f"(tol {K2_BWD_REL_TOL})")
        if rel > K2_BWD_REL_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"K2 backward {what} disagrees with "
                                 "autograd of the plain version")


def grad_agreement(got, expect):
    """Per-leaf max error over the leaf's RMS and relative Frobenius error,
    worst over the leaves of two {name: {"a", "b"}} trees of stacked
    (layer, ...) grads; also where the worst max error sits."""
    worst_rel, worst_frob, where = 0.0, 0.0, "-"
    for name in sorted(expect):
        for ab in ("a", "b"):
            g, e = got[name][ab].double(), expect[name][ab].double()
            if not e.any():             # dA while B is still 0: exactly 0
                if g.any():
                    return float("inf"), float("inf"), f"{name}.{ab}"
                continue
            diff = (g - e).abs()
            rel = diff.max().item() / e.square().mean().sqrt().item()
            if rel > worst_rel:
                layer = int(diff.flatten().argmax()) // diff[0].numel()
                worst_rel, where = rel, f"{name}.{ab} layer {layer}"
            worst_frob = max(worst_frob, ((g - e).norm() / e.norm()).item())
    return worst_rel, worst_frob, where


def k2_projections(cfg, kind):
    """The adapted projections of one layer of `kind` that go through K2:
    its targets but the parallel `ssm_io`/`rg_io` adapters (plain
    products); a hybrid superblock's, summed over its sub-layers."""
    from repro_torch.models import lora as LR
    from repro_torch.models import model as MD
    if kind == "hybrid_block":
        return sum(k2_projections(cfg, MD._sub_kind(ch))
                   for ch in cfg.hybrid_pattern)
    kind = {"dec": "attn"}.get(kind, kind)     # the cross-attention: none
    return len(set(LR._target_dims(cfg, kind)) - {"ssm_io", "rg_io"})


def k2_per_unit(cfg):
    """K2 launches of one unit by kind, from the layer plan: one per
    adapted projection of a layer in FWD, two (forward and dx) in BWD; the
    "pre" layers' in EMBED (forward) and EMBED_BWD (forward and dx: no
    per-layer checkpoint recomputes them, less the first layer's
    projections whose input depends on no adapter: q/k/v of GQA, q of
    MLA); the "post" layers' twice (forward, dx) in HEAD; none in OPT.
    llama3: FWD 7, BWD 14 (q/k/v/o/gate/up/down); mixtral: 4 and 8
    (q/k/v/o: the routed experts take no adapters); deepseek-v3 at 3 dense
    + 2 MoE layers: EMBED 15, FWD 5, BWD 10, EMBED_BWD 29 (44 with a
    per-layer checkpoint); recurrentgemma-2b: FWD 13 (2 x gate/up/down +
    7), BWD 26, HEAD 12 (its 2 post RG-LRU layers)."""
    from repro_torch.models import model as MD
    pre, scan_kind, _, post = MD._plan(cfg)
    n = k2_projections(cfg, scan_kind)
    n_pre = sum(k2_projections(cfg, kind) for kind in pre)
    return {"FWD": n, "BWD": 2 * n, "EMBED": n_pre,
            "EMBED_BWD": 2 * n_pre - first_layer_no_dx(cfg) if pre else 0,
            "HEAD": 2 * sum(k2_projections(cfg, kind) for kind in post)}


def first_layer_no_dx(cfg):
    """The first layer's adapted projections whose input depends on no
    adapter, so that autograd asks K2 for no dx: the attention inputs
    (none when the first layer is an RG-LRU block, whose MLP input has
    passed its rg_io adapter)."""
    from repro_torch.models import lora as LR
    if cfg.layer_kind(0) != "attn" and cfg.layer_kind(0) != "moe":
        return 0
    dims = LR._target_dims(cfg, "attn")
    return len(set(dims) & ({"q"} if cfg.mla else {"q", "k", "v"}))


def k2_per_iteration(cfg, unit, total):
    """K2 launches of `total` units of `unit` from its current index 0:
    the sum of `k2_per_unit` over the units' kinds."""
    per = k2_per_unit(cfg)
    return sum(per.get(unit.kind(i), 0) for i in range(total))


def timed_unit_run(unit, step, state, n):
    """n units through `step`, synchronized after each: (state, {kind:
    [s]}), the kinds read from the unit engine `unit`."""
    times = {}
    for _ in range(n):
        kind = unit.kind(state["unit_idx"])
        t0 = time.perf_counter()
        state = step(state)
        torch.cuda.synchronize()
        times.setdefault(kind, []).append(time.perf_counter() - t0)
    return state, times


def phase5_k2(cfg):
    """K2 against its plain version at the training path's shapes, timed;
    the Function's backward against autograd of the plain version. Returns
    the kernels-line numbers of the gate/up forward."""
    from repro_torch.kernels import lora_matmul as K2
    from repro_torch.kernels import ops as kops
    # ------------------------------------------- 5. K2 vs plain, on card --
    d, ff, kv = cfg.d_model, cfg.d_ff, cfg.num_kv_heads * cfg.head_dim
    r = cfg.lora.rank
    scale = cfg.lora.alpha / cfg.lora.rank
    M = 2 * 1024                                # micro-batch 2 x seq 1024
    k2_cases = [("gate/up", M, d, ff, torch.bfloat16, False, "wgmma"),
                ("k/v", M, d, kv, torch.bfloat16, False, "wgmma"),
                ("down", M, ff, d, torch.bfloat16, False, "wgmma"),
                ("dx of gate/up", M, ff, d, torch.bfloat16, True, "wgmma"),
                ("dx of down", M, d, ff, torch.bfloat16, True, "wgmma"),
                ("ragged", 37, 200, 130, torch.float32, False, "f32"),
                ("small", 128, 256, 128, torch.float32, False, "f32"),
                ("q/o", M, d, d, torch.bfloat16, False, "wgmma"),
                ("ragged bf16", 37, 200, 130, torch.bfloat16, False, "wmma")]
    k2_rows = {}
    for i, (label, m_, k_, n_, dtype, trans, kernel) in enumerate(k2_cases):
        x, w, a, b = k2_inputs(m_, k_, n_, r if m_ == M else 4, dtype,
                               trans, seed=11 + i)
        k2_rows[label] = check_k2(K2, x, w, a, b, scale, label, kernel)
    # the wgmma epilogue's acc = (acc / s + xa @ B) * s is exact at the
    # training path's s = 2; at a scale that is not a power of two each
    # scaling rounds once in f32, and s = 0 skips xa @ B: both W forms, the
    # same tolerances
    for i, s_ in enumerate((0.75, 1 / 3, 0.0)):
        for trans in (False, True):
            x, w, a, b = k2_inputs(M, d, d, r, torch.bfloat16, trans,
                                   seed=31 + 2 * i + trans)
            check_k2(K2, x, w, a, b, s_, f"q/o, s={s_:.4g}, "
                     f"{'dx form (W^T)' if trans else 'W'}", "wgmma")
    check_k2_backward(K2, kops, M, d, kv, r)
    return dict(k2_rows["gate/up"], shape=f"M {M} K {d} N {ff} r {r} bf16 "
                "(gate/up forward)", other_shapes=dict(
                    deepseek_k2_cases(K2, kops, M),
                    **model_k2_cases(K2, M, "recurrentgemma-2b"),
                    **model_k2_cases(K2, M, "phi-3-vision-4.2b"),
                    **model_k2_cases(K2, M, "seamless-m4t-large-v2")))


def model_k2_cases(K2, M, arch):
    """K2 against its plain version at the adapted projections of `arch`
    (q/o, k/v, gate/up, down; r 16, scale 2), each forward (W) and in the
    dx form (W^T), at the bf16 tolerances. Returns the kernels-line rows
    by projection."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    r, scale = cfg.lora.rank, cfg.lora.alpha / cfg.lora.rank
    d, ff = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {}                 # (K, N): the projections of that shape
    for name, k_, n_ in (("q", d, q), ("k", d, kv), ("v", d, kv),
                         ("o", q, d), ("gate", d, ff), ("up", d, ff),
                         ("down", ff, d)):
        shapes.setdefault((k_, n_), []).append(name)
    rows = {}
    for i, ((k_, n_), names) in enumerate(shapes.items()):
        for trans in (False, True):
            kk, nn = (n_, k_) if trans else (k_, n_)
            label = f"{'/'.join(names)}{' dx (W^T)' if trans else ''} " \
                f"({arch})"
            x, w, a, b = k2_inputs(M, kk, nn, r, torch.bfloat16, trans,
                                   seed=61 + 2 * i + trans)
            row = check_k2(K2, x, w, a, b, scale, label, "wgmma")
            rows[label] = dict(row, shape=f"M {M} K {kk} N {nn} r {r} bf16"
                               + (" W^T" if trans else ""))
            del x, w, a, b
    return rows


def deepseek_k2_cases(K2, kops, M):
    """K2 against its plain version at every shape phase 14 launches it
    at, with deepseek-v3's LoRA rank and scale: the adapted projections
    (MLA q on the latent cq, MLA o on the heads' values, the dense layers'
    and the shared expert's gate/up/down), each forward (W) and in the dx
    form of the backward (W^T: K and N swapped, A and B as B^T and A^T);
    the Function's backward at MLA q and the dense down. Returns the
    kernels-line rows by projection."""
    from repro_torch.configs import get_config
    ds = get_config("deepseek-v3-671b")
    r, scale = ds.lora.rank, ds.lora.alpha / ds.lora.rank
    H, qk = ds.num_heads, ds.mla_nope_dim + ds.mla_rope_dim
    sf = ds.num_shared_experts * ds.moe_d_ff
    projections = (("MLA q", ds.mla_q_rank, H * qk),
                   ("MLA o", H * ds.mla_v_dim, ds.d_model),
                   ("dense gate/up", ds.d_model, ds.d_ff),
                   ("dense down", ds.d_ff, ds.d_model),
                   ("shared gate/up", ds.d_model, sf),
                   ("shared down", sf, ds.d_model))
    rows = {}
    for i, (name, k_, n_) in enumerate(projections):
        for trans in (False, True):
            kk, nn = (n_, k_) if trans else (k_, n_)
            label = f"{name}{' dx (W^T)' if trans else ''}"
            x, w, a, b = k2_inputs(M, kk, nn, r, torch.bfloat16, trans,
                                   seed=41 + 2 * i + trans)
            row = check_k2(K2, x, w, a, b, scale, f"{label} (deepseek-v3)",
                           "wgmma")
            rows[label] = dict(row, shape=f"M {M} K {kk} N {nn} r {r} bf16"
                               + (" W^T" if trans else ""))
            del x, w, a, b
    check_k2_backward(K2, kops, M, ds.mla_q_rank, H * qk, r)
    check_k2_backward(K2, kops, M, ds.d_ff, ds.d_model, r)
    return rows


def phase6_train(cfg, params, seq_len):
    """One PEFT iteration through the layer units with K2, its launches
    counted; then the next microbatch's units from that state (B no longer
    0) with K2 and without it, each timed synchronized per unit and as one
    stream, loss and grads compared. Returns K2's launches in the
    iteration and the graphed units' median seconds by kind (the cost
    model's unit points)."""
    from repro_torch.kernels import lora_matmul as K2
    from repro_torch.training import peft as P
    from repro_torch.training.data import (DataConfig, Prefetcher,
                                           SyntheticCorpus)
    from repro_torch.tree import tree_map
    # -------------------------------- 6. training at full width, with K2 --
    pc = P.PeftConfig(micro_batch=2, seq_len=seq_len, accum=1)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, pc.seq_len, pc.micro_batch, seed=0)).batches(),
        pc.n_stage).stacked()
    ft = P.init_ft_state(cfg, pc, params, 0, staged)
    upm = P.n_units_per_mb(cfg)
    unit = P.make_unit_step(cfg, pc, params, use_kernels=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K2.LAUNCHES = K2.LAUNCHES_WGMMA = K2.LAUNCHES_WMMA = K2.LAUNCHES_F32 = 0
    K2.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    ft, cold = timed_unit_run(unit, unit, ft,
                              P.units_per_iteration(cfg, pc.accum))
    iter_s = time.perf_counter() - t0
    train_launches, train_plain = K2.LAUNCHES, K2.PLAIN_CALLS
    train_wgmma = K2.LAUNCHES_WGMMA
    peak_train = torch.cuda.max_memory_allocated()
    state_bytes = tree_bytes(ft["adapters"]) + tree_bytes(
        [ft["opt"]["m"], ft["opt"]["v"]]) + tree_bytes(ft["grads"]) + \
        ft["residuals"].numel() * ft["residuals"].element_size()
    b_moved = sum(int((v["b"] != 0).sum())
                  for v in ft["adapters"]["scan"].values())
    last_loss = float(ft["last_loss"])
    n_k2 = cfg.num_layers * (7 + 14)
    log(f"train: {cfg.name}, micro_batch 2 x seq {seq_len}, accum 1, "
        f"LoRA r={cfg.lora.rank} on q/k/v/o/gate/up/down; one iteration of "
        f"{P.units_per_iteration(cfg, 1)} units in {iter_s:.3f} s, the "
        f"first of the run (synchronized after each unit)")
    for kind, ts in cold.items():
        log(f"train: first iteration {kind:9s} units={len(ts):3d} "
            f"ms_median={1e3 * statistics.median(ts):.3f} "
            f"ms_total={1e3 * sum(ts):.3f}")
    log(f"train: K2 launches={train_launches} ({cfg.num_layers} x 7 + "
        f"{cfg.num_layers} x 14 = {n_k2}), of them on the wgmma kernel "
        f"{train_wgmma}, plain calls={train_plain}, "
        f"iter={ft['iter']}, last_loss={last_loss:.4f} (ln V = "
        f"{float(np.log(cfg.vocab_size)):.4f}), nonzero B entries after "
        f"OPT={b_moved}, max_memory_allocated_gb={peak_train / 1e9:.3f}, "
        f"adapters+opt+grads+residuals_gb={state_bytes / 1e9:.3f}")
    if train_launches != n_k2 or train_plain or train_wgmma != n_k2:
        raise AssertionError("the training iteration did not run through "
                             "K2's wgmma kernel")
    if ft["iter"] != 1 or not np.isfinite(last_loss) or \
            abs(last_loss - float(np.log(cfg.vocab_size))) > 2.0 or \
            b_moved == 0:
        raise AssertionError("the training iteration did not make progress")

    # the next microbatch, from a state whose adapters are no longer a
    # no-op (at B = 0 both paths compute the same bits: the delta is 0 and
    # the tensor-core sums run in the same order). Each route from the same
    # state: synchronized after every unit (times by kind), and as one
    # stream of units with a single synchronize at the end, as co-located
    # rounds run them, three times each in turns (the host's speed varies
    # within a run)
    def clone(tree):
        return tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    start = clone(ft)
    unit_plain = P.make_unit_step(cfg, pc, params, use_kernels=False)
    ft, warm = timed_unit_run(unit, unit, ft, upm)
    ft_plain, warm_plain = timed_unit_run(unit, unit_plain, clone(start),
                                          upm)
    stream = {"K2": [], "plain": []}
    for name, step in 3 * (("plain", unit_plain), ("K2", unit)):
        state = clone(start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.run_units(step, state, upm)
        torch.cuda.synchronize()
        stream[name].append(time.perf_counter() - t0)
        del state
    # where a synchronized BWD unit's time goes on each route: the units
    # up to the first BWD unit run unprofiled, then a profiler window over
    # four BWD units, synchronized after each, reads the wall time beside
    # the device's busy time (the rest is the host's)
    from torch.profiler import ProfilerActivity, profile
    first_bwd = cfg.num_layers + 2
    for name, step in (("K2", unit), ("plain", unit_plain)):
        state = P.run_units(step, clone(start), first_bwd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(4):
                state = step(state)
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
        rows = device_rows(prof)
        busy_us = sum(r[1] for r in rows)
        k2_us = sum(r[1] for r in rows if "lora_matmul" in r[0])
        log(f"train: profile of 4 BWD units, "
            f"{'with K2' if name == 'K2' else 'without K2 (cuBLAS)'}: wall "
            f"{window * 1e3 / 4:.3f} ms per unit, device busy "
            f"{busy_us / 1e3 / 4:.3f} ms per unit (K2's kernels "
            f"{k2_us / 1e3 / 4:.3f}), busy share "
            f"{busy_us / 1e6 / window:.3f}, device events per unit "
            f"{sum(r[2] for r in rows) / 4:.1f}")
        del state
    del start
    for kind, ts in warm.items():
        tp = warm_plain[kind]
        log(f"train: warm {kind:9s} units={len(ts):3d} with K2 ms_median="
            f"{1e3 * statistics.median(ts):.3f} ms_total={1e3 * sum(ts):.3f}"
            f"; without ms_median={1e3 * statistics.median(tp):.3f} "
            f"ms_total={1e3 * sum(tp):.3f}")
    loss_k, loss_p = float(ft["loss"]), float(ft_plain["loss"])
    g_rel, g_frob, g_where = grad_agreement(ft["grads"]["scan"],
                                            ft_plain["grads"]["scan"])
    k2_mb_s = sum(map(sum, warm.values()))
    plain_mb_s = sum(map(sum, warm_plain.values()))
    stream_ratio = statistics.median(stream["K2"]) / \
        statistics.median(stream["plain"])
    log(f"train: second microbatch, units with K2 vs without (the same "
        f"units through cuBLAS): synchronized per unit {1e3 * k2_mb_s:.3f} "
        f"vs {1e3 * plain_mb_s:.3f} ms, ratio {k2_mb_s / plain_mb_s:.3f}; "
        f"as one stream, three times each in turns, "
        f"{[round(1e3 * t, 3) for t in stream['K2']]} vs "
        f"{[round(1e3 * t, 3) for t in stream['plain']]} ms, ratio of "
        f"medians {stream_ratio:.3f}")
    log(f"train: second microbatch, with K2 vs without: "
        f"loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rtol {TRAIN_LOSS_RTOL}); grads worst relative Frobenius error="
        f"{g_frob:.3e} (tol {TRAIN_GRAD_FROB_TOL}), worst max_err_over_rms="
        f"{g_rel:.3e} ({g_where})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p) or \
            g_frob > TRAIN_GRAD_FROB_TOL:
        raise AssertionError("units with K2 disagree with units without")

    # the same units replayed from CUDA graphs (one per unit of the
    # iteration, captured on this state) beside eager ones: a whole
    # iteration each, synchronized after every unit, in turns E G G E
    from repro_torch.core import colocation as C
    del ft_plain
    box = {}
    captured("llama3-8b units (one graph per unit of an iteration)",
             lambda: box.update(units=C.GraphedUnits(unit, ft)))
    graphed = box.pop("units")

    def graphed_step(state):
        graphed.step(state)
        return state
    total = P.units_per_iteration(cfg, pc.accum)
    by_mode = {"eager": {}, "graphed": {}}
    for mode in ("eager", "graphed", "graphed", "eager"):
        before = (K2.LAUNCHES, K2.LAUNCHES_WGMMA)
        ft, ts = timed_unit_run(unit, unit if mode == "eager"
                                else graphed_step, ft, total)
        for kind, t in ts.items():
            by_mode[mode].setdefault(kind, []).extend(t)
        moved = (K2.LAUNCHES - before[0], K2.LAUNCHES_WGMMA - before[1])
        if moved != (n_k2, n_k2):
            raise AssertionError(f"an iteration of {mode} units made K2 "
                                 f"launches {moved}, not {n_k2} wgmma")
    for kind in ("EMBED", "FWD", "HEAD", "BWD", "OPT"):
        e, g = by_mode["eager"][kind], by_mode["graphed"][kind]
        log(f"train: {kind:5s} units synchronized, two iterations each in "
            f"turns: eager ms_median={1e3 * statistics.median(e):.3f}, "
            f"graphed ms_median={1e3 * statistics.median(g):.3f} "
            f"(ratio {statistics.median(g) / statistics.median(e):.3f})")
    e_it = sum(map(sum, by_mode["eager"].values())) / 2
    g_it = sum(map(sum, by_mode["graphed"].values())) / 2
    log(f"train: an iteration of {total} units synchronized per unit, "
        f"eager {e_it:.3f} s, graphed {g_it:.3f} s; K2 launches {n_k2} per "
        f"iteration either way (replays counted)")
    peaks("train")
    return train_launches, {kind: statistics.median(ts)
                            for kind, ts in by_mode["graphed"].items()}


def counted_modules():
    """(name, module) of the three kernel wrappers and of the attention
    module, which counts the int8 caches' oracle decodes."""
    from repro_torch.kernels import decode_attention as K
    from repro_torch.kernels import lora_matmul as K2
    from repro_torch.kernels import ssd_scan as K3
    from repro_torch.models import attention as A
    return (("K1", K), ("K2", K2), ("K3", K3), ("oracle", A))


def stub_inputs(cfg, seq_len):
    """The `DataConfig` fields of a model's stub inputs for rows of
    seq_len tokens: a vision stub's patches, an encoder-decoder's
    seq_len // 2 encoder frames (`launch/train.py`'s rule)."""
    from repro_torch.training import peft as P
    return dict(frontend_tokens=P.front_tokens(cfg),
                enc_frames=seq_len // 2 if cfg.enc_layers else 0,
                d_model=cfg.d_model)


def kernel_counts():
    """Every launch and plain-call counter of the three kernel wrappers,
    and the int8 oracle's decode count."""
    return {(name, c): getattr(mod, c)
            for name, mod in counted_modules() for c in mod.COUNTERS}


def reset_kernel_counts():
    for _, mod in counted_modules():
        for c in mod.COUNTERS:
            setattr(mod, c, 0)


def serve_colocated(tag, cfg, params, eng, solo_round_s, seq_len):
    """Capture the runner's graphs, profile graphed rounds, fit the
    predictor, serve co-located with the QoS scheduler (waves of 16
    requests until the serving has run an iteration's worth of units and
    an OPT), with every kernel counter set to 0 just before the waves.
    Prints phase 7's readings under `tag`; returns what the caller
    asserts on."""
    from repro_torch.core import colocation as C
    from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
    from repro_torch.serving.engine import EngineMetrics
    from repro_torch.serving.request import Request
    from repro_torch.training import peft as P
    from repro_torch.training.data import (DataConfig, Prefetcher,
                                           SyntheticCorpus)
    pc = P.PeftConfig(micro_batch=2, seq_len=seq_len, accum=1)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, seq_len, 2, seed=1, **stub_inputs(cfg, seq_len))
    ).batches(), pc.n_stage).stacked()
    ft = P.init_ft_state(cfg, pc, params, 1, staged)
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                               use_kernels=True)
    if not runner.graphs:
        raise AssertionError("the runner does not replay CUDA graphs")
    torch.cuda.reset_peak_memory_stats()
    captured(f"{tag} co-located rounds (the decode step and one graph per "
             f"unit of an iteration, one pool)",
             lambda: runner.precompile(eng.cache, ft))
    t0 = time.perf_counter()
    solo, colo, ft = C.profile_rounds(
        runner, eng.cache, ft, batch_sizes=(1, 4, 8),
        contexts=(128, 320, 512), ks=(1, 3, 6), repeats=2)
    pred = C.fit_predictor(6, solo, colo)
    solo8 = statistics.median(s_ for bs, _, s_ in solo[1.0] if bs == 8)
    qos_s = 1.5 * solo8
    log(f"{tag}: profiled {len(solo[1.0])} solo and {len(colo)} co-located "
        f"graphed points in {time.perf_counter() - t0:.1f} s; fit: solo "
        f"mean/max err {pred.report.solo_mean_err:.3f}/"
        f"{pred.report.solo_max_err:.3f}, colo mean/max err "
        f"{pred.report.colo_mean_err:.3f}/{pred.report.colo_max_err:.3f}")
    for bs, ctx, s_ in solo[1.0]:
        log(f"{tag}: profile solo bs={bs} ctx={ctx} ms={1e3 * s_:.3f}")
    for _, q_ft, bs, ctx, s_ in colo:
        log(f"{tag}: profile k={round(q_ft * 6)} bs={bs} ctx={ctx} "
            f"ms={1e3 * s_:.3f}")
    log(f"{tag}: qos_s={qos_s:.4f} = 1.5 x the median measured solo round "
        f"at 8 slots ({1e3 * solo8:.3f} ms), the rule of PRs 12-15, so the "
        f"numbers compare; the paper's 40 ms SLO (SchedulerConfig.qos_s) "
        f"is read below")
    # the least target under which the fitted predictor admits one unit at
    # 8 slots and a mid context even once violations have shrunk the
    # scheduler's margin to its floor; if 1.5 x solo is below it, units
    # would stop after the first few slow rounds, so the target is raised
    # to it and the run says so
    admit_one = pred.predict_colo(1 / 6, 8, 320) / \
        SchedulerConfig.margin_floor
    if admit_one > qos_s:
        log(f"{tag}: qos_s raised to {admit_one:.4f}: under {qos_s:.4f} the "
            f"predictor admits no unit at 8 slots once the margin is at its "
            f"floor {SchedulerConfig.margin_floor} (k = 1 predicted at "
            f"{1e3 * admit_one * SchedulerConfig.margin_floor:.3f} ms)")
        qos_s = admit_one
    sched = QoSScheduler(pred, SchedulerConfig(qos_s=qos_s, k_max=6))
    seen = []                    # each round's (batch, mean context)
    pick = sched.pick

    def recorded_pick(bs, ctx, **kw):
        seen.append((bs, ctx))
        return pick(bs, ctx, **kw)
    sched.pick = recorded_pick
    eng.metrics = EngineMetrics()
    u0, it0, mb0 = ft["unit_idx"], ft["iter"], ft["consumed"]
    reqs = []
    total_units = P.units_per_iteration(cfg, pc.accum)
    reset_kernel_counts()
    t0 = time.perf_counter()
    for wave in range(4):
        rng = np.random.default_rng(wave)
        wave_reqs = [Request(rid=100 * (wave + 1) + i, arrival=i * 0.01,
                             prompt_len=int(rng.integers(64, 513)),
                             max_new_tokens=32) for i in range(16)]
        reqs += wave_reqs
        m, ft = C.run_colocated_trace(eng, runner, sched, ft, wave_reqs)
        if ft["iter"] > it0 and m.ft_units >= total_units:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    ks = [dd.k for dd in sched.decisions]
    reasons = collections.Counter(dd.reason for dd in sched.decisions)
    mbs = ft["consumed"] - mb0
    sched40 = QoSScheduler(pred, SchedulerConfig(k_max=6))
    k40 = [sched40.pick(bs, ctx, ft_ready=True, ft_units_available=6).k
           for bs, ctx in seen]
    log(f"{tag}: {len(reqs)} requests in {len(reqs) // 16} wave(s) of 16, "
        f"rounds={m.decode_rounds} tokens_out={m.tokens_out} "
        f"wall_s={wall:.3f} "
        f"round_ms_median={1e3 * statistics.median(m.round_s):.3f} "
        f"round_ms_p90={1e3 * float(np.percentile(m.round_s, 90)):.3f} "
        f"prefill_ms_median={1e3 * statistics.median(m.prefill_s):.3f} "
        f"(solo round_ms_median="
        f"{1e3 * statistics.median(solo_round_s):.3f}) mean_k="
        f"{statistics.mean(ks):.3f} reasons={dict(reasons)} "
        f"violations={sched.violations}")
    log(f"{tag}: units={m.ft_units} iterations={ft['iter'] - it0} "
        f"microbatches={mbs} finetune_tokens_per_s="
        f"{mbs * 2 * seq_len / wall:.1f} last_loss="
        f"{float(ft['last_loss']):.4f}")
    log(f"{tag}: under the paper's {SchedulerConfig.qos_s * 1e3:.0f} ms "
        f"(SchedulerConfig.qos_s, margin {SchedulerConfig.safety}) the "
        f"fitted predictor admits mean k={statistics.mean(k40):.3f} over "
        f"this run's {len(seen)} rounds (k = 0 in {k40.count(0)})")
    peaks(tag)
    if not all(rq.phase.value == "done" and rq.generated == 32
               for rq in reqs):
        raise AssertionError(f"{tag}: not every co-located request finished")
    if m.ft_units < total_units or ft["iter"] <= it0:
        raise AssertionError(f"{tag}: co-located serving ran less than an "
                             "iteration of finetune units")
    # after the counted serving: one graphed round of k_max units against
    # the eager round on copies of the cache and the finetune state
    eager = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                              use_kernels=True, graphs=False)
    tok = torch.tensor(eng.last_token, device=eng.device)
    pos = torch.full((eng.max_slots,), 400, dtype=torch.int32,
                     device=eng.device)
    cache_e, ft_e = clone_tree(eng.cache), clone_tree(ft)
    kinds = [runner.unit_step.kind((ft["unit_idx"] + j) % total_units)
             for j in range(6)]
    logits_g, _, _ = runner.run_round(6, tok, pos, eng.cache, ft)
    logits_e, _, _ = eager.run_round(6, tok, pos, cache_e, ft_e)
    torch.cuda.synchronize()
    ok = torch.equal(logits_g, logits_e) and same_bits(eng.cache, cache_e) \
        and same_bits(ft, ft_e)
    log(f"{tag}: a graphed round of 6 units ({', '.join(kinds)}) vs the "
        f"eager round at full width, logits, cache and finetune state "
        f"bit-equal: {ok}")
    if not ok:
        raise AssertionError(f"{tag}: the graphed round differs from the "
                             "eager one")
    return dict(m=m, counts=counts,
                kinds=[runner.unit_step.kind((u0 + j) % total_units)
                       for j in range(m.ft_units)],
                runner=runner, ft=ft, pred=pred, solo=solo, colo=colo,
                qos_s=qos_s, seen=seen, wall=wall, ks=ks,
                violations=sched.violations)


def phase7_colocated(cfg, params, eng, solo_round_s, seq_len, tag="colo"):
    """Co-located llama3-8b (and mixtral-8x7b in phase 12, under `tag`):
    `serve_colocated`, with K1's launches held at one per layer per round
    and K2's at the sum over the units run, all wgmma. Returns the K1 and
    K2 launches of the serving and `serve_colocated`'s results."""
    # ----------------------------------------- 7. co-located serving --
    out = serve_colocated(tag, cfg, params, eng, solo_round_s, seq_len)
    m, counts = out["m"], out["counts"]
    per_unit = k2_per_unit(cfg)
    k2_expect = sum(per_unit.get(kind, 0) for kind in out["kinds"])
    k1, k2, k2w = counts[("K1", "LAUNCHES")], counts[("K2", "LAUNCHES")], \
        counts[("K2", "LAUNCHES_WGMMA")]
    plain = sum(n for (_, c), n in counts.items() if c == "PLAIN_CALLS")
    # MLA decode and int8 caches run no K1; the hybrid's attention layers
    # are 1 in 3
    k1_layers = 0 if cfg.mla or cfg.kv_quant else \
        len(cfg.attn_layer_indices())
    log(f"{tag}: K1 launches={k1} ({k1_layers} x {m.decode_rounds} "
        f"rounds = {k1_layers * m.decode_rounds}) K2 launches={k2} "
        f"(expected from the units run: {k2_expect}; on the wgmma kernel "
        f"{k2w}, WMMA {counts[('K2', 'LAUNCHES_WMMA')]}, FMA "
        f"{counts[('K2', 'LAUNCHES_F32')]}) plain calls={plain}")
    if k1 != k1_layers * m.decode_rounds or k2 != k2_expect or \
            k2w != k2 or plain:
        raise AssertionError(f"{tag}: co-located rounds did not run through "
                             "K1/K2")
    return k1, k2, out


def phase10_mamba2_colocated(cfg, params, eng, solo_round_s, seq_len):
    """Co-located mamba2-780m: `serve_colocated` on phase 9's weights and
    engine. LoRA on the SSM family is the parallel `ssm_io` adapter, so the
    units launch no K2, and decode has no kernel: K3's launches come from
    the admissions' prefills (48 each), and no plain call is allowed.
    Returns K3's launches and `serve_colocated`'s results."""
    # --------------------------------- 10. co-located mamba2-780m --
    out = serve_colocated("colo mamba2", cfg, params, eng, solo_round_s,
                          seq_len)
    m, counts = out["m"], out["counts"]
    k3, k3_tc = counts[("K3", "LAUNCHES")], counts[("K3", "LAUNCHES_TC")]
    plain = sum(n for (_, c), n in counts.items() if c == "PLAIN_CALLS")
    others = counts[("K1", "LAUNCHES")] + counts[("K2", "LAUNCHES")]
    log(f"colo mamba2: K3 launches={k3} ({cfg.num_layers} x {m.prefills} "
        f"prefills = {cfg.num_layers * m.prefills}; tensor-core kernel "
        f"{k3_tc}), K1 and K2 launches={others}, plain calls={plain}")
    if k3 != cfg.num_layers * m.prefills or k3_tc != k3 or plain or others:
        raise AssertionError("co-located mamba2 did not run its prefills "
                             "through K3's tensor-core kernel alone")
    return k3, out


# ------------------------------------------------------------ cost model --
# the finetune units of phases 6, 7, 10 and 12: micro-batch 2 x 1024 tokens
FT_MICRO_BATCH, FT_SEQ = 2, 1024
# the families whose graphed solo rounds fit the decode constants: mixtral's
# are printed and left out, since the cost model counts the bytes of its
# top-2 experts and the port's dense dispatch reads all 8 (as a batch of 8
# tokens, routed to 2 experts each, mostly would)
SOLO_FIT_FAMILIES = ("llama3-8b", "mamba2-780m")


def cost_points(cfg, colo, unit_s=None):
    """The measured points one family gives the cost-model fit: the
    graphed solo and co-located rounds `serve_colocated` profiled, and
    phase 6's graphed unit medians by kind."""
    k_max = colo["runner"].k_max
    return dict(cfg=cfg, solo=list(colo["solo"][1.0]),
                colo=[(round(q_ft * k_max), bs, ctx, s_)
                      for _, q_ft, bs, ctx, s_ in colo["colo"]],
                units=dict(unit_s or {}))


def phase7_costmodel(cfg, eng, colo, seq_len):
    """Phase 7's cost-model route (the reference's `launch/serve.py`):
    `fit_from_costmodel` on `CostModel(cfg, InstanceSpec())`, the H100 spec
    with the committed constants, held beside the profile-fitted predictor
    on the points phase 7 measured (solo and co-located error, mean k
    admitted under the paper's 40 ms over the rounds phase 7 served), then
    16 requests served co-located through the scheduler with it, under the
    profile serving's target, on the same runner and graphs."""
    from repro_torch.core import colocation as C
    from repro_torch.core.costmodel import CostModel, InstanceSpec
    from repro_torch.core.predictor import TwoStageLatencyPredictor
    from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
    from repro_torch.serving.engine import EngineMetrics
    from repro_torch.serving.request import Request
    from repro_torch.training import peft as P
    # ------------------------------------- 7. the cost-model route --
    inst = InstanceSpec()
    t0 = time.perf_counter()
    pred_cm = TwoStageLatencyPredictor(k_max=colo["runner"].k_max)
    pred_cm.fit_from_costmodel(CostModel(cfg, inst),
                               micro_batch=FT_MICRO_BATCH, ft_seq=seq_len)
    log(f"colo costmodel: fit_from_costmodel on {inst.chip.name} (tp "
        f"{inst.tp}) with the committed constants {inst.consts} in "
        f"{time.perf_counter() - t0:.3f} s")
    for name, pred in (("profile", colo["pred"]), ("costmodel", pred_cm)):
        solo = [abs(pred.predict_solo(1.0, bs, ctx) - s_) / s_
                for bs, ctx, s_ in colo["solo"][1.0]]
        co = [abs(pred.predict_colo(q_ft, bs, ctx) - s_) / s_
              for _, q_ft, bs, ctx, s_ in colo["colo"]]
        sched40 = QoSScheduler(pred, SchedulerConfig(k_max=6))
        k40 = [sched40.pick(bs, ctx, ft_ready=True, ft_units_available=6).k
               for bs, ctx in colo["seen"]]
        log(f"colo costmodel: the {name} fit on phase 7's measured points: "
            f"solo mean/max err {statistics.mean(solo):.3f}/{max(solo):.3f}"
            f", co-located mean/max err {statistics.mean(co):.3f}/"
            f"{max(co):.3f}; under 40 ms it admits mean k="
            f"{statistics.mean(k40):.3f} over phase 7's {len(k40)} rounds "
            f"(k = 0 in {k40.count(0)})")
    runner, ft = colo["runner"], colo["ft"]
    sched = QoSScheduler(pred_cm, SchedulerConfig(qos_s=colo["qos_s"],
                                                  k_max=6))
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(7)
    reqs = [Request(rid=900 + i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    t0 = time.perf_counter()
    m, ft = C.run_colocated_trace(eng, runner, sched, ft, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    upi = P.units_per_iteration(cfg, 1)
    for name, m_, wall_, ks, viol in (
            ("profile", colo["m"], colo["wall"], colo["ks"],
             colo["violations"]),
            ("costmodel", m, wall, [d.k for d in sched.decisions],
             sched.violations)):
        log(f"colo costmodel: served with the {name} fit at qos_s="
            f"{colo['qos_s']:.4f}: {len(ks)} rounds, round_ms_median="
            f"{1e3 * statistics.median(m_.round_s):.3f} round_ms_p90="
            f"{1e3 * float(np.percentile(m_.round_s, 90)):.3f} mean_k="
            f"{statistics.mean(ks):.3f} violations={viol} units="
            f"{m_.ft_units} finetune_tokens_per_s="
            f"{m_.ft_units / upi * FT_MICRO_BATCH * seq_len / wall_:.1f} "
            f"(units / {upi} per iteration x {FT_MICRO_BATCH} x {seq_len} "
            f"tokens / wall)")
    if not all(rq.phase.value == "done" and rq.generated == 32
               for rq in reqs):
        raise AssertionError("colo costmodel: not every request finished")


def nonneg_lstsq(X, y):
    """Least squares with every coefficient >= 0: an active set that pins
    the most negative coefficient to 0 and refits the rest."""
    free = list(range(X.shape[1]))
    coef = np.zeros(X.shape[1])
    while free:
        c, *_ = np.linalg.lstsq(X[:, free], y, rcond=None)
        if (c >= 0).all():
            coef[free] = c
            break
        free.pop(int(np.argmin(c)))
    return coef


def fit_h100_constants(points):
    """The cost model's constants by least squares, in three stages, each
    on the reference's formula with the earlier stages' values:
      bw_eff, step and per-layer overheads from the graphed solo rounds of
        SOLO_FIT_FAMILIES: t = bytes / (hbm_bw * bw_eff) + step + L * pl
        (their decode is memory-bound at 8 slots);
      mxu_eff from phase 6's graphed FWD and BWD units: t = flops / (peak *
        mxu_eff) + c (c printed, not kept);
      overlap_eff and the unit overhead from phase 7's co-located rounds:
        t - max(t_mem, t_comp) - step - L * pl = (1 - overlap) * min(t_mem,
        t_comp) + k * unit.
    Every coefficient >= 0, each efficiency <= 1. bw_sat_quantum keeps the
    committed (paper) value."""
    from repro_torch.core.costmodel import (H100_CONSTANTS, CostConstants,
                                            CostModel)
    from repro_torch.hw import H100_SXM as chip
    rows, y = [], []
    for pt in points:
        if pt["cfg"].name in SOLO_FIT_FAMILIES:
            cm = CostModel(pt["cfg"])
            for bs, ctx, s_ in pt["solo"]:
                rows.append([cm.decode_work(bs, ctx).bytes_hbm / chip.hbm_bw,
                             1.0, pt["cfg"].num_layers])
                y.append(s_)
    rows, y = np.asarray(rows), np.asarray(y)
    inv_bw, step, per_layer = nonneg_lstsq(rows, y)
    if inv_bw < 1.0:                     # faster than the HBM peak: pin it
        inv_bw = 1.0
        step, per_layer = nonneg_lstsq(rows[:, 1:], y - rows[:, 0])
    llama = next(pt for pt in points if pt["units"])
    cm = CostModel(llama["cfg"])
    kinds = ("FWD", "BWD")
    X = np.asarray([[cm.unit_work(FT_MICRO_BATCH, FT_SEQ, backward=kind ==
                                  "BWD").flops / chip.peak_flops_bf16, 1.0]
                    for kind in kinds])
    inv_mxu, unit_c = nonneg_lstsq(X, np.asarray([llama["units"][k]
                                                  for k in kinds]))
    inv_mxu = max(inv_mxu, 1.0)
    bw, peak = chip.hbm_bw / inv_bw, chip.peak_flops_bf16 / inv_mxu
    L = llama["cfg"].num_layers
    u = cm.avg_unit_work(FT_MICRO_BATCH, FT_SEQ)
    rows, y = [], []
    for k, bs, ctx, s_ in llama["colo"]:
        d = cm.decode_work(bs, ctx)
        t_mem = (d.bytes_hbm + k * u.bytes_hbm) / bw
        t_comp = (d.flops + k * u.flops) / peak
        rows.append([min(t_mem, t_comp), k])
        y.append(s_ - max(t_mem, t_comp) - step - L * per_layer)
    rows, y = np.asarray(rows), np.asarray(y)
    hidden_not, unit = nonneg_lstsq(rows, y)
    if hidden_not > 1.0:                 # more than serial: pin to serial
        hidden_not = 1.0
        (unit,) = nonneg_lstsq(rows[:, 1:], y - rows[:, 0])
    fitted = CostConstants(
        mxu_eff=float(1.0 / inv_mxu), bw_eff=float(1.0 / inv_bw),
        overlap_eff=float(1.0 - hidden_not), step_overhead_s=float(step),
        per_layer_overhead_s=float(per_layer), unit_overhead_s=float(unit),
        bw_sat_quantum=H100_CONSTANTS.bw_sat_quantum)
    return fitted, float(unit_c)


def costmodel_fit(points):
    """The cost model's H100 constants fitted from this run's points
    (`fit_h100_constants`), printed; then the committed constants' and the
    fitted ones' relative error at every profiled point: the solo rounds
    of llama3, mamba2 and mixtral, phase 6's units (HEAD, which the model
    has no term for, beside its average unit), phase 7's co-located
    rounds."""
    from repro_torch.core.costmodel import (H100_CONSTANTS, CostModel,
                                            InstanceSpec)
    # ------------------------------- 7. the cost model's H100 constants --
    fitted, unit_c = fit_h100_constants(points)
    log(f"costmodel fit: {fitted} (the FWD/BWD line's intercept "
        f"{1e3 * unit_c:.3f} ms; solo rounds of {SOLO_FIT_FAMILIES} fit "
        f"bw_eff and the overheads)")
    log(f"costmodel fit: committed {H100_CONSTANTS}")
    models = {"committed": H100_CONSTANTS, "fitted": fitted}
    errs = {(name, group): [] for name in models
            for group in ("solo", "unit", "colo")}

    def line(label, group, measured, predict):
        parts = []
        for name, c in models.items():
            t = predict(CostModel(pt["cfg"], InstanceSpec(consts=c),
                                  noise_sigma=0.0))
            err = (t - measured) / measured
            errs[(name, group)].append(abs(err))
            parts.append(f"{name} {1e3 * t:.3f} ms (rel err {err:+.3f})")
        log(f"costmodel point: {label} measured {1e3 * measured:.3f} ms; "
            + "; ".join(parts))

    for pt in points:
        name = pt["cfg"].name
        for bs, ctx, s_ in pt["solo"]:
            line(f"{name} solo bs={bs} ctx={ctx}", "solo", s_,
                 lambda cm: cm.decode_solo(bs, ctx, noisy=False))
        for kind in ("FWD", "BWD"):
            if kind in pt["units"]:
                line(f"{name} {kind} unit", "unit", pt["units"][kind],
                     lambda cm: cm.unit_solo(FT_MICRO_BATCH, FT_SEQ,
                                             backward=kind == "BWD",
                                             noisy=False))
        if "HEAD" in pt["units"]:
            cm = CostModel(pt["cfg"], noise_sigma=0.0)
            avg = sum(cm.unit_solo(FT_MICRO_BATCH, FT_SEQ, backward=b,
                                   noisy=False) for b in (False, True)) / 2
            log(f"costmodel point: {name} HEAD unit measured "
                f"{1e3 * pt['units']['HEAD']:.3f} ms: no term prices it (a "
                f"co-located round's units are priced by the average FWD "
                f"and BWD work; the model's FWD and BWD units average "
                f"{1e3 * avg:.3f} ms with the committed constants)")
        if pt["units"]:
            for k, bs, ctx, s_ in pt["colo"]:
                line(f"{name} co-located k={k} bs={bs} ctx={ctx}", "colo",
                     s_, lambda cm: cm.colocated_round(
                         bs, ctx, k, FT_MICRO_BATCH, FT_SEQ, noisy=False))
    for (name, group), e in errs.items():
        if e:
            log(f"costmodel error: {name} constants, {group} points: mean "
                f"{statistics.mean(e):.3f} max {max(e):.3f} over {len(e)}")


# ------------------------------------------------------------------ K3 ----
def k3_bound_ms(B, S, nh, hd, ds, c, dtype, with_h0):
    """Least time for the same work. Bytes: xs, Bt, Ct (in `dtype`), dt, A
    and h0 (f32) read once, y and hT (f32) written once. Operations, over
    the peak of the units the inputs feed (bf16 tensor cores for bf16, the
    f32 units for f32), for the rows this run has (a ragged chunk counts
    its L rows): per chunk the causal scores C.B^T once (shared by the
    heads, ds*L(L+1) flops), and per head the masked decayed form times dt
    (L(L+1)), its product with x (hd*L(L+1)), the state update (2*L*hd*ds)
    and, where a state comes in (an h0, or an earlier chunk), the inter
    term (2*L*hd*ds). Returns (ms, "bytes" or "operations", the same work
    bounded by the f32 peak: the bound before K3 ran on tensor cores)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (B * S * (nh * hd + 2 * ds) * item + B * S * nh * 4 + nh * 4
              + B * S * nh * hd * 4 + B * nh * hd * ds * 4 * (2 if with_h0
                                                                else 1))
    flops = 0
    for k in range(-(-S // c)):
        L = min(c, S - k * c)
        tri = L * (L + 1)
        inter = 2 * L * hd * ds if (with_h0 or k > 0) else 0
        flops += ds * tri + nh * ((hd + 1) * tri + 2 * L * hd * ds + inter)
    flops *= B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    f32_peak = max(t_bytes, flops / PEAK_FLOPS[torch.float32] * 1e3)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations", f32_peak


def k3_inputs(B, S, nh, hd, ds, dtype, h0, seed, dev):
    """As `ssm_prefill` feeds the scan: xs, Bt and Ct are slices of one
    (B, S, nh*hd + 2*ds) conv output (strided views) in `dtype`; dt =
    softplus(N(0, 1)) and A = -linspace(1, 16) (the model's init) in f32;
    h0 zeros (the engine's fresh slot state) or N(0, 0.2) when h0 is
    "random"."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    conv = F.silu(randn(B, S, nh * hd + 2 * ds)).to(dtype)
    xs = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bt, Ct = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    dt = F.softplus(randn(B, S, nh))
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    h = randn(B, nh, hd, ds, scale=0.2) if h0 == "random" else \
        torch.zeros((B, nh, hd, ds), device=dev)
    return xs, dt, A, Bt, Ct, h


def ssd_f64_witness(xs, dt, A, Bt, Ct, chunk, h0=None):
    """The SSD recurrence token by token in float64, as
    `repro/kernels/ref.py::ssd_sequential_ref` states it: no cumsum and
    no chunks (`chunk` is ignored), so neither K3's nor the plain
    version's order of sums. Returns y and hT in float32."""
    B, S, nh, hd = xs.shape
    x, d, b, c = xs.double(), dt.double(), Bt.double(), Ct.double()
    a = torch.exp(d * A.double())                              # (B, S, nh)
    h = torch.zeros((B, nh, hd, Bt.shape[-1]), dtype=torch.float64,
                    device=xs.device) if h0 is None else h0.double()
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + \
            (d[:, t, :, None] * x[:, t])[..., None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bs,bhps->bhp", c[:, t], h))
    return torch.stack(ys, dim=1).float(), h.float()


def _split(v, one_rounding=False):
    """An f32 operand as K3's tensor-core kernel feeds it to bf16 MMAs: hi
    = bf16(v), lo = bf16(v - hi) (or lo = 0: one bf16 rounding)."""
    hi = v.to(torch.bfloat16).float()
    lo = torch.zeros_like(v) if one_rounding else \
        (v - hi).to(torch.bfloat16).float()
    return hi, lo


def ssd_split_emulation(xs, dt, A, Bt, Ct, chunk, h0=None,
                        one_rounding=False):
    """K3's tensor-core route, its three passes in plain torch, rounding
    where the kernel rounds: the decay cumsum of f32 dt * A in double, kept
    as f32 hi + lo, exp in f32; bf16 xs/Bt/Ct exact; each f32 operand of a
    product (w . B, the decayed scores G, the entering state h) as bf16 hi
    + lo (`one_rounding`: hi alone); f32 products and sums, f32 states
    between the passes. Returns y and hT in float32."""
    B, S, nh, hd = xs.shape
    ds = Bt.shape[-1]
    c = min(chunk, S)
    n = -(-S // c)
    pad = n * c - S
    x = F.pad(xs.float(), (0, 0, 0, 0, 0, pad)).reshape(B, n, c, nh, hd)
    b = F.pad(Bt.float(), (0, 0, 0, pad)).reshape(B, n, c, ds)
    cc = F.pad(Ct.float(), (0, 0, 0, pad)).reshape(B, n, c, ds)
    d = F.pad(dt.float(), (0, 0, 0, pad)).reshape(B, n, c, nh)
    cum = (d * A.float()).double().cumsum(dim=2)            # (B, n, c, nh)
    cum_end = cum[:, :, -1:]
    # pass 1: each chunk's own state
    w = torch.exp((cum_end - cum).float()) * d
    hi, lo = _split(w[..., None] * b[:, :, :, None, :], one_rounding)
    hc = torch.einsum("bnjhp,bnjhs->bnhps", x, hi) + \
        torch.einsum("bnjhp,bnjhs->bnhps", x, lo)
    # pass 2: the states entering each chunk
    decay = torch.exp(cum_end[:, :, 0].float())               # (B, n, nh)
    h = torch.zeros((B, nh, hd, ds), device=xs.device) if h0 is None \
        else h0.float()
    enter = []
    for k in range(n):
        enter.append(h)
        h = decay[:, k, :, None, None] * h + hc[:, k]
    # pass 3: intra and inter terms
    scores = torch.einsum("bnis,bnjs->bnij", cc, b)
    causal = torch.ones((c, c), dtype=torch.bool,
                        device=xs.device).tril()[..., None]
    hi = cum.float()                  # the cumsum as f32 hi + lo, and
    lo = (cum - hi.double()).float()  # cum_i - cum_j from the parts
    diff = torch.where(causal, (hi[:, :, :, None] - hi[:, :, None]) +
                       (lo[:, :, :, None] - lo[:, :, None]),
                       -torch.inf)                            # (B,n,i,j,nh)
    G = scores[..., None] * torch.exp(diff) * d[:, :, None]
    g_hi, g_lo = _split(G, one_rounding)
    y = torch.einsum("bnijh,bnjhp->bnihp", g_hi, x) + \
        torch.einsum("bnijh,bnjhp->bnihp", g_lo, x)
    s_hi, s_lo = _split(torch.stack(enter, dim=1), one_rounding)
    inter = torch.einsum("bnis,bnhps->bnihp", cc, s_hi) + \
        torch.einsum("bnis,bnhps->bnihp", cc, s_lo)
    y = y + inter * torch.exp(hi + lo)[..., None]
    return y.reshape(B, n * c, nh, hd)[:, :S], h


def k3_counts(K3):
    return {k: getattr(K3, k) for k in ("LAUNCHES", "LAUNCHES_TC",
                                        "LAUNCHES_F32")}


def check_k3(K3, args, chunk, label, path):
    """K3 vs plain on one input, asserted by the counters to run the kernel
    `path` names, timed; returns the kernels-line numbers."""
    xs, dt, A, Bt, Ct, h0 = args
    B, S, nh, hd = xs.shape
    ds = Bt.shape[-1]
    before = k3_counts(K3)
    y, hT = K3.ssd_scan(xs, dt, A, Bt, Ct, chunk, h0=h0)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in k3_counts(K3).items()}
    if moved != {"LAUNCHES": 1, "LAUNCHES_TC": int(path == "tc"),
                 "LAUNCHES_F32": int(path == "f32")}:
        raise AssertionError(f"K3 {label} did not run the {path} kernel: "
                             f"{moved}")
    yr, hr = K3.ssd_scan_plain(xs, dt, A, Bt, Ct, chunk, h0=h0)
    yw, hw = ssd_f64_witness(xs, dt, A, Bt, Ct, chunk, h0=h0)
    torch.cuda.synchronize()

    def max_err(got, expect):
        return (got - expect).abs().max().item()
    errs, rels, ok = [], [], True
    for got, expect in ((y, yr), (hT, hr)):
        err = max_err(got, expect)
        errs.append(err)
        rels.append(err / expect.square().mean().sqrt().item())
        ok = ok and bool(torch.isfinite(got).all()) and torch.allclose(
            got, expect, atol=K3_TOL, rtol=K3_TOL)
    # K3 against the f64 witness, at the same tolerance; the plain
    # version's distance to the witness printed beside it
    ok = ok and all(torch.allclose(got, w, atol=K3_TOL, rtol=K3_TOL)
                    for got, w in ((y, yw), (hT, hw)))
    ms = time_ms(lambda: K3.ssd_scan(xs, dt, A, Bt, Ct, chunk, h0=h0))
    plain_ms = time_ms(lambda: K3.ssd_scan_plain(xs, dt, A, Bt, Ct, chunk,
                                                 h0=h0), iters=10)
    c = min(chunk, S)
    bound_ms, bound_by, f32_peak_ms = k3_bound_ms(B, S, nh, hd, ds, c,
                                                  xs.dtype, bool(h0.any()))
    log(f"K3 {label}: B={B} S={S} nh={nh} hd={hd} ds={ds} c={c} "
        f"{str(xs.dtype)[6:]} h0={'random' if h0.any() else 'zeros'} "
        f"kernel={path} "
        f"max_abs_err y={errs[0]:.3e} hT={errs[1]:.3e} (tol {K3_TOL}) "
        f"max_err_over_rms y={rels[0]:.3e} hT={rels[1]:.3e}; vs the f64 "
        f"witness: K3 y={max_err(y, yw):.3e} hT={max_err(hT, hw):.3e}, "
        f"plain y={max_err(yr, yw):.3e} hT={max_err(hr, hw):.3e}; ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=none (no single "
        f"torch call computes the SSD scan) bound_ms={bound_ms:.4f} "
        f"({bound_by}) bound_share={bound_ms / ms:.3f}; the f32-peak "
        f"bound (of K3's FMA kernel) {f32_peak_ms:.4f} ms, share "
        f"{f32_peak_ms / ms:.3f}")
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version: {label}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase8_k3(dev, cfg):
    """K3 against its plain version at `cfg`'s prefill shapes (mamba2-780m:
    nh 48, hd 64, ds 128, chunk 256), each case asserted by the counters
    to run the kernel it should (bf16: tensor cores; f32: FMA), timed; the
    main case against the split emulation, and a profiler window over it.
    Returns the
    kernels-line numbers of the largest prefill the serving runs (B 1, S
    512, bf16, h0 zeros)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as K3
    # ------------------------------------------- 8. K3 vs plain, on card --
    nh, hd, ds, chunk = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                         cfg.ssm_chunk)
    cases = [(B, S, torch.bfloat16, "zeros") for B in (1, 2)
             for S in (64, 71, 256, 300, 512)]
    cases += [(1, 300, torch.bfloat16, "random"),
              (2, 512, torch.bfloat16, "random"),
              (1, 300, torch.float32, "random")]
    rows, inputs = {}, {}
    for i, (B, S, dtype, h0) in enumerate(cases):
        args = k3_inputs(B, S, nh, hd, ds, dtype, h0, seed=31 + i, dev=dev)
        path = "tc" if dtype == torch.bfloat16 else "f32"
        route = K3._k3_path(args[0], args[3], args[4])
        if route != path:
            raise AssertionError(f"K3 case {i} routes to {route}, not {path}")
        rows[(B, S, dtype, h0)] = check_k3(K3, args, chunk, f"case {i}", path)
        inputs[(B, S, dtype, h0)] = args
    main_args = inputs[(1, 512, torch.bfloat16, "zeros")]
    # the main case against the kernel's arithmetic emulated in torch, and
    # that emulation against the witness: a kernel fault shows as a gap to
    # its emulation, the split's own error as the emulation's gap
    y, hT = K3.ssd_scan(*main_args[:5], chunk, h0=main_args[5])
    ye, he = ssd_split_emulation(*main_args[:5], chunk, h0=main_args[5])
    yw, hw = ssd_f64_witness(*main_args[:5], chunk, h0=main_args[5])
    log(f"K3 B 1 S 512 vs its split emulation: max_abs_err "
        f"y={(y - ye).abs().max().item():.3e} "
        f"hT={(hT - he).abs().max().item():.3e}; the emulation vs the f64 "
        f"witness y={(ye - yw).abs().max().item():.3e} "
        f"hT={(he - hw).abs().max().item():.3e}")

    # device time of each K3 kernel at the main case, from the profiler
    n_calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            K3.ssd_scan(*main_args[:5], chunk, h0=main_args[5])
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    k3_us = 0.0
    for key, us, count in device_rows(prof):
        if "ssd_" in key:
            name = key[key.index("ssd_"):].split("(")[0].split("<")[0]
            k3_us += us
            log(f"K3 profile, B 1 S 512: {name}: {us / count:.2f} us per "
                f"launch, {count / n_calls:.0f} launch(es) per call")
    log(f"K3 profile, B 1 S 512: {n_calls} calls, device {k3_us / n_calls:.2f}"
        f" us per call, host wall {window * 1e6 / n_calls:.2f} us per call "
        f"(no flush between calls); chunk-scan CTAs "
        f"{-(-512 // chunk) * -(-min(chunk, 512) // 64) * nh} (64-row "
        f"tiles x chunks x heads, one head each) on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    main = rows[(1, 512, torch.bfloat16, "zeros")]
    return dict(main, device_us_per_call=k3_us / n_calls,
                shape=f"B 1 S 512 nh {nh} hd {hd} ds {ds} c {chunk} "
                "bf16 xs/Bt/Ct, f32 dt, h0 zeros (one layer's prefill)")


def phase9_mamba2(dev, cfg):
    """The new path: `ServingEngine(use_kernels=True)` serves 16 requests
    on `cfg` (full-width mamba2-780m), every admission's prefill through
    K3 (48 launches each); then one batch of prompts prefilled with and
    without K3 on the same weights, and a profiler window over decode
    steps. Returns K3's launches in the serving run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as MD
    from repro_torch.models import ssm as SSM
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    # -------------------------------- 9. serve full-width mamba2 with K3 --
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"mamba2-780m: {cfg.num_layers} layers, d {cfg.d_model}, nh "
        f"{cfg.ssm_nheads}, hd {cfg.ssm_headdim}, ds {cfg.ssm_state}, chunk "
        f"{cfg.ssm_chunk}; weights {weight_bytes / 1e9:.3f} GB bf16, random "
        f"(seed 0), init {time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("mamba2-780m decode step (8 slots)", eng.precompile)
    state_bytes = tree_bytes(eng.cache["scan"])
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    log(f"mamba2 serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, 32 new tokens each, decode "
        f"rounds replayed from the CUDA graph")
    m, counts = serve_trace(eng, reqs, "mamba2 serve")
    launches, plain_calls = counts[("K3", "LAUNCHES")], \
        counts[("K3", "PLAIN_CALLS")]
    by_kernel = (counts[("K3", "LAUNCHES_TC")], counts[("K3", "LAUNCHES_F32")])
    k1_calls = counts[("K1", "LAUNCHES")] + counts[("K1", "PLAIN_CALLS")]
    # a decode round reads every weight once (the tied embedding table as
    # the LM head) and reads and writes the 8 slots' state
    round_bytes = weight_bytes + 2 * state_bytes
    log(f"mamba2 serve: decode-round bound "
        f"{round_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms = (weights "
        f"{weight_bytes / 1e9:.3f} GB, of which the tied embedding/LM head "
        f"{tree_bytes(params['embed']) / 1e9:.3f} GB, + 2 x state "
        f"{state_bytes / 1e9:.3f} GB) / 3.35 TB/s")
    log(f"mamba2 serve: K3 launches={launches} ({cfg.num_layers} x "
        f"{m.prefills} prefills = {cfg.num_layers * m.prefills}; tensor-core "
        f"kernel {by_kernel[0]}, FMA kernel {by_kernel[1]}), plain "
        f"calls={plain_calls}, K1 calls={k1_calls}")
    if launches != cfg.num_layers * m.prefills or plain_calls or k1_calls \
            or by_kernel != (launches, 0):
        raise AssertionError("mamba2 prefill did not run through K3's "
                             "tensor-core kernel")
    ab_solo_rounds(eng, cfg, "mamba2 serve")
    graphed_decode_bits("mamba2 serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        torch.zeros(8, dtype=torch.int32, device=dev))

    # device time of one admission's prefill (1 x 300 tokens), by kernel
    one = torch.randint(0, cfg.vocab_size, (1, 300), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    cache1 = MD.init_cache(cfg, 1, 1024, device=dev)
    MD.prefill(params, cfg, {"tokens": one}, cache1, use_kernels=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MD.prefill(params, cfg, {"tokens": one}, cache1, use_kernels=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    k3_us = sum(r[1] for r in rows if "ssd_" in r[0])
    log(f"mamba2 prefill of 1 x 300 tokens, profiled: wall "
        f"{window * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, of "
        f"which K3's kernels {k3_us / 1e3:.3f} ms "
        f"({sum(r[2] for r in rows if 'ssd_' in r[0])} launches)")
    del cache1

    # one batch of prompts prefilled with K3, with the plain f32 scan and
    # with the scan in float64 (the witness: `ssd_chunked`, the plain
    # path's scan, swapped for `ssd_f64_witness` for that one call), all
    # on the same weights
    toks = torch.randint(0, cfg.vocab_size, (4, 300), device=dev,
                         generator=torch.Generator(dev).manual_seed(5))

    def run(use_kernels, scan=None):
        cache = MD.init_cache(cfg, 4, 1024, device=dev)
        plain_scan = SSM.ssd_chunked
        SSM.ssd_chunked = scan or plain_scan
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = MD.prefill(params, cfg, {"tokens": toks}, cache,
                                       use_kernels=use_kernels)
            torch.cuda.synchronize()
        finally:
            SSM.ssd_chunked = plain_scan
        return logits.float(), cache["scan"]["h"], \
            1e3 * (time.perf_counter() - t0)

    def gap(a, b):
        """max |dlogit|, greedy agreement, relative error of layer 0's and
        of every layer's final h (Frobenius), b the reference."""
        (la, ha, _), (lb, hb, _) = a, b
        return ((la - lb).abs().max().item(),
                (la.argmax(-1) == lb.argmax(-1)).float().mean().item(),
                ((ha[0] - hb[0]).norm() / hb[0].norm()).item(),
                ((ha - hb).norm() / hb.norm()).item())

    run(True)                                             # warm
    kern, plain = run(True), run(False)
    wit = run(False, ssd_f64_witness)
    emu = run(False, ssd_split_emulation)
    lw = wit[0]
    top2 = lw.topk(2, dim=-1).values
    margins = [round(v, 4) for v in (top2[:, 0] - top2[:, 1]).tolist()]
    log(f"mamba2 prefill of 4 x 300 tokens: with K3 {kern[2]:.3f} ms, "
        f"plain {plain[2]:.3f} ms, f64 witness {wit[2]:.3f} ms, split "
        f"emulation {emu[2]:.3f} ms; max |logit| "
        f"{lw.abs().max().item():.3f}, witness top-1 minus top-2 logit "
        f"{margins}")
    got = gap(kern, wit)
    for name, (dl, agree, h0_rel, h_rel) in (
            ("K3 vs f64 witness", got),
            ("plain f32 vs f64 witness", gap(plain, wit)),
            ("split emulation vs f64 witness", gap(emu, wit)),
            ("K3 vs split emulation", gap(kern, emu)),
            ("K3 vs plain f32", gap(kern, plain))):
        log(f"mamba2 prefill {name}: max_abs_logit_diff={dl:.4f} "
            f"greedy_agreement={agree} h_rel_err layer 0={h0_rel:.3e} "
            f"all layers={h_rel:.3e}")
    log(f"mamba2 prefill tolerances, K3 vs the witness: logits "
        f"{MAMBA_LOGIT_TOL}, h of layer 0 {MAMBA_H0_TOL}, h of all layers "
        f"{MAMBA_H_TOL}")
    dl, agree, h0_rel, h_rel = got
    if kern[0].shape != (4, cfg.vocab_size) or \
            not torch.isfinite(kern[0]).all() or dl > MAMBA_LOGIT_TOL or \
            h0_rel > MAMBA_H0_TOL or h_rel > MAMBA_H_TOL:
        raise AssertionError("mamba2 prefill through K3 disagrees with the "
                             "f64 witness")

    # profiler window over decode steps (plain torch: no kernel of its own)
    tok = torch.tensor(eng.last_token, device=dev)
    pos = torch.zeros(8, dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            MD.decode_step(params, cfg, tok, pos, eng.cache, use_kernels=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU and
                       e.key.startswith(("cudaLaunch", "cuLaunch")))
    log(f"mamba2 profile: 5 decode steps, wall {window * 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms, busy share {busy_us / 1e6 / window:.3f}"
        f", device events per step {sum(r[2] for r in rows) / 5:.1f}, "
        f"launch calls per step {launch_calls / 5:.1f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"mamba2 profile:   {us / 1e3 / 5:9.4f} ms/step  "
            f"x{count // 5:<4d} {key[:90]}")
    return launches, params, eng, m.round_s



def phases_llama3(dev):
    """Phases 2-7 on full-width llama3-8b. Returns the kernels-line numbers
    of K1 and K2; the model, caches and engine are freed on return."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request

    # ------------------------------------------- 2. K1 vs plain, on card --
    for dtype in (torch.bfloat16, torch.float32):
        for H, KV in ((32, 8), (28, 4)):           # llama3-8b, qwen2.5-7b
            for B in (1, 8):
                args = k1_inputs(B, H, KV, 128, 64, 16, dtype, seed=B + H)
                check_k1(K, *args, label=f"{str(dtype)[6:]} H={H} KV={KV} "
                         f"g={H // KV} B={B} ptok=64 pages=16 lengths="
                         f"{args[4].tolist()}")
    # the long context: one sequence, every page full (8 CTAs before the
    # split, 8 x 16 with it)
    for dtype in (torch.bfloat16, torch.float32):
        args = k1_inputs(1, 32, 8, 128, 64, 16, dtype, seed=99, full=True)
        check_k1(K, *args, label=f"{str(dtype)[6:]} H=32 KV=8 g=4 B=1 ptok=64 "
                 f"pages=16, all full (long context), lengths "
                 f"{args[4].tolist()}, splits {K._k1_splits(16, 64)}")
        if dtype == torch.bfloat16:
            k1_split_scan(K, args, "bf16 B=1, 16 full pages")

    # ------------------------------------ 3. main path: full-width serve --
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"llama3-8b weights: {weight_bytes / 1e9:.3f} GB bf16, random "
        f"(seed 0), init {time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("llama3-8b decode step (8 slots)", eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    log(f"serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, 32 new tokens each, decode "
        f"rounds replayed from the CUDA graph")
    served = {}
    m, counts = serve_trace(eng, reqs, "serve", tokens=served)
    launches, plain_calls = counts[("K1", "LAUNCHES")], \
        counts[("K1", "PLAIN_CALLS")]
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    log(f"serve: decode-round bound from weight reads alone "
        f"{(weight_bytes - embed_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    log(f"serve: K1 launches={launches} (32 x {m.decode_rounds} rounds = "
        f"{32 * m.decode_rounds}), plain calls={plain_calls}")
    if launches != cfg.num_layers * m.decode_rounds or plain_calls:
        raise AssertionError("decode attention did not run through K1")
    ab_solo_rounds(eng, cfg, "serve")

    pos = (eng.cache["scan"]["kv_pos"][0] >= 0).sum(dim=-1).to(torch.int32)
    tok = torch.tensor(eng.last_token, device=dev)
    graphed_decode_bits("serve", params, cfg, eng.cache, tok, pos)
    logits_k, _ = MD.decode_step(params, cfg, tok, pos, eng.cache,
                                 use_kernels=True)
    logits_r, _ = MD.decode_step(params, cfg, tok, pos, eng.cache)
    diff = (logits_k.float() - logits_r.float()).abs().max().item()
    agree = (logits_k.argmax(-1) == logits_r.argmax(-1)).float().mean().item()
    log(f"decode step, kernel vs dense oracle at positions {pos.tolist()}: "
        f"max_abs_logit_diff={diff:.4f} (tol {LOGIT_TOL}, max |logit| "
        f"{logits_r.float().abs().max().item():.3f}) greedy_agreement={agree}")
    if logits_k.shape != (8, cfg.vocab_size) or \
            not torch.isfinite(logits_k).all() or diff > LOGIT_TOL:
        raise AssertionError("decode step through K1 disagrees with oracle")

    kc = eng.cache["scan"]["k"][0]
    n_pages = kc.shape[1] // 64
    main_args = (torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                             generator=torch.Generator(dev).manual_seed(7)
                             ).to(torch.bfloat16),
                 kc.reshape(8 * n_pages, 64, cfg.num_kv_heads, cfg.head_dim),
                 eng.cache["scan"]["v"][0].reshape(
                     8 * n_pages, 64, cfg.num_kv_heads, cfg.head_dim),
                 torch.arange(8 * n_pages, dtype=torch.int32,
                              device=dev).reshape(8, n_pages),
                 pos + 1)
    main_k1 = check_k1(K, *main_args, label="main path (llama3-8b layer-0 "
                       f"cache after serving, lengths {(pos + 1).tolist()})")
    k1_split_scan(K, main_args, "main path")

    # ---------------------------------------------- 4. profiler window --
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            MD.decode_step(params, cfg, tok, pos, eng.cache, use_kernels=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(f"profile: 5 decode steps, wall {window * 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms, busy share {busy_us / 1e6 / window:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"profile:   {us / 1e3 / 5:9.4f} ms/step  x{count // 5:<4d} "
            f"{key[:90]}")
    for key, us, count in rows:         # K1's two kernels (split, combine)
        if "paged_decode" in key:
            name = key[key.index("paged_decode"):].split("<")[0]
            log(f"profile: K1 {name}: {us / count:.2f} us per launch, "
                f"x{count // 5} per step")
    # host side: CUDA runtime/driver calls (launches, copies, synchronizations)
    api = [(e.key, e.self_cpu_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and
           (e.key.startswith("cuda") or e.key.startswith("cuLaunch"))]
    log(f"profile: device events per step "
        f"{sum(r[2] for r in rows) / 5:.1f}; host API calls per step:")
    for key, us, count in sorted(api, key=lambda r: -r[2])[:8]:
        log(f"profile:   x{count / 5:<7.1f} {us / 1e3 / 5:9.4f} ms/step  "
            f"{key[:60]}")

    # small width, f32: the same decode step against the oracle at 2e-4
    small = smoke_config("llama3-8b")
    sp = MD.init_params(small, 1, dtype=torch.float32, device=dev)
    sc = MD.init_cache(small, 2, 128, dtype=torch.float32, device=dev)
    stoks = torch.randint(0, small.vocab_size, (2, 20), device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    MD.prefill(sp, small, {"tokens": stoks}, sc)
    spos = torch.full((2,), 20, dtype=torch.int32, device=dev)
    a, _ = MD.decode_step(sp, small, stoks[:, -1], spos, sc, use_kernels=True)
    b, _ = MD.decode_step(sp, small, stoks[:, -1], spos, sc)
    small_diff = (a - b).abs().max().item()
    log(f"smoke-width f32 decode step, kernel vs oracle: max_abs_diff="
        f"{small_diff:.3e} (tol 2e-4)")
    if not torch.allclose(a, b, atol=2e-4, rtol=2e-4):
        raise AssertionError("smoke-width decode step disagrees")

    k2_main = phase5_k2(cfg)
    train_launches, unit_s = phase6_train(cfg, params, seq_len=1024)
    k1_7, k2_7, colo = phase7_colocated(cfg, params, eng, m.round_s,
                                        seq_len=1024)
    phase7_costmodel(cfg, eng, colo, seq_len=1024)

    return dict(k1=dict(launches=launches, **main_k1,
                        launches_by_path={"serve": launches,
                                          "colocated_serve": k1_7}),
                k2=dict(launches=k2_7, **k2_main,
                        launches_by_path={"train_iteration": train_launches,
                                          "colocated_serve": k2_7}),
                points=cost_points(cfg, colo, unit_s),
                served=dict(tokens=served, cache_bytes=tree_bytes(eng.cache)))


# ------------------------------------------- sliding window and MoE ----
def serve_trace(eng, reqs, label, tokens=None):
    """Serve `reqs` (decode rounds replayed from the engine's graph) with
    every kernel counter set to 0 just before; print the serving numbers
    and return (metrics, kernel counts). tokens, a dict, receives each
    request's decoded greedy tokens by rid."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if tokens is not None:
        decode_round = eng.decode_round

        def recorded(*args, **kw):
            out = decode_round(*args, **kw)
            for rid, tok in out.items():
                tokens.setdefault(rid, []).append(tok)
            return out
        eng.decode_round = recorded
    reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        m = eng.run_trace(reqs)
    finally:
        if tokens is not None:
            del eng.decode_round
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: rounds={m.decode_rounds} tokens_out={m.tokens_out} "
        f"prefills={m.prefills} wall_s={wall:.3f} "
        f"tokens_per_s={m.tokens_out / wall:.1f} "
        f"round_ms_median={1e3 * statistics.median(m.round_s):.3f} "
        f"round_ms_p90={1e3 * float(np.percentile(m.round_s, 90)):.3f} "
        f"prefill_ms_median={1e3 * statistics.median(m.prefill_s):.3f} "
        f"prefill_ms_mean={1e3 * statistics.mean(m.prefill_s):.3f} "
        f"max_memory_allocated_gb={peak / 1e9:.3f}")
    if not all(r.phase.value == "done" and r.generated == r.max_new_tokens
               for r in reqs):
        raise AssertionError(f"{label}: not every request finished")
    return m, counts


def check_k1_on_ring(K, cache, q, window, label):
    """K1 over one layer's ring cache, or a full cache with window 0
    (every slot at the last position it holds, per kv_pos), read as the
    model's adapter reads it: against its plain version (`check_k1`,
    which also times it beside its bound, the plain version and SDPA; and
    the split lengths scanned) and against the dense oracle with the
    window. Returns (kernels-line numbers, the oracle's max error)."""
    from repro_torch.models import attention as A
    kc, vc, kv_pos = cache["k"], cache["v"], cache["kv_pos"]
    B, S, KV, hd = kc.shape
    pos = kv_pos.amax(dim=1)
    lengths = torch.clamp(pos + 1, max=S).to(torch.int32)
    n = S // 64
    args = (q, kc.reshape(B * n, 64, KV, hd), vc.reshape(B * n, 64, KV, hd),
            torch.arange(B * n, dtype=torch.int32,
                         device=q.device).reshape(B, n), lengths)
    row = check_k1(K, *args, label=f"{label}, positions {pos.tolist()}, "
                   f"ring {S}, lengths {lengths.tolist()}")
    k1_split_scan(K, args, label)
    got = K.paged_decode_attention(*args).float()
    oracle = A.decode_attn_ref(q, kc, vc, kv_pos, pos, window).float()
    torch.cuda.synchronize()
    err = (got - oracle).abs().max().item()
    tol = K1_TOL[q.dtype]
    log(f"K1 {label} vs the {'windowed' if window else 'dense'} oracle "
        f"decode_attn_ref(window={window}): max_abs_err={err:.3e} (tol "
        f"{tol})")
    if not torch.allclose(got, oracle, atol=tol, rtol=tol):
        raise AssertionError(f"K1 disagrees with the windowed oracle: "
                             f"{label}")
    return row, err


def profile_prefill(label, params, cfg, n_tokens, seed):
    """One admission's prefill (1 x n_tokens, through the kernels) in a
    profiler window, after one unprofiled: wall, device busy, top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as MD
    dev = params["embed"].device
    toks = torch.randint(0, cfg.vocab_size, (1, n_tokens), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed))
    cache = MD.init_cache(cfg, 1, n_tokens, device=dev)
    MD.prefill(params, cfg, {"tokens": toks}, cache, use_kernels=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MD.prefill(params, cfg, {"tokens": toks}, cache, use_kernels=True)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_us = sum(r[1] for r in rows)
    log(f"{label} prefill of 1 x {n_tokens} tokens, profiled: wall "
        f"{window * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, device "
        f"events {sum(r[2] for r in rows)}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:5]:
        log(f"{label} prefill profile:   {us / 1e3:9.3f} ms  x{count:<5d} "
            f"{key[:80]}")


def phase11_danube(dev):
    """h2o-danube-1.8b, whole, served past its 4,096-token window: 16
    prompts of 3,900-4,500 tokens, K1 on every decode layer of every round
    over rings that wrapped; the eager/graphed A/B; K1 at hd 80 on a
    wrapped ring of the served cache. Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    # ------------------------- 11. h2o-danube-1.8b past its window --
    cfg = get_config("h2o-danube-1.8b")
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"h2o-danube-1.8b: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.head_dim}, "
        f"window {cfg.window}; weights {weight_bytes / 1e9:.3f} GB bf16, "
        f"random (seed 0), init {time.perf_counter() - t0:.2f} s")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=4608,
                        use_kernels=True, device=dev)
    ring = eng.cache["scan"]["k"].shape[2]
    if ring != cfg.window or not eng.graphs:
        raise AssertionError("danube: the cache is not a graphed ring of "
                             "the window")
    captured("danube decode step (8 slots, rings of 4096)", eng.precompile)
    cache_bytes = tree_bytes(eng.cache["scan"])
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(3900, 4501)),
                    max_new_tokens=32) for i in range(16)]
    split = sum(r.prompt_len > ring for r in reqs)
    wraps = sum(r.prompt_len <= ring < r.prompt_len + 31 for r in reqs)
    log(f"danube serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, 32 new tokens each; {split} "
        f"prefills keep the last {ring} of more tokens (the split write), "
        f"{wraps} rings wrap during decode")
    m, counts = serve_trace(eng, reqs, "danube serve")
    k1, plain = counts[("K1", "LAUNCHES")], counts[("K1", "PLAIN_CALLS")]
    read = weight_bytes - tree_bytes(params["embed"]) + cache_bytes
    log(f"danube serve: K1 launches={k1} ({cfg.num_layers} x "
        f"{m.decode_rounds} rounds = {cfg.num_layers * m.decode_rounds}), "
        f"plain calls={plain}; decode-round bound from weight and ring "
        f"reads {read / HBM_BYTES_PER_S * 1e3:.3f} ms (weights "
        f"{weight_bytes / 1e9:.3f} GB less the embedding table, rings "
        f"{cache_bytes / 1e9:.3f} GB)")
    if k1 != cfg.num_layers * m.decode_rounds or plain:
        raise AssertionError("danube decode did not run through K1")
    if int(eng.cache["scan"]["kv_pos"].amax()) < ring:
        raise AssertionError("danube: no ring wrapped")
    # K1 at hd 80 on rings that wrapped in the prefill's split write: 8
    # prompts past the window admitted (S % W from 1 to 404), held before
    # their first decode round, then on the rings the engine served after
    # 8 rounds, at the first and the last layer
    late = [Request(rid=1000 + i, arrival=0.0, prompt_len=n,
                    max_new_tokens=32)
            for i, n in enumerate((4097, 4100, 4133, 4160, 4200, 4300, 4400,
                                   4500))]
    for r in late:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32)):
            raise AssertionError("danube: the K1 check's requests were not "
                                 "admitted")
    q = torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                    generator=torch.Generator(dev).manual_seed(8)
                    ).to(torch.bfloat16)
    row, _ = check_k1_on_ring(
        K, {n: t[0] for n, t in eng.cache["scan"].items()}, q, cfg.window,
        "danube hd 80 (layer-0 rings of 8 admitted prompts of 4097-4500 "
        "tokens)")
    for _ in range(8):
        eng.decode_round()
    served = [check_k1_on_ring(
        K, {n: t[layer] for n, t in eng.cache["scan"].items()}, q,
        cfg.window, f"danube hd 80 (layer-{layer} rings served 8 decode "
        f"rounds)")[1] for layer in (0, cfg.num_layers - 1)]
    while eng.active_requests():
        eng.decode_round()
    ab_solo_rounds(eng, cfg, "danube serve")
    profile_prefill("danube", params, cfg, 4000, seed=9)
    pos = eng.cache["scan"]["kv_pos"][0].amax(dim=1) + 1
    graphed_decode_bits("danube serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        pos.to(torch.int32))
    return dict(launches=k1, shape="B 8, H 32, KV 8, hd 80, bf16, rings of "
                "4096 as 64 pages of 64", **row,
                served_rings_oracle_max_abs_err=max(served))


@contextlib.contextmanager
def recording_moe(record):
    """Call record(x, y, aux) after every MoE layer call in the block (a
    replayed graph calls nothing)."""
    from repro_torch.models import moe as M
    plain = M.moe_forward

    def recorded(p, x, *args, **kw):
        y, aux = plain(p, x, *args, **kw)
        record(x, y, aux)
        return y, aux
    M.moe_forward = recorded
    try:
        yield
    finally:
        M.moe_forward = plain


def dropped_shares(into):
    """A `recording_moe` record appending to `into` the dropped share of
    each call on more than one token per row (a prefill's, a finetune
    unit's); a decode step's single group never drops."""
    def record(x, y, aux):
        if x.shape[1] > 1:
            into.append(aux["dropped_frac"].detach())
    return record


def dropped_line(label, shares):
    d = torch.stack(shares).float().cpu()
    log(f"{label}: MoE dropped_frac over {len(shares)} layer calls: mean "
        f"{d.mean().item():.4f} max {d.max().item():.4f} min "
        f"{d.min().item():.4f}")


def moe_plain(p, x, cfg):
    """The routed MoE layer, plainly: softmax top-k (mixtral) or sigmoid
    top-k (deepseek-v3, `cfg.mla`) renormalised per token, each assignment
    ranked within its expert by a one-hot cumsum in (token, choice) order
    and dropped from rank C on (`moe_forward`'s groups and capacity), then
    a loop over the experts, each running its FFN on the tokens it kept
    and adding them back weighted; then the shared experts' FFN, where
    there are any. Returns (y, dropped share, kept assignments per
    expert)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    if S * k >= 2 * E:
        G, T = B, S
        C = max(int(round(T * k * cfg.capacity_factor / E)), 1)
    else:
        G, T = 1, B * S
        C = min(T, max(8, 4 * (-(-T * k // E))))
    xt = x.reshape(G, T, d)
    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"].float())
    scores = torch.sigmoid(logits) if cfg.mla else \
        torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    top_w = (top_w / top_w.sum(dim=-1, keepdim=True)).reshape(G, T * k)
    e_flat = top_i.reshape(G, T * k)
    onehot = F.one_hot(e_flat, E)
    rank = torch.gather(onehot.cumsum(dim=1), 2, e_flat[..., None])[..., 0] \
        - 1
    keep = rank < C
    y = torch.zeros((G, T, d), dtype=torch.float32, device=x.device)
    for g in range(G):
        for e in range(E):
            a = torch.nonzero((e_flat[g] == e) & keep[g])[:, 0]
            h = xt[g, a // k]
            act = F.silu((h @ p["gate"][e]).float()).to(x.dtype)
            out = (act * (h @ p["up"][e])) @ p["down"][e]
            y[g].index_add_(0, a // k, out.float() * top_w[g, a, None])
    y = y.to(x.dtype).reshape(B, S, d)
    if "shared" in p:
        sh = p["shared"]
        act = F.silu((x @ sh["gate"]).float()).to(x.dtype)
        y = y + (act * (x @ sh["up"])) @ sh["down"]
    return y, 1.0 - keep.float().mean(), (onehot * keep[..., None]).sum(
        dim=(0, 1))


def moe_layer_inputs(params, cfg, toks):
    """(x, y, dropped share) of every MoE layer in one forward without
    grad on `toks`."""
    from repro_torch.models import model as MD
    inputs = []
    with recording_moe(lambda x, y, aux: inputs.append(
            (x, y, aux["dropped_frac"]))), torch.no_grad():
        MD.forward(params, cfg, {"tokens": toks})
    if len(inputs) != cfg.scanned_layers:
        raise AssertionError("the forward did not run every MoE layer")
    return inputs


def check_moe_layers(params, cfg, seq_len, name="mixtral"):
    """Every MoE layer's input on 2 x seq_len tokens, of the synthetic
    corpus (a training micro-batch) and uniform (as the served prompts):
    per layer, the experts' shares of the top-k assignments (with many
    experts: the largest five, the share of the largest and how many
    experts took none), the dropped share and the mean cosine between the
    tokens' inputs (near 1: the tokens look alike to the router, so they
    pick the same experts); then `moe_forward` at full width on the first
    and the last layer's corpus input against `moe_plain`, at the bf16
    tolerance."""
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.tree import tree_map
    dev = params["embed"].device
    corpus = torch.as_tensor(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, seq_len, 2, seed=0)).batches())["tokens"],
        device=dev)
    uniform = torch.randint(0, cfg.vocab_size, (2, seq_len), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    E, k = cfg.num_experts, cfg.top_k
    p = params["scan"]["moe"]
    for source, toks in (("uniform", uniform), ("corpus", corpus)):
        inputs = moe_layer_inputs(params, cfg, toks)
        for layer, (x, _, dropped) in enumerate(inputs):
            logits = torch.einsum("btd,de->bte", x.float(),
                                  p["router"][layer].float())
            top_i = torch.topk(logits, k, dim=-1).indices
            share = torch.bincount(top_i.reshape(-1), minlength=E).float() \
                / top_i.numel()
            xn = F.normalize(x.float(), dim=-1)
            T = x.shape[1]
            cos = ((xn.sum(dim=1).square().sum(dim=-1) - T) /
                   (T * (T - 1))).mean()
            shares = [round(v, 3) for v in share.tolist()] if E <= 16 else (
                f"largest five "
                f"{[round(v, 4) for v in share.topk(5).values.tolist()]} "
                f"(even {1 / E:.4f}), none taken by "
                f"{int((share == 0).sum())} of {E}")
            log(f"{name} MoE layer {layer:2d} on 2 x {seq_len} {source} "
                f"tokens: expert shares {shares}, dropped "
                f"{dropped.item():.4f}, mean token cosine {cos.item():.4f}")
    for layer in (0, cfg.scanned_layers - 1):
        x, y, dropped = inputs[layer]
        lp = tree_map(lambda t: t[layer], p)
        expect, expect_dropped, kept = moe_plain(lp, x, cfg)
        torch.cuda.synchronize()
        err = (y.float() - expect.float()).abs().max().item()
        kept_line = kept.tolist() if E <= 16 else \
            f"max {int(kept.max())}, min {int(kept.min())}"
        log(f"{name} MoE layer {layer} moe_forward vs moe_plain (d "
            f"{cfg.d_model}, {E} experts of {cfg.moe_d_ff}, "
            f"{cfg.num_shared_experts} shared, 2 x {seq_len} "
            f"corpus tokens): max_abs_err={err:.3e} (tol 2e-2, max |y| "
            f"{expect.float().abs().max().item():.3e}), dropped "
            f"{dropped.item():.4f} / {expect_dropped.item():.4f}, kept per "
            f"expert {kept_line}")
        if not torch.allclose(y.float(), expect.float(), atol=2e-2,
                              rtol=2e-2) or \
                dropped.item() != expect_dropped.item():
            raise AssertionError(f"moe_forward disagrees with moe_plain at "
                                 f"layer {layer}")


def units_by_kind(cfg, params, seq_len, name="mixtral"):
    """The finetune units at full width (LoRA r 16 on the model's targets,
    micro-batch 2 x seq_len tokens after the stub patches where the model
    has them, accum 1): one eager iteration (an MoE model's dropped
    shares recorded), then two eager and two graphed iterations in turns,
    synchronized per unit: medians by kind, K2's launches per iteration
    by route, held at the count the layer plan gives (`k2_per_unit`).
    Returns (the launches counted in the first iteration, the graphed
    medians by kind in seconds)."""
    from repro_torch.core import colocation as C
    from repro_torch.kernels import lora_matmul as K2
    from repro_torch.models import lora as LR
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    from repro_torch.training.data import (DataConfig, Prefetcher,
                                           SyntheticCorpus)
    pc = P.PeftConfig(micro_batch=2, seq_len=seq_len, accum=1)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, pc.seq_len, pc.micro_batch, seed=0,
        **stub_inputs(cfg, seq_len))).batches(), pc.n_stage).stacked()
    ft = P.init_ft_state(cfg, pc, params, 0, staged)
    unit = P.make_unit_step(cfg, pc, params, use_kernels=True)
    total = P.units_per_iteration(cfg, pc.accum)
    per = k2_per_unit(cfg)
    n_k2 = k2_per_iteration(cfg, unit, total)
    kinds = collections.Counter(unit.kind(i) for i in range(total))
    plan = " + ".join(f"{kinds[kind]} {kind} x {per[kind]}"
                      for kind in ("EMBED", "FWD", "HEAD", "BWD",
                                   "EMBED_BWD") if per.get(kind))
    kinds_ = [MD._sub_kind(ch) for ch in cfg.hybrid_pattern] \
        if unit.scan_kind == "hybrid_block" else \
        [{"dec": "attn"}.get(unit.scan_kind, unit.scan_kind)]
    targets = "/".join(dict.fromkeys(t for kind in kinds_
                                     for t in LR._target_dims(cfg, kind)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    shares = []
    t0 = time.perf_counter()
    with recording_moe(dropped_shares(shares)):
        ft, cold = timed_unit_run(unit, unit, ft, total)
    iter_s = time.perf_counter() - t0
    counts = kernel_counts()
    front, frames = P.front_tokens(cfg), stub_inputs(cfg, seq_len)[
        "enc_frames"]
    log(f"{name} train: micro_batch 2 x seq {seq_len}"
        f"{f' after {front} patches' if front else ''}"
        f"{f' with {frames} encoder frames' if frames else ''}, accum 1, "
        f"LoRA r="
        f"{cfg.lora.rank} on {targets}; the first iteration of {total} units "
        f"in {iter_s:.3f} s (synchronized per unit), iter={ft['iter']}, "
        f"last_loss={float(ft['last_loss']):.4f} (ln V = "
        f"{float(np.log(cfg.vocab_size)):.4f}), max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    log(f"{name} train: K2 launches={counts[('K2', 'LAUNCHES')]} "
        f"({plan} = {n_k2}): wgmma {counts[('K2', 'LAUNCHES_WGMMA')]}, "
        f"WMMA {counts[('K2', 'LAUNCHES_WMMA')]}, FMA "
        f"{counts[('K2', 'LAUNCHES_F32')]}, plain calls "
        f"{counts[('K2', 'PLAIN_CALLS')]}")
    if cfg.moe:
        dropped_line(f"{name} train (FWD units and the BWD units' "
                     f"recomputed forward, 2 x {seq_len} tokens, a group "
                     f"per row)", shares)
    if counts[("K2", "LAUNCHES")] != n_k2 or \
            counts[("K2", "LAUNCHES_WGMMA")] != n_k2 or \
            counts[("K2", "PLAIN_CALLS")]:
        raise AssertionError(f"{name}'s units did not run through K2's "
                             "wgmma kernel")
    if ft["iter"] != 1 or not np.isfinite(float(ft["last_loss"])):
        raise AssertionError(f"{name}'s training iteration did not finish")
    box = {}
    captured(f"{name} units (one graph per unit of an iteration)",
             lambda: box.update(units=C.GraphedUnits(unit, ft)))
    graphed = box.pop("units")

    def graphed_step(state):
        graphed.step(state)
        return state
    by_mode = {"eager": {}, "graphed": {}}
    for mode in ("eager", "graphed", "graphed", "eager"):
        before = (K2.LAUNCHES, K2.LAUNCHES_WGMMA)
        ft, ts = timed_unit_run(unit, unit if mode == "eager"
                                else graphed_step, ft, total)
        for kind, t in ts.items():
            by_mode[mode].setdefault(kind, []).extend(t)
        moved = (K2.LAUNCHES - before[0], K2.LAUNCHES_WGMMA - before[1])
        if moved != (n_k2, n_k2):
            raise AssertionError(f"an iteration of {mode} {name} units made "
                                 f"K2 launches {moved}, not {n_k2} wgmma")
    for kind in P.UNIT_KINDS:
        if kind not in by_mode["eager"]:
            continue
        e, g = by_mode["eager"][kind], by_mode["graphed"][kind]
        log(f"{name} train: {kind:9s} units synchronized, two iterations "
            f"each in turns: eager ms_median={1e3 * statistics.median(e):.3f}"
            f", graphed ms_median={1e3 * statistics.median(g):.3f} (ratio "
            f"{statistics.median(g) / statistics.median(e):.3f})")
    log(f"{name} train: an iteration of {total} units synchronized per "
        f"unit, eager {sum(map(sum, by_mode['eager'].values())) / 2:.3f} s, "
        f"graphed {sum(map(sum, by_mode['graphed'].values())) / 2:.3f} s")
    peaks(f"{name} train")
    return counts[("K2", "LAUNCHES")], {kind: statistics.median(t)
                  for kind, t in by_mode["graphed"].items()}


def phase12_mixtral(dev, layers=16):
    """mixtral-8x7b at published width with `layers` of its 32 layers
    (32 do not fit one card): served (graphed, the A/B, a decode step held
    bit for bit against the eager one), its MoE layers held against a plain
    per-token dispatch, its units timed, then co-located as phase 7.
    Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    # ------------------------------------- 12. mixtral-8x7b, 16 layers --
    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    expert_bytes = tree_bytes([params["scan"]["moe"][n]
                               for n in ("gate", "up", "down")])
    log(f"mixtral-8x7b: {cfg.num_layers} of {full.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV of "
        f"{cfg.head_dim}, {cfg.num_experts} experts of {cfg.moe_d_ff}, top-"
        f"{cfg.top_k}, window {cfg.window}; weights {weight_bytes / 1e9:.3f}"
        f" GB bf16 (experts {expert_bytes / 1e9:.3f}), random (seed 0), "
        f"init {time.perf_counter() - t0:.2f} s")
    check_moe_layers(params, cfg, seq_len=1024)
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("mixtral decode step (8 slots)", eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    shares = []
    with recording_moe(dropped_shares(shares)):
        m, counts = serve_trace(eng, reqs, "mixtral serve")
    k1 = counts[("K1", "LAUNCHES")]
    plain = sum(n for (_, c), n in counts.items() if c == "PLAIN_CALLS")
    read = weight_bytes - tree_bytes(params["embed"])
    log(f"mixtral serve: K1 launches={k1} ({cfg.num_layers} x "
        f"{m.decode_rounds} rounds = {cfg.num_layers * m.decode_rounds}), "
        f"plain calls={plain}; decode-round bound from weight reads "
        f"{read / HBM_BYTES_PER_S * 1e3:.3f} ms (the dense dispatch runs "
        f"every expert)")
    dropped_line(f"mixtral prefill ({m.prefills} admissions x "
                 f"{cfg.num_layers} layers)", shares)
    if k1 != cfg.num_layers * m.decode_rounds or plain or \
            len(shares) != cfg.num_layers * m.prefills:
        raise AssertionError("mixtral decode did not run through K1")
    ab_solo_rounds(eng, cfg, "mixtral serve")
    profile_prefill("mixtral", params, cfg, 300, seed=9)
    pos = (eng.cache["scan"]["kv_pos"][0] >= 0).sum(dim=-1).to(torch.int32)
    graphed_decode_bits("mixtral serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev), pos)
    train_launches, _ = units_by_kind(cfg, params, seq_len=1024)
    gc.collect()
    torch.cuda.empty_cache()
    k1_colo, k2_colo, colo = phase7_colocated(cfg, params, eng, m.round_s,
                                              seq_len=1024,
                                              tag="colo mixtral")
    return dict(k1={"serve_mixtral": k1, "colocated_serve_mixtral": k1_colo},
                k2={"train_iteration_mixtral": train_launches,
                    "colocated_serve_mixtral": k2_colo},
                points=cost_points(cfg, colo))


def same_leaves(a, b):
    """Leaf by leaf, bit for bit: (all equal, the largest absolute
    difference of a leaf that differs)."""
    from repro_torch.tree import tree_leaves
    worst, equal = 0.0, True
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, int):
            equal &= x == y
        elif not torch.equal(x, y):
            equal = False
            worst = max(worst, (x.float() - y.float()).abs().max().item())
    return equal, worst


def phase13_train(device="cuda", smoke=False):
    """The finetune entry point (`launch/train.py`) in-process on full-width
    llama3-8b with K2, micro-batch 2 x 1024 (the paper's, phase 6's): 6
    steps uninterrupted with a checkpoint every 3; 3 steps into a second
    directory, then `--resume --steps 6`, the two final states held leaf
    by leaf (adapters, m, v, t) and the two step-6 checkpoints file by
    file; K2's launches per step by its counters, all on the wgmma kernel;
    2 steps of `--layer-units` (graphed units), their launches counted;
    and a blocking save of the trained state timed, the device-to-host
    copy alone and the whole commit, beside `CostModel.checkpoint_time()`
    on the H100 spec. `smoke`/`device`: the same at smoke width (a CPU
    rehearsal). Returns K2's launches on the two train paths."""
    import shutil

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.costmodel import CostModel
    from repro_torch.distributed import fault_tolerance as FT
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    # ------------------------------- 13. launch/train.py at full width --
    cfg = smoke_config("llama3-8b") if smoke else get_config("llama3-8b")
    base = ["--arch", "llama3-8b", "--device", device, "--use-kernels",
            "--batch", "2", "--seq", "32" if smoke else "1024"] + \
        (["--smoke"] if smoke else [])
    n = cfg.num_layers * len(cfg.lora.targets)
    per_step = {"one-shot": 3 * n - 3, "units": 3 * n}
    root = ROOT / "build" / "phase13"
    shutil.rmtree(root, ignore_errors=True)

    def run(label, args, steps, mode="one-shot", warmup=0):
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = train.main(base + args)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = kernel_counts()
        k2, wgmma = c[("K2", "LAUNCHES")], c[("K2", "LAUNCHES_WGMMA")]
        others = sum(v for (k, name), v in c.items()
                     if (k, name) not in (("K2", "LAUNCHES"),
                                          ("K2", "LAUNCHES_WGMMA")))
        expect = (steps + warmup) * per_step[mode]
        log(f"train.py {label}: {steps} step(s) in {secs:.2f} s (the "
            f"weights' init, {'the capture, ' if warmup else ''}and the "
            f"checkpoints' writes included); K2 launches={k2} = "
            f"{steps + warmup} x {per_step[mode]}, on the wgmma kernel "
            f"{wgmma}, every other launch and plain call {others}")
        if k2 != expect or wgmma != k2 or others:
            raise AssertionError(f"train.py {label} did not run every "
                                 "adapted projection through K2's wgmma "
                                 "kernel")
        return out, k2

    seq = base[base.index("--seq") + 1]
    log(f"train.py: {cfg.name}, micro-batch 2 x {seq}, LoRA r "
        f"{cfg.lora.rank} on {'/'.join(cfg.lora.targets)}; K2 per one-shot "
        f"step: forward {n}, remat recompute {n}, backward dx "
        f"{n - 3} (layer 0's q/k/v input needs no gradient) = "
        f"{per_step['one-shot']}; per iteration of units {n} FWD + {2 * n} "
        f"BWD = {per_step['units']}")
    whole, k2_oneshot = run("6 steps uninterrupted",
                            ["--steps", "6", "--ckpt-every", "3",
                             "--ckpt-dir", str(root / "a")], 6)
    run("3 steps", ["--steps", "3", "--ckpt-every", "3", "--ckpt-dir",
                    str(root / "b")], 3)
    resumed, _ = run("--resume to 6 steps",
                     ["--steps", "6", "--ckpt-every", "3", "--ckpt-dir",
                      str(root / "b"), "--resume"], 3)
    files = [sorted((root / d / "step_6").iterdir()) for d in ("a", "b")]
    same_files = [p.name for p in files[0]] == [p.name for p in files[1]] \
        and all(p.read_bytes() == q.read_bytes()
                for p, q in zip(*files) if p.suffix == ".npy")
    pairs = [("adapters", whole["adapters"], resumed["adapters"])] + [
        (k, whole["opt"][k], resumed["opt"][k]) for k in ("m", "v", "t")]
    parts = {name: same_leaves(a, b) for name, a, b in pairs}
    log("train.py: resumed vs uninterrupted, leaf by leaf: " + ", ".join(
        f"{k} bit-equal {eq} (max |diff| {d:.3e})"
        for k, (eq, d) in parts.items())
        + f"; step-6 checkpoint files byte-equal {same_files}")
    if not all(eq for eq, _ in parts.values()):
        # not deterministic: hold to bf16's 2e-2 and name what differs
        if not parts["t"][0]:
            raise AssertionError("train.py: the resumed run's step differs")
        for name, a, b in pairs[:3]:
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                if not torch.allclose(x, y, rtol=2e-2, atol=2e-2 * float(
                        y.abs().max())):
                    raise AssertionError(f"train.py: the resumed run's {name}"
                                         " differ beyond bf16's 2e-2")
    elif not same_files:
        raise AssertionError("train.py: equal states wrote unequal "
                             "checkpoints")
    units, k2_units = run("--layer-units", ["--steps", "2",
                                            "--layer-units"], 2, mode="units",
                          warmup=1 if device == "cuda" else 0)
    if units["iter"] != 2 or not np.isfinite(float(units["last_loss"])):
        raise AssertionError("train.py --layer-units did not train")
    log(f"train.py --layer-units: last loss {float(units['last_loss']):.4f}"
        f" (ln V = {float(np.log(cfg.vocab_size)):.4f})")
    del units

    state = {"adapters": whole["adapters"], "opt": whole["opt"]}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state)
                 if isinstance(t, torch.Tensor))
    mgr = FT.CheckpointManager(root / "t", keep=1)
    copy_s, commit_s = [], []
    for i in range(3):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        FT.snapshot(state)
        copy_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        mgr.save(i, state)
        commit_s.append(time.perf_counter() - t0)
    cm = CostModel(cfg)
    trainable = cfg.lora_param_count()
    log(f"checkpoint: the trained state {nbytes / 1e6:.1f} MB (adapters "
        f"f32, m and v f32: {nbytes / trainable:.0f} bytes per trainable "
        f"parameter); blocking save, three times: device-to-host copy "
        f"{[round(1e3 * t, 3) for t in copy_s]} ms, whole commit "
        f"{[round(1e3 * t, 3) for t in commit_s]} ms (median "
        f"{1e3 * statistics.median(copy_s):.3f} / "
        f"{1e3 * statistics.median(commit_s):.3f}; copy at "
        f"{nbytes / statistics.median(copy_s) / 1e9:.2f} GB/s); "
        f"CostModel.checkpoint_time() on {cm.inst.chip.name}: "
        f"{1e3 * cm.checkpoint_time():.3f} ms ({trainable:,} x (2 + 8) bytes "
        f"= {trainable * 10 / 1e6:.1f} MB over "
        f"{cm.inst.host_dma_bw / 1e9:.0f} GB/s)")
    # the uninterrupted run's checkpoints stay for phase 20
    for sub in ("b", "t"):
        shutil.rmtree(root / sub, ignore_errors=True)
    return {"train_oneshot": k2_oneshot, "train_units": k2_units}


# the checkpoints of phase 13's uninterrupted run, which phase 20 restores
PHASE13_CKPT = ROOT / "build" / "phase13" / "a"


# deepseek-v3 at 3 dense + 2 MoE layers, reckoned before the run in bf16
# (router f32): GB by part, and the decode round's weight reads at the
# HBM rate (embedding gather and MTP head left out)
DEEPSEEK_RECKONING_GB = {"embed + unembed": 3.707, "dense layer": 1.167,
                         "MoE layer": 23.018, "MTP head": 1.372,
                         "total": 54.62}
# MLA decode, absorbed (bf16 roundings of q_lat, the softmax weights and
# o) vs the unabsorbed form in f32 on the same cache: the bf16 tolerance
# of tests/test_kernels.py, relative to the output's largest entry
MLA_TOL = 2e-2
# prefill + decode vs the full forward, relative to the largest |logit|,
# per layer of the model: each layer's absorbed MLA decode is held within
# MLA_TOL of its largest output (`mla_decode_checks`); with the routing
# the same on both paths, the residual stream adds up the layers'
# differences at the decoded position and the logits read its normed
# end, so they agree within layers x MLA_TOL of their largest entry
# (LOGIT_TOL, 0.25 absolute, was set for llama3's 32 layers through K1)
DECODE_LOGIT_TOL_PER_LAYER = MLA_TOL


def mla_decode_checks(params, cfg, cache, label):
    """The absorbed MLA decode (`attention.mla_decode`) on the card against
    the unabsorbed form (`mla_decode_expanded`: every cached token's K and
    V expanded from its latent through W_kv_b, f32), on the first and the
    last layer's served latent caches, every slot at its next position,
    for a unit-RMS bf16 input (as the layer's normed hidden state); both
    timed. MLA's plain oracle: no TPU kernel covers it."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as MD
    layers, caches = MD._layers(cfg, params), MD._layers(cfg, cache)
    first = caches[0][1]
    dev = first["c_kv"].device
    pos = (first["kv_pos"] >= 0).sum(dim=-1).to(torch.int32)
    x = torch.randn((pos.shape[0], 1, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(14)
                    ).to(torch.bfloat16)
    for j in (0, len(layers) - 1):
        p, lc = layers[j][1]["attn"], caches[j][1]
        expect = A.mla_decode_expanded(p, x, pos, clone_tree(lc), cfg)
        got, _ = A.mla_decode(p, x, pos, clone_tree(lc), cfg)
        torch.cuda.synchronize()
        scale = expect.float().abs().max().item()
        err = (got.float() - expect.float()).abs().max().item()
        scratch = clone_tree(lc)
        ms = time_ms(lambda: A.mla_decode(p, x, pos, scratch, cfg))
        plain_ms = time_ms(lambda: A.mla_decode_expanded(p, x, pos, scratch,
                                                         cfg), iters=10)
        log(f"{label} layer {j} ({layers[j][0]}): absorbed MLA decode vs "
            f"the unabsorbed form on the served latent cache (8 slots, "
            f"positions {pos.tolist()}): max_abs_err={err:.3e} = "
            f"{err / scale:.3e} of max |out| {scale:.3e} (tol {MLA_TOL}); "
            f"absorbed ms={ms:.4f}, unabsorbed (f32) ms={plain_ms:.4f}")
        if err > MLA_TOL * scale or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: the absorbed MLA decode "
                                 f"disagrees with the unabsorbed form at "
                                 f"layer {j}")


@contextlib.contextmanager
def top_k_hook(hook):
    """moe_forward's top-k in the block goes through hook(scores, k,
    plain), `plain` being the port's own `_top_k`."""
    from repro_torch.models import moe as M
    plain = M._top_k
    M._top_k = lambda scores, k: hook(scores, k, plain)
    try:
        yield
    finally:
        M._top_k = plain


def routing_at(into, row):
    """A `top_k_hook` recording, at each MoE layer, the scores and the
    chosen experts of token `row` of the first group."""
    def hook(scores, k, plain):
        w, i = plain(scores, k)
        into.append((scores[0, row].float(), i[0, row]))
        return w, i
    return hook


def pinned_to(choices):
    """A `top_k_hook` that takes, at the j-th MoE layer, the experts
    `choices[j][1]` in that order, with this path's own scores."""
    calls = iter(choices)

    def hook(scores, k, plain):
        i = next(calls)[1].expand(*scores.shape[:-1], k)
        return torch.gather(scores, -1, i), i
    return hook


def prefill_decode_vs_forward(params, cfg, n, label):
    """A prefill of n tokens then one decode step, against `forward` over
    the n + 1 tokens at position n, at the served top-k, with capacity
    T (C = T * k * E/k / E): the forward drops nothing at position n, as
    the decode at one token never does. Both paths' routing of token n
    is recorded at every MoE layer and printed: where the chosen experts
    differ, the layer, the experts swapped, their scores on both paths,
    the forward's margin between its k-th and (k+1)-th score and the
    largest score difference between the paths. Where they differ, the
    decode runs again with its routing pinned to the forward's, and that
    decode is held: a swap moves the output by a whole expert's share,
    which is no measure of the attention paths. Held at layers x
    DECODE_LOGIT_TOL_PER_LAYER of the largest |logit|."""
    from repro_torch.models import model as MD
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                              / cfg.top_k)
    dev = params["embed"].device
    toks = torch.randint(0, cfg.vocab_size, (1, n + 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(15))
    pos = torch.tensor([n], dtype=torch.int32, device=dev)
    fwd, dec = [], []
    with torch.no_grad():
        cache = MD.init_cache(cfg, 1, n + 1, device=dev)
        MD.prefill(params, cfg, {"tokens": toks[:, :n]}, cache)
        prefilled = clone_tree(cache)
        with top_k_hook(routing_at(dec, 0)):
            got, _ = MD.decode_step(params, cfg, toks[:, n].to(torch.int32),
                                    pos, cache)
        with top_k_hook(routing_at(fwd, n)):
            expect = MD.forward(params, cfg, {"tokens": toks})[0][:, n]
    torch.cuda.synchronize()
    if len(fwd) != cfg.scanned_layers or len(dec) != cfg.scanned_layers:
        raise AssertionError(f"{label}: a path skipped an MoE layer")
    scale = expect.float().abs().max().item()
    tol = cfg.num_layers * DECODE_LOGIT_TOL_PER_LAYER
    err = (got.float() - expect.float()).abs().max().item()
    swapped = []
    for j, ((sf, cf), (sd, cd)) in enumerate(zip(fwd, dec)):
        top = torch.sort(sf, descending=True).values
        margin = (top[cfg.top_k - 1] - top[cfg.top_k]).item()
        delta = (sf - sd).abs().max().item()
        out = sorted(set(cf.tolist()) - set(cd.tolist()))
        inn = sorted(set(cd.tolist()) - set(cf.tolist()))
        log(f"{label}: MoE layer {j} routing of token {n}: forward top-"
            f"{cfg.top_k} {cf.tolist()}, decode {cd.tolist()}; the "
            f"forward's margin (score {cfg.top_k} - score {cfg.top_k + 1}) "
            f"{margin:.3e}, largest |score difference| between the paths "
            f"{delta:.3e}" + (
                "; the same experts" if not out else
                f"; swapped: forward only {out} (forward scores "
                f"{[round(sf[e].item(), 6) for e in out]}, decode "
                f"{[round(sd[e].item(), 6) for e in out]}), decode only "
                f"{inn} (forward {[round(sf[e].item(), 6) for e in inn]}, "
                f"decode {[round(sd[e].item(), 6) for e in inn]})"))
        if out:
            swapped.append(j)
    log(f"{label}: prefill of {n} tokens then a decode step vs forward's "
        f"logit at position {n} (top-{cfg.top_k}, nothing dropped), routing "
        f"{'as each path chose' if not swapped else 'differs at MoE layers '}"
        f"{swapped if swapped else ''}: max |dlogit| {err:.4f} = "
        f"{err / scale:.3e} of max |logit| {scale:.3f}")
    if swapped:
        with torch.no_grad(), top_k_hook(pinned_to(fwd)):
            got, _ = MD.decode_step(params, cfg, toks[:, n].to(torch.int32),
                                    pos, clone_tree(prefilled))
        torch.cuda.synchronize()
        err = (got.float() - expect.float()).abs().max().item()
    same = bool((got.argmax(-1) == expect.argmax(-1)).all())
    log(f"{label}: prefill + decode"
        f"{' with the routing pinned to the forward' if swapped else ''} vs "
        f"forward at position {n}: max |dlogit| {err:.4f} = "
        f"{err / scale:.3e} of max |logit| (tol {cfg.num_layers} layers x "
        f"{DECODE_LOGIT_TOL_PER_LAYER} = {tol:.3g}), same greedy token "
        f"{same}")
    if err > tol * scale or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: prefill + decode disagrees with the "
                             "full forward")


def k2_per_step(cfg):
    """K2 launches of a one-shot train step with remat: each adapted
    projection of each layer forward, recomputed and its dx, less the
    first layer's projections whose input depends on no adapter."""
    from repro_torch.models import model as MD
    pre, scan_kind, n, post = MD._plan(cfg)
    per_layer = [k2_projections(cfg, kind)
                 for kind in pre + [scan_kind] * n + post]
    return 3 * sum(per_layer) - first_layer_no_dx(cfg)


def one_shot_step(cfg, params, seq_len, label):
    """One `make_train_step` step (remat, K2) at full width on a 2 x
    seq_len micro-batch of the corpus: `loss_fn` with its MoE aux and MTP
    terms, so `_mtp_loss` runs on the card. K2's launches held at
    `k2_per_step`, all wgmma; ce, aux and mtp_ce printed and finite.
    Returns K2's launches counted in the step."""
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    dev = params["embed"].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(
        SyntheticCorpus(DataConfig(cfg.vocab_size, seq_len, 2, seed=2,
                                   **stub_inputs(cfg, seq_len))).batches()
    ).items()}
    adapters = MD.init_adapters(cfg, 1, device=dev)
    step = P.make_train_step(cfg, AdamWConfig(), use_kernels=True,
                             remat=True)
    step(params, adapters, adamw_init(adapters), batch)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    _, _, m = step(params, adapters, adamw_init(adapters), batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = kernel_counts()
    expect = k2_per_step(cfg)
    vals = {k: float(v) for k, v in m.items()}
    terms = f" + {MD.MOE_AUX_COEF} x aux {vals['aux']:.4f} / " \
        f"{cfg.num_layers}" if cfg.moe else ""
    if "mtp_ce" in vals:
        terms += f" + {MD.MTP_COEF} x mtp_ce {vals['mtp_ce']:.4f}"
    front = P.front_tokens(cfg)
    log(f"{label}: one make_train_step step (remat, K2) on 2 x {seq_len} "
        f"tokens{f' after {front} patches' if front else ''} in "
        f"{secs:.3f} s: loss {vals['loss']:.4f} = ce {vals['ce']:.4f}"
        f"{terms} (ln V = {float(np.log(cfg.vocab_size)):.4f}); K2 launches="
        f"{c[('K2', 'LAUNCHES')]} (expected {expect}: 3 x the adapted "
        f"projections less the first layer's "
        f"{first_layer_no_dx(cfg)} with no dx), wgmma "
        f"{c[('K2', 'LAUNCHES_WGMMA')]}, plain calls "
        f"{c[('K2', 'PLAIN_CALLS')]}; max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{label}: the train step's losses are not "
                             "finite")
    if c[("K2", "LAUNCHES")] != expect or \
            c[("K2", "LAUNCHES_WGMMA")] != expect or c[("K2", "PLAIN_CALLS")]:
        raise AssertionError(f"{label}: the train step did not run every "
                             "adapted projection through K2's wgmma kernel")
    return c[("K2", "LAUNCHES")]


def phase14_deepseek(dev, layers=5):
    """deepseek-v3-671b at published width with `layers` of its 61 (its 3
    dense layers in "pre", the rest MoE, scanned): bytes beside the
    reckoning, every MoE layer against `moe_plain`, served from the decode
    graph with no K1 (MLA decode has no kernel, in the reference too),
    the A/B and a graphed step bit-equal to the eager one, the round
    beside its weight-read bound and the cost model's solo round, the
    absorbed MLA decode against the unabsorbed form, a prefill + decode
    against the full forward, the units by kind (K2 on wgmma at the plan's
    count), one one-shot step (the MTP loss on the card), then co-located
    as phase 7. Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import CostModel, InstanceSpec
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    # --------------------------------- 14. deepseek-v3, 3 + 2 layers --
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_pre = len(params["pre"])
    parts = {"embed + unembed": tree_bytes([params["embed"],
                                            params["unembed"]]),
             "dense layer": tree_bytes(params["pre"]) / n_pre,
             "MoE layer": tree_bytes(params["scan"]) / cfg.scanned_layers,
             "MTP head": tree_bytes(params["mtp"]),
             "total": tree_bytes(params)}
    log(f"deepseek-v3: {cfg.num_layers} of {full.num_layers} layers ({n_pre}"
        f" dense in pre, {cfg.scanned_layers} MoE scanned), d "
        f"{cfg.d_model}, {cfg.num_heads} heads, MLA q/kv rank "
        f"{cfg.mla_q_rank}/{cfg.mla_kv_rank}, rope {cfg.mla_rope_dim}, nope "
        f"{cfg.mla_nope_dim}, v {cfg.mla_v_dim}; dense d_ff {cfg.d_ff}; "
        f"{cfg.num_experts} experts of {cfg.moe_d_ff}, top-{cfg.top_k}, "
        f"sigmoid router, {cfg.num_shared_experts} shared; vocab "
        f"{cfg.vocab_size}, MTP; random (seed 0), init {init_s:.2f} s")
    log("deepseek-v3 weights, GB measured (reckoned): " + ", ".join(
        f"{k} {v / 1e9:.3f} ({DEEPSEEK_RECKONING_GB[k]})"
        for k, v in parts.items()))
    check_moe_layers(params, cfg, seq_len=1024, name="deepseek-v3")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("deepseek-v3 decode step (8 slots)", eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    shares = []
    with recording_moe(dropped_shares(shares)):
        m, counts = serve_trace(eng, reqs, "deepseek-v3 serve")
    k1 = counts[("K1", "LAUNCHES")]
    launched = sum(counts.values())
    cache_mb = tree_bytes(eng.cache) / 1e6
    log(f"deepseek-v3 serve: K1 launches={k1} (MLA decode runs no decode "
        f"kernel), every kernel launch and plain call {launched}; the "
        f"latent cache (8 slots x 1024 x {cfg.num_layers} layers) "
        f"{cache_mb:.1f} MB")
    dropped_line(f"deepseek-v3 prefill ({m.prefills} admissions x "
                 f"{cfg.scanned_layers} MoE layers)", shares)
    if launched or len(shares) != cfg.scanned_layers * m.prefills:
        raise AssertionError("deepseek-v3's serving launched a kernel, or "
                             "skipped an MoE layer")
    ab = ab_solo_rounds(eng, cfg, "deepseek-v3 serve")
    ctx = float((eng.cache["pre"][0]["kv_pos"] >= 0).sum(dim=-1).float()
                .mean())
    read = parts["total"] - tree_bytes(params["embed"]) - parts["MTP head"]
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    model_ms = 1e3 * CostModel(cfg, InstanceSpec()).decode_solo(
        8, ctx, noisy=False)
    log(f"deepseek-v3 serve: graphed solo round at 8 slots median "
        f"{1e3 * ab['graphed'][0]:.3f} ms, p90 {1e3 * ab['graphed'][1]:.3f}"
        f" ms; bound from weight reads {read / 1e9:.2f} GB / "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms:.3f} ms (ratio "
        f"{1e3 * ab['graphed'][0] / bound_ms:.3f}; the dense dispatch runs "
        f"all {cfg.num_experts} experts); the cost model's solo round "
        f"(committed constants, {InstanceSpec().chip.name}, bs 8, mean "
        f"context {ctx:.0f}) {model_ms:.3f} ms")
    graphed_decode_bits("deepseek-v3 serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        (eng.cache["pre"][0]["kv_pos"] >= 0).sum(
                            dim=-1).to(torch.int32))
    mla_decode_checks(params, cfg, eng.cache, "deepseek-v3 MLA")
    prefill_decode_vs_forward(params, cfg, 300, "deepseek-v3")
    profile_prefill("deepseek-v3", params, cfg, 300, seed=9)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, _ = units_by_kind(cfg, params, seq_len=1024,
                                  name="deepseek-v3")
    gc.collect()
    torch.cuda.empty_cache()
    oneshot = one_shot_step(cfg, params, 1024, "deepseek-v3 train")
    gc.collect()
    torch.cuda.empty_cache()
    k1_colo, k2_colo, _ = phase7_colocated(cfg, params, eng, m.round_s,
                                           seq_len=1024,
                                           tag="colo deepseek-v3")
    return dict(k1={"serve_deepseek": k1, "colocated_serve_deepseek":
                    k1_colo},
                k2={"train_iteration_deepseek": train_launches,
                    "train_oneshot_deepseek": oneshot,
                    "colocated_serve_deepseek": k2_colo})


# the parameter trees' sizes: ModelConfig.param_count() and the final norm
# (d_model), which param_count leaves out
RECURRENTGEMMA_PARAMS = 2_673_297_920
PHI3_VISION_PARAMS = 3_821_079_552


def decode_vs_forward(params, cfg, n, label):
    """A prefill of n tokens (after the stub patches, or with 256 stub
    encoder frames, where the model has them) and one decode step, through
    the kernels, against `forward` over the n + 1 tokens at token n (its
    hidden row, projected as the decode's head projects it). Held at
    layers x DECODE_LOGIT_TOL_PER_LAYER of the largest |logit|, phase 14's
    rule."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    dev = params["embed"].device
    gen = torch.Generator(dev).manual_seed(15)
    toks = torch.randint(0, cfg.vocab_size, (1, n + 1), device=dev,
                         generator=gen)
    front = P.front_tokens(cfg)
    enc_len = SEAMLESS_FRAMES if cfg.enc_layers else 0
    batch = {"tokens": toks[:, :n]}
    if front:
        batch["frontend"] = torch.randn((1, front, cfg.d_model), device=dev,
                                        generator=gen)
    if enc_len:
        batch["enc_frames"] = torch.randn((1, enc_len, cfg.d_model),
                                          device=dev, generator=gen)
    with torch.no_grad():
        cache = MD.init_cache(cfg, 1, front + n + 1, enc_len, device=dev)
        MD.prefill(params, cfg, batch, cache, use_kernels=True)
        got, _ = MD.decode_step(
            params, cfg, toks[:, n].to(torch.int32),
            torch.tensor([front + n], dtype=torch.int32, device=dev), cache,
            use_kernels=True)
        hidden, _ = MD.forward(params, cfg, dict(batch, tokens=toks),
                               return_hidden=True)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        expect = L.lm_logits(hidden[:, n:n + 1], table)[:, 0]
    torch.cuda.synchronize()
    scale = expect.float().abs().max().item()
    err = (got.float() - expect.float()).abs().max().item()
    tol = cfg.num_layers * DECODE_LOGIT_TOL_PER_LAYER
    same = bool((got.argmax(-1) == expect.argmax(-1)).all())
    log(f"{label}: prefill of {n} tokens"
        f"{f' after {front} patches' if front else ''}"
        f"{f' with {enc_len} encoder frames' if enc_len else ''} then a "
        f"decode step "
        f"(kernels on) vs forward at token {n}: max |dlogit| {err:.4f} = "
        f"{err / scale:.3e} of max |logit| {scale:.3f} (tol "
        f"{cfg.num_layers} layers x {DECODE_LOGIT_TOL_PER_LAYER} = "
        f"{tol:.3g}), same greedy token {same}")
    if err > tol * scale or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: prefill + decode disagrees with the "
                             "full forward")


def train_main_step(arch, seq_len, label, steps=1, units=False):
    """`steps` steps of `launch/train.py`'s `main` on the full-width
    `arch`, micro-batch 2 x seq_len, K2 on every adapted projection: in
    one-shot mode (`k2_per_step` launches a step) or with --layer-units
    (graphed units: the capture's warm-up runs one iteration for real,
    then each step replays one, `k2_per_unit` summed over an iteration).
    K2's launches held at that count, all wgmma, and the loss finite.
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    cfg = get_config(arch)
    if units:
        _, _, n, _ = MD._plan(cfg)
        per = k2_per_unit(cfg)
        per_step = per["EMBED"] + per["HEAD"] + per["EMBED_BWD"] + \
            n * (per["FWD"] + per["BWD"])
        expect = (steps + 1) * per_step
        why = f"{steps} + 1 (the capture's warm-up) iterations x {per_step}"
    else:
        expect = steps * k2_per_step(cfg)
        why = f"{steps} x (3 x the adapted projections less the first " \
            f"layer's {first_layer_no_dx(cfg)} with no dx)"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, "--steps", str(steps), "--batch", "2",
                      "--seq", str(seq_len), "--use-kernels"]
                     + (["--layer-units"] if units else []))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = kernel_counts()
    front, frames = P.front_tokens(cfg), stub_inputs(cfg, seq_len)[
        "enc_frames"]
    log(f"{label}: launch/train.py main, {steps} "
        f"{'--layer-units' if units else 'one-shot'} step(s) on 2 x "
        f"{seq_len} tokens{f' after {front} patches' if front else ''}"
        f"{f' with {frames} encoder frames' if frames else ''} (init "
        f"included) in {secs:.3f} s: K2 launches="
        f"{c[('K2', 'LAUNCHES')]} (expected {expect}: {why}), wgmma "
        f"{c[('K2', 'LAUNCHES_WGMMA')]}, plain calls "
        f"{c[('K2', 'PLAIN_CALLS')]}; max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    if c[("K2", "LAUNCHES")] != expect or \
            c[("K2", "LAUNCHES_WGMMA")] != expect or c[("K2", "PLAIN_CALLS")]:
        raise AssertionError(f"{label}: the train step did not run every "
                             "adapted projection through K2's wgmma kernel")
    loss = out["last_loss"] if units else None
    if out["opt"]["t"] != steps or \
            (units and not np.isfinite(float(loss))):
        raise AssertionError(f"{label}: the train steps did not finish")
    del out
    return c[("K2", "LAUNCHES")]


def served_round_bound(label, cfg, params, eng, ab, ctx):
    """The graphed solo round beside the least time of its weight and
    cache reads (the whole cache, an upper count) and the cost model's
    solo round (committed constants, bs 8, mean context `ctx`)."""
    from repro_torch.core.costmodel import CostModel, InstanceSpec
    read = tree_bytes(params) + tree_bytes(eng.cache)
    if not cfg.tie_embeddings:          # the input embedding: 8 rows read
        read -= tree_bytes(params["embed"])
    if cfg.enc_layers:      # the encoder runs at admission; the cross K/V
        xattn = params["scan"]["xattn"]         # are read from the cache
        read -= tree_bytes(params["enc"]) + tree_bytes(xattn["wk"]) + \
            tree_bytes(xattn["wv"])
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    model_ms = 1e3 * CostModel(cfg, InstanceSpec()).decode_solo(
        8, ctx, noisy=False)
    log(f"{label}: graphed solo round at 8 slots median "
        f"{1e3 * ab['graphed'][0]:.3f} ms, p90 {1e3 * ab['graphed'][1]:.3f}"
        f" ms; bound from weight and cache reads {read / 1e9:.3f} GB / "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms:.3f} ms (ratio "
        f"{1e3 * ab['graphed'][0] / bound_ms:.3f}); the cost model's solo "
        f"round ({InstanceSpec().chip.name}, bs 8, mean context {ctx:.0f}) "
        f"{model_ms:.3f} ms")


def phase15_recurrentgemma(dev):
    """recurrentgemma-2b, whole (26 layers: 8 "rra" superblocks and 2
    trailing RG-LRU layers), served on local-attention rings of 2048 that
    wrap (16 prompts of 1,900-2,600 tokens, 32 new tokens each), K1 on
    every decode of its 8 attention layers; K1 at hd 256 (MQA, g 10) on
    wrapped rings after 8 served rounds against its plain version and the
    windowed oracle; the A/B and a graphed step bit-equal to the eager
    one; prefill + decode against the forward; the units by kind (K2 at
    the plan's count), one `launch/train.py` step, and co-located serving
    with the fitted predictor. Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.tree import tree_leaves
    # ------------------------------- 15. recurrentgemma-2b, whole --
    cfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, _, n_blocks, post = MD._plan(cfg)
    count = sum(t.numel() for t in tree_leaves(params))
    rg_layer = sum(t.numel() for t in tree_leaves(params["post"][0]))
    attn_layer = sum(t.numel() for t in tree_leaves(params["scan"]["sub2"])
                     ) // n_blocks
    log(f"recurrentgemma-2b: {n_blocks} superblocks of {cfg.hybrid_pattern!r}"
        f" and {len(post)} post layers ({cfg.num_layers}), d {cfg.d_model}, "
        f"RG-LRU width {cfg.rglru_width or cfg.d_model}, local attention "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.head_dim}, "
        f"window {cfg.local_window}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (tied); parameters {count:,} (param_count "
        f"{cfg.param_count():,} + the final norm): RG-LRU layer "
        f"{rg_layer:,}, attention layer {attn_layer:,}, embedding "
        f"{params['embed'].numel():,}; weights "
        f"{tree_bytes(params) / 1e9:.3f} GB bf16, random (seed 0), init "
        f"{init_s:.2f} s")
    if count != cfg.param_count() + cfg.d_model or \
            count != RECURRENTGEMMA_PARAMS:
        raise AssertionError("recurrentgemma-2b: the parameter count is not "
                             "the configuration's")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=3072,
                        use_kernels=True, device=dev)
    rings = eng.cache["scan"]["sub2"]
    ring = rings["k"].shape[2]
    if ring != cfg.local_window or not eng.graphs:
        raise AssertionError("recurrentgemma: the cache is not a graphed "
                             "ring of the window")
    captured(f"recurrentgemma decode step (8 slots, rings of {ring})",
             eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(1900, 2601)),
                    max_new_tokens=32) for i in range(16)]
    log(f"recurrentgemma serve: {len(reqs)} requests, prompts "
        f"{[r.prompt_len for r in reqs]}, 32 new tokens each; "
        f"{sum(r.prompt_len > ring for r in reqs)} prefills keep the last "
        f"{ring} of more tokens (the split write), "
        f"{sum(r.prompt_len <= ring < r.prompt_len + 31 for r in reqs)} "
        f"rings wrap during decode; the RG-LRU state is "
        f"{tree_bytes(eng.cache) - tree_bytes(rings):,} bytes for 8 slots")
    m, counts = serve_trace(eng, reqs, "recurrentgemma serve")
    n_attn = len(cfg.attn_layer_indices())
    k1, plain = counts[("K1", "LAUNCHES")], counts[("K1", "PLAIN_CALLS")]
    log(f"recurrentgemma serve: K1 launches={k1} ({n_attn} attention layers"
        f" x {m.decode_rounds} rounds = {n_attn * m.decode_rounds}), plain "
        f"calls={plain}")
    if k1 != n_attn * m.decode_rounds or plain:
        raise AssertionError("recurrentgemma decode did not run its "
                             "attention layers through K1")
    if int(rings["kv_pos"].amax()) < ring:
        raise AssertionError("recurrentgemma: no ring wrapped")
    # K1 at hd 256 (one KV head for 10 query heads) on rings past the
    # window: 8 prompts admitted, 8 rounds served, then the first and the
    # last attention layer's rings
    late = [Request(rid=1000 + i, arrival=0.0, prompt_len=n,
                    max_new_tokens=32)
            for i, n in enumerate((2049, 2100, 2200, 2300, 2400, 2500, 2550,
                                   2600))]
    for r in late:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32)):
            raise AssertionError("recurrentgemma: the K1 check's requests "
                                 "were not admitted")
    for _ in range(8):
        eng.decode_round()
    q = torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                    generator=torch.Generator(dev).manual_seed(8)
                    ).to(torch.bfloat16)
    checked = [check_k1_on_ring(
        K, {n: t[layer] for n, t in rings.items()}, q, cfg.local_window,
        f"recurrentgemma hd 256 MQA g 10 (attention layer {layer}'s rings, "
        f"prompts of 2049-2600 tokens served 8 decode rounds)")
        for layer in (0, n_blocks - 1)]
    while eng.active_requests():
        eng.decode_round()
    ab = ab_solo_rounds(eng, cfg, "recurrentgemma serve")
    ctx = float((rings["kv_pos"][0] >= 0).sum(dim=-1).float().mean())
    served_round_bound("recurrentgemma serve", cfg, params, eng, ab, ctx)
    pos = rings["kv_pos"][0].amax(dim=1) + 1
    graphed_decode_bits("recurrentgemma serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        pos.to(torch.int32))
    decode_vs_forward(params, cfg, 2100, "recurrentgemma")
    profile_prefill("recurrentgemma", params, cfg, 2048, seed=9)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, _ = units_by_kind(cfg, params, seq_len=1024,
                                      name="recurrentgemma")
    gc.collect()
    torch.cuda.empty_cache()
    oneshot = train_main_step("recurrentgemma-2b", 1024, "recurrentgemma "
                              "train")
    gc.collect()
    torch.cuda.empty_cache()
    k1_colo, k2_colo, _ = phase7_colocated(cfg, params, eng, m.round_s,
                                           seq_len=1024,
                                           tag="colo recurrentgemma")
    return dict(k1={"serve_recurrentgemma": k1,
                    "colocated_serve_recurrentgemma": k1_colo},
                hd256=dict(checked[0][0], shape="B 8, H 10, KV 1, hd 256, "
                           "bf16, rings of 2048 as 32 pages of 64",
                           served_rings_oracle_max_abs_err=max(
                               c[1] for c in checked)),
                k2={"train_iteration_recurrentgemma": train_launches,
                    "train_oneshot_recurrentgemma": oneshot,
                    "colocated_serve_recurrentgemma": k2_colo})


def phase16_phi3_vision(dev):
    """phi-3-vision-4.2b, whole (32 layers, d 3072, 32 heads of hd 96),
    each request with 576 stub patch embeddings ahead of its prompt: 16
    requests served from the decode graph at s_max 1152, K1 on every
    layer of every round, decode positions after the patches; K1 at hd 96
    on the served caches against its plain version and SDPA; the A/B and
    a graphed step bit-equal to the eager one; prefill + decode against
    the forward; units whose microbatch holds 576 + 1,024 positions by
    kind, one `launch/train.py` step, and a co-located serve. Returns the
    kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.tree import tree_leaves
    # ------------------------------- 16. phi-3-vision-4.2b, whole --
    cfg = get_config("phi-3-vision-4.2b")
    F = cfg.frontend_tokens
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = sum(t.numel() for t in tree_leaves(params))
    log(f"phi-3-vision-4.2b: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {F} stub patches per "
        f"request; parameters {count:,} (param_count "
        f"{cfg.param_count():,} + the final norm), weights "
        f"{tree_bytes(params) / 1e9:.3f} GB bf16, random (seed 0), init "
        f"{init_s:.2f} s")
    if count != cfg.param_count() + cfg.d_model or \
            count != PHI3_VISION_PARAMS:
        raise AssertionError("phi-3-vision: the parameter count is not the "
                             "configuration's")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1152,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("phi-3-vision decode step (8 slots, s_max 1152)",
             eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 501)), max_new_tokens=32)
            for i in range(16)]
    log(f"phi-3-vision serve: {len(reqs)} requests of {F} patches and "
        f"prompts {[r.prompt_len for r in reqs]}, 32 new tokens each; the "
        f"KV cache {tree_bytes(eng.cache) / 1e9:.3f} GB")
    m, counts = serve_trace(eng, reqs, "phi-3-vision serve")
    k1, plain = counts[("K1", "LAUNCHES")], counts[("K1", "PLAIN_CALLS")]
    log(f"phi-3-vision serve: K1 launches={k1} ({cfg.num_layers} x "
        f"{m.decode_rounds} rounds = {cfg.num_layers * m.decode_rounds}), "
        f"plain calls={plain}")
    if k1 != cfg.num_layers * m.decode_rounds or plain:
        raise AssertionError("phi-3-vision decode did not run through K1")
    # each slot's last request wrote its patches at 0..F-1, its prompt
    # after them and its decoded tokens after the prompt
    last = {r.slot: r for r in reqs}
    kv_pos = eng.cache["scan"]["kv_pos"][0]
    want = {s: F + r.prompt_len + r.max_new_tokens - 2
            for s, r in last.items()}
    got = {s: int(kv_pos[s].amax()) for s in last}
    log(f"phi-3-vision serve: each slot's last position written (the last "
        f"request's F + prompt + 30 decoded): {got}, expected {want}")
    if got != want or int(eng.front.min()) != F:
        raise AssertionError("phi-3-vision: decode positions do not follow "
                             "the patches")
    late = [Request(rid=1000 + i, arrival=0.0, prompt_len=n,
                    max_new_tokens=32)
            for i, n in enumerate((1, 64, 100, 200, 300, 400, 450, 500))]
    for r in late:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32),
                             eng._stub_extras(r)):
            raise AssertionError("phi-3-vision: the K1 check's requests "
                                 "were not admitted")
    for _ in range(8):
        eng.decode_round()
    q = torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                    generator=torch.Generator(dev).manual_seed(8)
                    ).to(torch.bfloat16)
    checked = [check_k1_on_ring(
        K, {n: t[layer] for n, t in eng.cache["scan"].items()}, q, 0,
        f"phi-3-vision hd 96 (layer {layer}'s caches of 18 pages, {F} "
        f"patches + prompts of 1-500 tokens served 8 decode rounds)")
        for layer in (0, cfg.num_layers - 1)]
    while eng.active_requests():
        eng.decode_round()
    ab = ab_solo_rounds(eng, cfg, "phi-3-vision serve")
    ctx = float((kv_pos >= 0).sum(dim=-1).float().mean())
    served_round_bound("phi-3-vision serve", cfg, params, eng, ab, ctx)
    graphed_decode_bits("phi-3-vision serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        (kv_pos.amax(dim=1) + 1).to(torch.int32))
    decode_vs_forward(params, cfg, 500, "phi-3-vision")
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, _ = units_by_kind(cfg, params, seq_len=1024,
                                      name="phi-3-vision")
    gc.collect()
    torch.cuda.empty_cache()
    oneshot = train_main_step("phi-3-vision-4.2b", 1024, "phi-3-vision "
                              "train")
    gc.collect()
    torch.cuda.empty_cache()
    k1_colo, k2_colo, _ = phase7_colocated(cfg, params, eng, m.round_s,
                                           seq_len=1024,
                                           tag="colo phi-3-vision")
    return dict(k1={"serve_phi3_vision": k1,
                    "colocated_serve_phi3_vision": k1_colo},
                hd96=dict(checked[0][0], shape="B 8, H 32, KV 32, hd 96, "
                          "bf16, caches of 1152 as 18 pages of 64",
                          served_caches_oracle_max_abs_err=max(
                              c[1] for c in checked)),
                k2={"train_iteration_phi3_vision": train_launches,
                    "train_oneshot_phi3_vision": oneshot,
                    "colocated_serve_phi3_vision": k2_colo})


# seamless-m4t-large-v2: the stub encoder frames of each request in phase
# 17 (launch/serve.py's are the reference's 16), and its parameter count
SEAMLESS_FRAMES = 256
SEAMLESS_PARAMS = 2_034_782_208            # ModelConfig.param_count()


def host_ms(fn, n=5):
    """Median host-clock ms of n calls, each ended by a synchronize, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase17_seamless(dev):
    """seamless-m4t-large-v2, whole (24 encoder and 24 decoder layers, d
    1024, 16 heads of hd 64, d_ff 8192, vocab 256206 untied), each request
    with 256 stub encoder frames: its parameter count; 16 requests served
    from the decode graph, K1 on every decoder layer's self-attention; the
    prefill split into its encoder and its decoder; K1 at hd 64 (g 1) on
    the served caches against its plain version and the dense oracle,
    timed beside its bound and SDPA; the A/B, the round beside its read
    bound, a graphed step bit-equal to the eager one; prefill + decode
    against the forward; the units by kind (EMBED runs the encoder), two
    one-shot steps and one --layer-units step of `launch/train.py`, and a
    co-located serve. Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.tree import tree_leaves
    # -------------------------------- 17. seamless-m4t-large-v2, whole --
    cfg = get_config("seamless-m4t-large-v2")
    Fr, d = SEAMLESS_FRAMES, cfg.d_model
    t0 = time.perf_counter()
    params = MD.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def numel(tree):
        return sum(t.numel() for t in tree_leaves(tree))
    count = numel(params)
    log(f"seamless-m4t-large-v2: {cfg.enc_layers} encoder and "
        f"{cfg.num_layers} decoder layers, d {d}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} KV of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (untied); parameters {count:,} (param_count "
        f"{cfg.param_count():,} + the two final norms): encoder "
        f"{numel(params['enc']):,}, decoder layer "
        f"{numel(params['scan']) // cfg.num_layers:,} (its cross-attention "
        f"{numel(params['scan']['xattn']) // cfg.num_layers:,}), embedding "
        f"and unembedding {params['embed'].numel():,} each; weights "
        f"{tree_bytes(params) / 1e9:.3f} GB bf16, random (seed 0), init "
        f"{init_s:.2f} s")
    if cfg.param_count() != SEAMLESS_PARAMS or \
            count != cfg.param_count() + 2 * d:
        raise AssertionError("seamless: the parameter count is not the "
                             "configuration's")
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024, enc_len=Fr,
                        use_kernels=True, device=dev)
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured(f"seamless decode step (8 slots, s_max 1024, {Fr} frames)",
             eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # warm-up, not counted
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    scan = eng.cache["scan"]
    log(f"seamless serve: {len(reqs)} requests of {Fr} encoder frames and "
        f"prompts {[r.prompt_len for r in reqs]}, 32 new tokens each; the "
        f"self cache {tree_bytes(scan['self']) / 1e9:.3f} GB, the cross K/V "
        f"{(tree_bytes(scan['xk']) + tree_bytes(scan['xv'])) / 1e9:.3f} GB")
    m, counts = serve_trace(eng, reqs, "seamless serve")
    k1, plain = counts[("K1", "LAUNCHES")], counts[("K1", "PLAIN_CALLS")]
    log(f"seamless serve: K1 launches={k1} ({cfg.num_layers} decoder layers "
        f"x {m.decode_rounds} rounds = {cfg.num_layers * m.decode_rounds}), "
        f"plain calls={plain}")
    if k1 != cfg.num_layers * m.decode_rounds or plain:
        raise AssertionError("seamless decode did not run through K1")
    gen = torch.Generator(dev).manual_seed(17)
    frames = torch.randn((1, Fr, d), device=dev, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), device=dev,
                         generator=gen)
    one = MD.init_cache(cfg, 1, 1024, Fr, device=dev)
    enc_ms = host_ms(lambda: MD._encode(params, cfg, {"enc_frames": frames}))
    pre_ms = host_ms(lambda: MD.prefill(params, cfg, {
        "tokens": toks, "enc_frames": frames}, one, use_kernels=True))
    del one
    log(f"seamless prefill of 300 tokens with {Fr} frames (host clock, "
        f"synchronized, median of 5): {pre_ms:.3f} ms = the encoder "
        f"{enc_ms:.3f} ms + the decoder stack and head "
        f"{pre_ms - enc_ms:.3f} ms; the served admissions' prefill median "
        f"{1e3 * statistics.median(m.prefill_s):.3f} ms")
    late = [Request(rid=1000 + i, arrival=0.0, prompt_len=n,
                    max_new_tokens=32)
            for i, n in enumerate((1, 64, 100, 200, 300, 400, 450, 500))]
    for r in late:
        if not eng.try_admit(r, rng.integers(0, cfg.vocab_size,
                                             size=r.prompt_len,
                                             dtype=np.int32),
                             eng._stub_extras(r)):
            raise AssertionError("seamless: the K1 check's requests were "
                                 "not admitted")
    for _ in range(8):
        eng.decode_round()
    q = torch.randn((8, cfg.num_heads, cfg.head_dim), device=dev,
                    generator=torch.Generator(dev).manual_seed(8)
                    ).to(torch.bfloat16)
    checked = [check_k1_on_ring(
        K, {n: t[layer] for n, t in scan["self"].items()}, q, 0,
        f"seamless hd 64 g 1 (decoder layer {layer}'s self caches of 16 "
        f"pages, prompts of 1-500 tokens served 8 decode rounds)")
        for layer in (0, cfg.num_layers - 1)]
    while eng.active_requests():
        eng.decode_round()
    ab = ab_solo_rounds(eng, cfg, "seamless serve")
    kv_pos = scan["self"]["kv_pos"][0]
    ctx = float((kv_pos >= 0).sum(dim=-1).float().mean())
    served_round_bound("seamless serve", cfg, params, eng, ab, ctx)
    # what a round reads, by part, with the self K/V of the positions held
    xattn = params["scan"]["xattn"]
    dec = tree_bytes(params["scan"]) - tree_bytes(xattn["wk"]) - \
        tree_bytes(xattn["wv"])
    unembed = tree_bytes(params["unembed"]) + tree_bytes(params["final_norm"])
    self_kv = cfg.num_layers * eng.max_slots * ctx * 2 * cfg.num_kv_heads * \
        cfg.head_dim * scan["self"]["k"].element_size()
    cross = tree_bytes(scan["xk"]) + tree_bytes(scan["xv"])
    read = dec + unembed + self_kv + cross
    log(f"seamless serve: a round reads the decoder's weights but the "
        f"cross K/V projections {dec / 1e9:.3f} GB, the unembedding "
        f"{unembed / 1e9:.3f} GB, the self K/V of {ctx:.0f} positions a "
        f"slot {self_kv / 1e9:.3f} GB and the cross K/V {cross / 1e9:.3f} GB"
        f" = {read / 1e9:.3f} GB: bound {read / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms; the graphed round is {1e3 * ab['graphed'][0]:.3f} ms (ratio "
        f"{1e3 * ab['graphed'][0] / (read / HBM_BYTES_PER_S * 1e3):.3f})")
    graphed_decode_bits("seamless serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        (kv_pos.amax(dim=1) + 1).to(torch.int32))
    decode_vs_forward(params, cfg, 300, "seamless")
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, unit_s = units_by_kind(cfg, params, seq_len=1024,
                                           name="seamless")
    log(f"seamless train: EMBED (the embedding and the {cfg.enc_layers}-"
        f"layer encoder over 2 x {stub_inputs(cfg, 1024)['enc_frames']} "
        f"frames) graphed ms_median {1e3 * unit_s['EMBED']:.3f}")
    gc.collect()
    torch.cuda.empty_cache()
    oneshot = train_main_step("seamless-m4t-large-v2", 1024,
                              "seamless train", steps=2)
    gc.collect()
    torch.cuda.empty_cache()
    units_step = train_main_step("seamless-m4t-large-v2", 1024,
                                 "seamless train", steps=1, units=True)
    gc.collect()
    torch.cuda.empty_cache()
    k1_colo, k2_colo, _ = phase7_colocated(cfg, params, eng, m.round_s,
                                           seq_len=1024, tag="colo seamless")
    return dict(k1={"serve_seamless": k1, "colocated_serve_seamless": k1_colo},
                hd64=dict(checked[0][0], shape="B 8, H 16, KV 16, hd 64, "
                          "bf16, caches of 1024 as 16 pages of 64",
                          served_caches_oracle_max_abs_err=max(
                              c[1] for c in checked)),
                k2={"train_iteration_seamless": train_launches,
                    "train_oneshot_seamless": oneshot,
                    "train_units_seamless": units_step,
                    "colocated_serve_seamless": k2_colo})


def colocated_costmodel(tag, cfg, params, eng, qos_s, seq_len):
    """Co-located serving with the predictor fit from the cost model
    (`fit_from_costmodel` on the H100 spec with the committed constants,
    so no round is profiled) under `qos_s`: the runner's graphs captured,
    then 16 requests through graphed rounds and the QoS scheduler, every
    counter set to 0 just before. Returns (metrics, counts, the kinds of
    the units run)."""
    from repro_torch.core import colocation as C
    from repro_torch.core.costmodel import CostModel, InstanceSpec
    from repro_torch.core.predictor import TwoStageLatencyPredictor
    from repro_torch.core.scheduler import QoSScheduler, SchedulerConfig
    from repro_torch.serving.engine import EngineMetrics
    from repro_torch.serving.request import Request
    from repro_torch.training import peft as P
    from repro_torch.training.data import (DataConfig, Prefetcher,
                                           SyntheticCorpus)
    pc = P.PeftConfig(micro_batch=FT_MICRO_BATCH, seq_len=seq_len, accum=1)
    staged = Prefetcher(SyntheticCorpus(DataConfig(
        cfg.vocab_size, seq_len, FT_MICRO_BATCH, seed=1,
        **stub_inputs(cfg, seq_len))).batches(), pc.n_stage).stacked()
    ft = P.init_ft_state(cfg, pc, params, 1, staged)
    runner = C.ColocatedRunner(cfg, params, cfg, params, pc, k_max=6,
                               use_kernels=True)
    torch.cuda.reset_peak_memory_stats()
    captured(f"{tag} co-located rounds", lambda: runner.precompile(
        eng.cache, ft))
    pred = TwoStageLatencyPredictor(k_max=6)
    pred.fit_from_costmodel(CostModel(cfg, InstanceSpec()),
                            micro_batch=FT_MICRO_BATCH, ft_seq=seq_len)
    sched = QoSScheduler(pred, SchedulerConfig(qos_s=qos_s, k_max=6))
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(7)
    reqs = [Request(rid=900 + i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    u0, upi = ft["unit_idx"], P.units_per_iteration(cfg, pc.accum)
    reset_kernel_counts()
    t0 = time.perf_counter()
    m, ft = C.run_colocated_trace(eng, runner, sched, ft, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    ks = [dd.k for dd in sched.decisions]
    log(f"{tag}: the cost-model fit at qos_s={qos_s:.4f} (1.5 x the "
        f"graphed solo round at 8 slots): {len(reqs)} requests, rounds="
        f"{m.decode_rounds} round_ms_median="
        f"{1e3 * statistics.median(m.round_s):.3f} round_ms_p90="
        f"{1e3 * float(np.percentile(m.round_s, 90)):.3f} mean_k="
        f"{statistics.mean(ks):.3f} violations={sched.violations} units="
        f"{m.ft_units} finetune_tokens_per_s="
        f"{m.ft_units / upi * FT_MICRO_BATCH * seq_len / wall:.1f} (units / "
        f"{upi} per iteration x {FT_MICRO_BATCH} x {seq_len} tokens / wall "
        f"{wall:.3f} s)")
    peaks(tag)
    if not all(rq.phase.value == "done" and rq.generated == 32
               for rq in reqs):
        raise AssertionError(f"{tag}: not every request finished")
    return m, counts, [runner.unit_step.kind((u0 + j) % upi)
                       for j in range(m.ft_units)]


def phase18_llama3_int8(dev, served):
    """llama3-8b at full width with an int8 KV cache (`kv_quant`), the
    weights of phase 3 (seed 0) made anew: its cache bytes beside phase
    3's bf16 cache; phase 3's 16 requests served from the decode graph,
    every attention layer's decode through the counted oracle and none
    through K1 (the reference's route); the greedy tokens against phase
    3's; the A/B and a graphed step bit-equal to the eager one; the first
    decode step's logits from an int8 and a bf16 cache on the same
    prompts, within 5 % of the largest |logit|; co-located rounds with the
    predictor fit from the cost model. Returns the kernels-line numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import EngineMetrics, ServingEngine
    from repro_torch.serving.request import Request
    # ------------------------------ 18. llama3-8b, int8 KV cache --
    cfg = dataclasses.replace(get_config("llama3-8b"), kv_quant=True)
    params = MD.init_params(cfg, 0, device=dev)
    eng = ServingEngine(cfg, params, max_slots=8, s_max=1024,
                        use_kernels=True, device=dev)
    scan = eng.cache["scan"]
    kv = tree_bytes({n: scan[n] for n in ("k", "v")})
    scales = tree_bytes({n: scan[n] for n in ("k_scale", "v_scale")})
    log(f"int8 serve: the cache {tree_bytes(eng.cache) / 1e9:.3f} GB (int8 "
        f"K/V {kv / 1e9:.3f} GB + scales {scales / 1e9:.3f} GB: "
        f"{scales / (cfg.num_layers * 8 * 1024):.0f} B per token and layer, "
        f"+ positions) against phase 3's bf16 cache "
        f"{served['cache_bytes'] / 1e9:.3f} GB (ratio "
        f"{tree_bytes(eng.cache) / served['cache_bytes']:.3f}); the page "
        f"accounting counts {eng.pages.spec.page_bytes} B a page, a bf16 "
        f"page's (the reference's kv_bytes_per_token_layer)")
    if not eng.graphs:
        raise AssertionError("the engine does not replay a CUDA graph")
    captured("int8 decode step (8 slots)", eng.precompile)
    eng.run_trace([Request(rid=-1, arrival=0.0, prompt_len=64,
                           max_new_tokens=2)])       # phase 3's warm-up
    eng.metrics = EngineMetrics()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=i * 0.01,
                    prompt_len=int(rng.integers(64, 513)), max_new_tokens=32)
            for i in range(16)]
    tokens = {}
    m, counts = serve_trace(eng, reqs, "int8 serve", tokens=tokens)
    oracle = counts[("oracle", "INT8_ORACLE_CALLS")]
    k1 = counts[("K1", "LAUNCHES")] + counts[("K1", "PLAIN_CALLS")]
    log(f"int8 serve: oracle decodes={oracle} ({cfg.num_layers} x "
        f"{m.decode_rounds} rounds = {cfg.num_layers * m.decode_rounds}), K1 "
        f"launches and plain calls={k1}")
    if oracle != cfg.num_layers * m.decode_rounds or k1:
        raise AssertionError("int8 decode did not take the oracle alone")
    same = sum(a == b for rid, ts in tokens.items()
               for a, b in zip(ts, served["tokens"][rid]))
    total = sum(len(ts) for ts in tokens.values())
    whole = sum(ts == served["tokens"][rid] for rid, ts in tokens.items())
    first = [next((i for i, (a, b) in enumerate(zip(ts, served["tokens"][
        rid])) if a != b), len(ts)) for rid, ts in sorted(tokens.items())]
    log(f"int8 serve: greedy tokens equal to phase 3's (bf16 cache, K1): "
        f"{same} of {total}; requests equal throughout {whole} of "
        f"{len(tokens)}; decoded tokens before the first difference by "
        f"request {first}")
    ab = ab_solo_rounds(eng, cfg, "int8 serve")
    kv_pos = scan["kv_pos"][0]
    graphed_decode_bits("int8 serve", params, cfg, eng.cache,
                        torch.tensor(eng.last_token, device=dev),
                        (kv_pos.amax(dim=1) + 1).to(torch.int32))
    toks = torch.randint(0, cfg.vocab_size, (8, 301), device=dev,
                         generator=torch.Generator(dev).manual_seed(18))
    out = {}
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_quant=quant)
        cache = MD.init_cache(c, 8, 512, device=dev)
        with torch.no_grad():
            MD.prefill(params, c, {"tokens": toks[:, :300]}, cache,
                       use_kernels=True)
            out[quant], _ = MD.decode_step(
                params, c, toks[:, 300].to(torch.int32),
                torch.full((8,), 300, dtype=torch.int32, device=dev), cache,
                use_kernels=True)
        del cache
    torch.cuda.synchronize()
    rel = ((out[True].float() - out[False].float()).abs().max()
           / out[False].float().abs().max()).item()
    agree = (out[True].argmax(-1) == out[False].argmax(-1)).float().mean()
    log(f"int8 decode step vs the bf16 cache's (K1) on 8 prompts of 300 "
        f"tokens, the same weights: max |dlogit| / max |logit| {rel:.4f} "
        f"(the reference's bound 0.05), greedy agreement {agree.item():.3f}")
    if rel >= 0.05 or not torch.isfinite(out[True]).all():
        raise AssertionError("the int8 cache's logits are not within 5 % of "
                             "the bf16 cache's")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    m, counts, kinds = colocated_costmodel(
        "colo int8", cfg, params, eng, 1.5 * ab["graphed"][0], seq_len=1024)
    per = k2_per_unit(cfg)
    k2_expect = sum(per.get(kind, 0) for kind in kinds)
    k2, k2w = counts[("K2", "LAUNCHES")], counts[("K2", "LAUNCHES_WGMMA")]
    oracle = counts[("oracle", "INT8_ORACLE_CALLS")]
    plain = sum(n for (_, c), n in counts.items() if c == "PLAIN_CALLS")
    log(f"colo int8: oracle decodes={oracle} ({cfg.num_layers} x "
        f"{m.decode_rounds} rounds), K1 launches="
        f"{counts[('K1', 'LAUNCHES')]}, K2 launches={k2} (expected from the "
        f"units run: {k2_expect}; wgmma {k2w}), plain calls={plain}")
    if oracle != cfg.num_layers * m.decode_rounds or \
            counts[("K1", "LAUNCHES")] or k2 != k2_expect or k2w != k2 or \
            plain:
        raise AssertionError("colo int8: the co-located rounds did not run "
                             "the oracle and K2 alone")
    return dict(k1={"serve_llama3_int8": 0}, k2={
        "colocated_serve_llama3_int8": k2})


# ------------------------------------------- 19. the flash attention ----
# bf16 tolerance of the gradients, relative to each tensor's largest
# |value| (tests/test_kernels.py holds bf16 at 2e-2 to 3e-2)
FLASH_TOL = 3e-2
FLASH_SHAPES = {
    "llama3-8b": dict(B=2, S=1024, H=32, KV=8, hd=128, vd=128),
    "deepseek-v3 dense MLA": dict(B=2, S=1024, H=128, KV=128, hd=192,
                                  vd=128),
}


def flash_run(fn, q, k, v, do, scale):
    """Forward and backward of one flash attention: (o, dq, dk, dv)."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(qq, kk, vv, causal=True, scale=scale)
    o.backward(do)
    return o.detach(), qq.grad, kk.grad, vv.grad


def flash_peak_bytes(fn, args):
    """The most memory one forward + backward allocates above what is
    allocated before it (its inputs)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flash_run(fn, *args)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase19_flash(dev):
    """The recompute-backward flash attention (`layers.flash_attention`,
    an autograd Function) against `flash_attention_plain` (the same
    forward under plain autograd) at llama3-8b's training shape and at
    deepseek-v3's dense MLA shape (qk 192, v 128), bf16, causal: o and
    (dq, dk, dv) held at FLASH_TOL, forward + backward timed by CUDA
    events (median of 30, L2 overwritten), the memory each allocates above
    its inputs, and the forward alone under no_grad (the serving path).
    Plain torch both: no TPU kernel covers this function."""
    from repro_torch.models import layers as L
    out = {}
    for label, s in FLASH_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(19)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        B, S, H, KV, hd, vd = (s[k] for k in ("B", "S", "H", "KV", "hd",
                                              "vd"))
        args = (rnd(B, S, H, hd), rnd(B, S, KV, hd), rnd(B, S, KV, vd),
                rnd(B, S, H, vd), hd ** -0.5)
        got = flash_run(L.flash_attention, *args)
        ref = flash_run(L.flash_attention_plain, *args)
        errs = {name: float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref)}
        same_o = torch.equal(got[0], ref[0])
        del got, ref
        mem = {name: flash_peak_bytes(fn, args)
               for name, fn in (("function", L.flash_attention),
                                ("plain", L.flash_attention_plain))}
        ms = {name: time_ms(lambda fn=fn: flash_run(fn, *args))
              for name, fn in (("function", L.flash_attention),
                               ("plain", L.flash_attention_plain))}
        q, k, v, _, scale = args
        with torch.no_grad():
            fwd_ms = time_ms(lambda: L.flash_attention(q, k, v, causal=True,
                                                       scale=scale))
        log(f"flash {label}: B {B} S {S} H {H} KV {KV} qk {hd} v {vd} bf16 "
            f"causal; the Function against flash_attention_plain: max "
            f"|diff| / max |plain| " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tolerance {FLASH_TOL}; o bit-equal {same_o}); forward + "
            f"backward ms_median Function {ms['function']:.3f}, plain "
            f"{ms['plain']:.3f} (ratio {ms['function'] / ms['plain']:.3f}); "
            f"allocated above the inputs: Function "
            f"{mem['function'] / 1e9:.3f} GB, plain {mem['plain'] / 1e9:.3f} "
            f"GB; forward alone under no_grad {fwd_ms:.3f} ms")
        if any(e > FLASH_TOL for e in errs.values()):
            raise AssertionError(f"flash {label}: the Function's output or "
                                 "gradients disagree with plain autograd's")
        out[label] = dict(errs=errs, ms=ms, mem=mem, fwd_ms=fwd_ms)
        del args
    return out


# ------------------------------------------ 20. the mesh layout layer ----
def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase20_mesh(dev):
    """The layout layer on the one card: a 1x1 ("data", "model") mesh on
    cuda (NCCL, world size 1); phase 13's checkpoint (adapters and AdamW
    state) restored onto it with `adapter_specs` against the single-card
    restore, leaf by leaf and bit for bit; llama3-8b's weights laid out
    by `param_specs` (`reshard`: the checkpoint holds no weights); one
    one-shot train step (remat, kernels off, micro-batch 2 x 1024) under
    `use_mesh` against the same step on plain tensors: loss, adapters and
    the AdamW moments (which carry the gradient) bit-equal, as one rank's
    collectives are the identity (the reference's sharded-step bound,
    adapters atol 5e-3 and rtol 5e-2, is printed beside them), only the
    loss's `gather` run replicated, and no kernel launched. Nothing here measures a layout over more than
    one card."""
    import shutil

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import partitioning as PT
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.fault_tolerance import (CheckpointManager,
                                                         reshard)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as MD
    from repro_torch.training import peft as P
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.tree import tree_leaves
    dev = torch.device(dev)
    cuda = dev.type == "cuda"          # a CPU rehearsal runs on gloo
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", dev.index or 0)
                            if cuda else None)
    try:
        mesh = make_debug_mesh(1, 1, device_type=dev.type)
        cfg = get_config("llama3-8b")
        adapters = MD.init_adapters(cfg, 1, device=dev)
        template = {"adapters": adapters, "opt": adamw_init(adapters)}
        ad_specs = PT.adapter_specs(cfg, adapters, mesh)
        specs = {"adapters": ad_specs,
                 "opt": {"m": ad_specs, "v": ad_specs, "t": SH.Spec()}}
        mgr = CheckpointManager(PHASE13_CKPT)
        t0 = time.perf_counter()
        single = mgr.restore(template)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_mesh = mgr.restore(template, mesh=mesh, specs=specs)
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(single), tree_leaves(on_mesh)))
        equal = all(a == b if isinstance(a, int) else
                    torch.equal(a, b.full_tensor()) for a, b in pairs)
        n_dt = sum(1 for _, b in pairs if hasattr(b, "placements"))
        log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
            f"{mesh.device_type} ({dist.get_backend()}, world size 1); "
            f"phase 13's step-"
            f"{mgr.latest_step()} checkpoint restored onto it with "
            f"adapter_specs in {t_mesh:.3f} s ({n_dt} leaves as DTensors) "
            f"and on the card alone in {t_single:.3f} s: bit-equal leaf by "
            f"leaf {equal}")
        if not equal or n_dt == 0:
            raise AssertionError("the restore onto the mesh differs from the "
                                 "single-card restore")

        params = MD.init_params(cfg, 0, device=dev)
        p_sh = reshard(params, mesh, PT.param_specs(cfg, params, mesh))
        rng = np.random.default_rng(20)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                 size=(2, 1024)),
                                    dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        b_sh = PT.to_named(batch, PT.batch_specs(batch, mesh), mesh)
        step = P.make_train_step(cfg, AdamWConfig(lr=1e-3), remat=True)
        times = {}
        for mode in ("plain", "mesh", "mesh", "plain"):
            reset_kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "plain":
                res_p = step(params, single["adapters"], single["opt"],
                             batch)
            else:
                SH.FALLBACKS.clear()
                with SH.use_mesh(mesh):
                    res_m = step(p_sh, on_mesh["adapters"], on_mesh["opt"],
                                 b_sh)
            torch.cuda.synchronize()
            times.setdefault(mode, []).append(time.perf_counter() - t0)
            if any(kernel_counts().values()):
                raise AssertionError(f"the {mode} step launched a kernel")
        loss_p = float(res_p[2]["loss"])
        loss_m = float(res_m[2]["loss"].full_tensor())
        excess = 0.0
        bits = {"loss": loss_m == loss_p}
        for a, b in zip(tree_leaves(res_p[0]), tree_leaves(res_m[0])):
            b = b.full_tensor()
            bits["adapters"] = bits.get("adapters", True) and \
                torch.equal(a, b)
            excess = max(excess, float(((a - b).abs()
                                        - 5e-2 * b.abs()).max()))
        # the AdamW moments carry the gradient (m = 0.1 g, v = 1e-3 g^2 of
        # the clipped g after one step): each leaf's worst |diff| over its
        # largest |value|
        moment_rel = {}
        for key in ("m", "v"):
            rel, same = 0.0, True
            for a, b in zip(tree_leaves(res_p[1][key]),
                            tree_leaves(res_m[1][key])):
                b = b.full_tensor()
                same &= torch.equal(a, b)
                top = float(a.abs().max())
                diff = float((a - b).abs().max())
                rel = max(rel, diff / top if top > 0 else diff)
            bits[key], moment_rel[key] = same, rel
        log(f"mesh: one {cfg.name} train step (micro-batch 2 x 1024, remat, "
            f"kernels off) under use_mesh on the laid-out weights, adapters"
            f" and batch against the step on plain tensors: loss "
            f"{loss_m:.6f} vs {loss_p:.6f}; bit-equal {bits} (adapters' max "
            f"|diff| - 5e-2 |plain| = {excess:.3e}, bound 5e-3; the "
            f"moments' worst |diff| / max |plain| m {moment_rel['m']:.3e}, "
            f"v {moment_rel['v']:.3e}); ops run replicated by the fallback "
            f"{dict(SH.FALLBACKS)}; step s plain "
            f"{[round(t, 3) for t in times['plain']]}, on the mesh "
            f"{[round(t, 3) for t in times['mesh']]}; no kernel launched. "
            f"Nothing here measures a layout over more than one card: the "
            f"machine has one.")
        # on one rank every collective is the identity, so the step on the
        # mesh computes what the plain step does, bit for bit
        if not all(bits.values()) or excess > 5e-3:
            raise AssertionError("the step on the mesh differs from the "
                                 "plain step")
        if set(SH.FALLBACKS) != {"gather"}:
            raise AssertionError(f"the ops run replicated are "
                                 f"{dict(SH.FALLBACKS)}, not the loss's "
                                 f"gather alone")
        return {"restore_bit_equal": equal, "loss": (loss_p, loss_m),
                "times": times}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PHASE13_CKPT.parent, ignore_errors=True)


# ------------------------------------------- 21. the dry-run tooling ----
DRYRUN_DIR = ROOT / "build" / "dryrun_results_torch"
# the meta count of a step's resident bytes against the card's peak: the
# counters see every storage the step's ops return, not the caching
# allocator's rounding nor the workspaces kernels take inside one op (an
# H100 reads -0.003 % for the decode cell and -0.01 % for the train cell;
# a count that dropped either step's temp bytes, 1.1 and 1.9 GB, is
# 3-10 % off)
DRYRUN_MEM_TOL = 0.01
# qwen3-8b's cells cut in global batch to one card
ACCOUNTING_CELLS = (("decode_32k", 4), ("train_4k", 1))


def real_cell_args(cfg, cell, dev):
    """The stand-ins of `specs.make_cell_fn`, for real on the card: random
    seeded weights and adapters, an empty cache, random tokens."""
    from repro_torch.models import model as MD
    from repro_torch.training.optimizer import adamw_init
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    B, S, V = cell.global_batch, cell.seq_len, cfg.vocab_size

    def ints(*shape):
        return torch.randint(0, V, shape, generator=g, device=dev,
                             dtype=torch.int32)
    params = MD.init_params(cfg, 0, device=dev)
    if cell.kind == "decode":
        return (params, ints(B), torch.full((B,), S - 1, dtype=torch.int32,
                                            device=dev),
                MD.init_cache(cfg, B, S, device=dev))
    adapters = MD.init_adapters(cfg, 0, device=dev)
    return (params, adapters, adamw_init(adapters),
            {"tokens": ints(B, S), "labels": ints(B, S),
             "mask": torch.ones((B, S), dtype=torch.float32, device=dev)})


def signature(tree):
    """[(shape, dtype)] of a tree's tensors (holding none of them)."""
    from repro_torch.tree import tree_leaves
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def phase21_dryrun(dev):
    """The dry-run on the `fake` group (a "cuda"-typed mesh), then its
    per-device counts against the card (see the module's docstring)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import colocated_dryrun as CD
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch import step_analysis as SA
    DR.start_fake_group()
    try:
        recs = [DR.run_cell("qwen3-8b", "decode_32k", "single", force=True,
                            results_dir=DRYRUN_DIR, device_type="cuda"),
                CD.run("llama3-8b", "qwen2.5-7b", 4, "single",
                       results_dir=DRYRUN_DIR, device_type="cuda")]
    finally:
        dist.destroy_process_group()
    for rec in recs:
        log(f"dryrun: {DR.summary(rec)}; step {rec.get('step_s')} s on the "
            f"{rec['device_type']}-typed {rec.get('chips')}-rank mesh")
        if not rec.get("ok"):
            raise AssertionError(f"dry-run cell failed: {rec['error']}\n"
                                 f"{rec['traceback']}")
    cfg = get_config("qwen3-8b")
    for shape, batch in ACCOUNTING_CELLS:
        cell = dataclasses.replace(SHAPES[shape], global_batch=batch)
        step, margs = SP.make_cell_fn(cfg, cell)
        t0 = time.perf_counter()
        _, meta = SA.run_step(step, margs)
        t_meta = time.perf_counter() - t0
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = real_cell_args(cfg, cell, dev)
        if signature(margs) != signature(args):
            raise AssertionError("the card's inputs are not the stand-ins'")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, card = SA.run_step(step, args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res
        ms = time_ms(lambda: step(*args), iters=5)
        moved = meta.argument_bytes + meta.output_bytes - meta.alias_bytes
        bound_ms = max(meta.dot_flops / PEAK_FLOPS[torch.bfloat16],
                       moved / HBM_BYTES_PER_S) * 1e3
        rel = meta.resident_bytes / peak - 1.0
        log(f"dryrun accounting: qwen3-8b {shape} at batch {batch}, no "
            f"mesh, no kernel: dot FLOPs on meta {meta.dot_flops:.6g}, on "
            f"the card {card.dot_flops:.6g} (equal "
            f"{meta.dot_flops == card.dot_flops}); resident bytes on meta "
            f"{meta.resident_bytes / 1e9:.4f} GB (arguments "
            f"{meta.argument_bytes / 1e9:.4f}, outputs "
            f"{meta.output_bytes / 1e9:.4f}, temp "
            f"{meta.temp_bytes / 1e9:.4f}, alias "
            f"{meta.alias_bytes / 1e9:.4f}), the counters on the card's "
            f"tensors {card.resident_bytes / 1e9:.4f} GB, "
            f"max_memory_allocated above the memory before the inputs "
            f"{peak / 1e9:.4f} GB: meta/card - 1 = {rel:+.4f} (limit "
            f"{DRYRUN_MEM_TOL}); step {ms:.3f} ms (CUDA events, median of "
            f"5) beside its roofline bound {bound_ms:.3f} ms = max(FLOPs / "
            f"989e12, {moved / 1e9:.4f} GB moved / 3.35e12) "
            f"({ms / bound_ms:.2f}x); the meta count took {t_meta:.2f} s")
        if meta.dot_flops != card.dot_flops:
            raise AssertionError("the FLOPs counted on the card differ from "
                                 "the meta count")
        if abs(rel) > DRYRUN_MEM_TOL:
            raise AssertionError("the meta count of the resident bytes is "
                                 f"{rel:+.1%} off the card's peak")
        del args


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_run = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------- 1. environment --
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")
    from repro_torch.hw import H100_SXM
    props = torch.cuda.get_device_properties(0)
    log(f"card properties: total_memory {props.total_memory / 1e9:.3f} GB, "
        f"{props.multi_processor_count} SMs, shared memory per block "
        f"(opt-in) {getattr(props, 'shared_memory_per_block_optin', None)} "
        f"bytes; the cost model's hw.H100_SXM (data sheet): hbm_bytes "
        f"{H100_SXM.hbm_bytes / 1e9:.1f} GB, vmem_bytes "
        f"{H100_SXM.vmem_bytes:.0f}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{sorted(str(p.relative_to(ROOT)) for p in libs.values())}")
    for name, lib in libs.items():
        report = (lib.parent / f"{name}.log").read_text().strip()
        log(f"nvcc {name}:\n{report}")

    t_phase = time.perf_counter()
    llama = phases_llama3(dev)
    log(f"phases 2-7 took {time.perf_counter() - t_phase:.1f} s")
    # the mamba2 phases report their own peak memory
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mamba = get_config("mamba2-780m")
    k3_main = phase8_k3(dev, mamba)
    k3, mamba_params, mamba_eng, mamba_round_s = phase9_mamba2(dev, mamba)
    log(f"phases 8-9 took {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    k3_colo, mamba_colo = phase10_mamba2_colocated(
        mamba, mamba_params, mamba_eng, mamba_round_s, seq_len=1024)
    mamba_points = cost_points(mamba, mamba_colo)
    del mamba_colo
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    del mamba_params, mamba_eng
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    danube = phase11_danube(dev)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mixtral = phase12_mixtral(dev)
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    costmodel_fit([llama.pop("points"), mamba_points,
                   mixtral.pop("points")])
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    train = phase13_train()
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    deepseek = phase14_deepseek(dev)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    hybrid = phase15_recurrentgemma(dev)
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    vision = phase16_phi3_vision(dev)
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    seamless = phase17_seamless(dev)
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    int8 = phase18_llama3_int8(dev, llama.pop("served"))
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    phase19_flash(dev)
    log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase20_mesh(dev)
    log(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    phase21_dryrun(dev)
    log(f"phase 21 took {time.perf_counter() - t_phase:.1f} s; whole run "
        f"{time.perf_counter() - t_run:.1f} s")
    llama["k1"]["launches_by_path"].update(serve_danube=danube["launches"],
                                           **mixtral["k1"],
                                           **deepseek["k1"], **hybrid["k1"],
                                           **vision["k1"], **seamless["k1"],
                                           **int8["k1"])
    llama["k1"]["hd80"] = {k: v for k, v in danube.items()
                           if k != "launches"}
    llama["k1"]["hd256"] = hybrid["hd256"]
    llama["k1"]["hd96"] = vision["hd96"]
    llama["k1"]["hd64"] = seamless["hd64"]
    llama["k2"]["launches_by_path"].update(mixtral["k2"], **train,
                                           **deepseek["k2"], **hybrid["k2"],
                                           **vision["k2"], **seamless["k2"],
                                           **int8["k2"])

    log(f"card: {card_line()}")
    log(json.dumps({"kernels": [
        dict(name="decode_attention", route="cuda", source=K1_SOURCE,
             replaces=K1_REPLACES, **llama["k1"]),
        dict(name="lora_matmul", route="cuda", source=K2_SOURCE,
             replaces=K2_REPLACES, **llama["k2"]),
        dict(name="ssd_scan", route="cuda", source=K3_SOURCE,
             replaces=K3_REPLACES, launches=k3, **k3_main,
             launches_by_path={"serve_mamba2": k3,
                               "colocated_serve_mamba2": k3_colo})]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
