"""PEFT (LoRA) finetune engine with layer-wise scheduling units (paper §6.1).

Port of `repro/training/peft.py`. An iteration is a sequence of units, each
of which `unit_step` runs one at a time, so a co-located round can run `k`
of them after its decode step (`core/colocation.py`):

  per microbatch: EMBED(+pre fwd) | L x FWD(layer i) | HEAD(loss, dx)
                  | L x BWD(layer j, descending)
                  | EMBED_BWD(pre bwd + data advance)
  then:           OPT (AdamW on the accumulated adapter grads)

EMBED runs the embedding and the model's "pre" layers (deepseek-v3's
leading dense layers) with their adapters; EMBED_BWD recomputes them with
the adapters as leaves and adds their gradients, as the reference's
`front` does (`repro/training/peft.py:122-138`, `:240-255`). A model
without "pre" layers does no tensor work in EMBED_BWD. A FWD or BWD unit
runs one element of the scanned stack: a layer, or the hybrid family's
whole superblock (two RG-LRU layers and a local-attention layer). HEAD
runs the "post" layers (the hybrid's trailing RG-LRU layers) with their
adapters, then the loss, and adds their adapter grads to
`grads["post"]`; OPT steps them with the rest.

A vision-stub model trains on F patch embeddings ahead of its S tokens
(the staged ring's "frontend", which EMBED stages beside the tokens): `x`
and the residuals hold F + S rows, the layers see positions 0..F+S-1,
and HEAD drops the first F rows before the loss, so the units' loss is
`loss_fn`'s CE. The reference sizes `x` and the residuals S, so its EMBED
cannot store the front, and its HEAD would pair F + S - 1 rows with S - 1
labels (ROADMAP.md §3).

An encoder-decoder model trains on its microbatch's stub frames (the
staged ring's "enc_frames", (n_stage, B, Se, d)): EMBED also runs the
encoder on them and stores its output in the state's `enc_out` (B, Se,
d) bf16, which every FWD and BWD unit's "dec" layer attends to, as in
the reference (`repro/training/peft.py:101-103`, `:128-159`, `:223-227`).
The encoder takes no adapter, so BWD's gradient reaches the layer input
and its adapters, never `enc_out`.

FWD units run without autograd and save each layer's input as a bf16
residual. BWD units recompute their layer from that residual and call
`torch.autograd.grad` with respect to (the layer input, that layer's
adapters): the port's counterpart of the reference's `jax.vjp`, and the
same layer-granular activation checkpointing that bounds the co-located
memory footprint (§4.3).

The state is a dict like the reference's `ft_state`, with two differences.
Its counters (`unit_idx`, `data_idx`, `iter`, `consumed`, and the
optimizer's `t`) are Python ints on the host, so choosing the next unit
reads no device scalar (`interop` turns them into the reference's int32
scalars and back); on the card they choose which CUDA graph to replay, as
`lax.switch` on `unit_idx` chooses a branch in the reference. And every
tensor of the state keeps its address for as long as the state lives:
each unit writes `x`, the residuals, the loss, the accumulated grads, the
adapters and the optimizer's moments in place (`copy_`, `add_`) and
returns the same dict. A unit then copies no (L+1, B, S, d) stack, and a
graph captured on the state reads and writes the same memory at every
replay.

`use_kernels` routes every adapted projection of the units through the
LoRA matmul kernel: 7 launches per FWD unit and 14 per BWD unit (the
recomputed forward and the dx of each projection) on a dense layer with
all seven targets adapted; EMBED and EMBED_BWD launch it for the "pre"
layers' projections: EMBED once each, EMBED_BWD twice (forward, dx)
less the dx where a projection's input depends on no adapter (the first
layer's q/k/v, q for MLA); HEAD
twice (forward, dx) for each adapted projection of the "post" layers.
An RG-LRU layer's gate/up/down go through it, its parallel `rg_io`
adapter does not (a plain product, as `ssm_io`).

The units train on the CE alone: an MoE layer's aux loss and the MTP term
that `loss_fn` adds are dropped, as the reference's units drop them (its
HEAD is CE only, `repro/training/peft.py:174-188`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import lora as LR
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_hparams,
                                            adamw_init, adamw_update,
                                            adamw_update_)
from repro_torch.tree import tree_leaves, tree_map

RESIDUAL_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class PeftConfig:
    micro_batch: int = 2          # paper §8.2: micro-batched to bs=2
    seq_len: int = 1024
    accum: int = 8                # minibatch 16 = 8 x 2 (paper baseline bs)
    n_stage: int = 2              # host-staged microbatch ring depth
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


# ===================================================== full train step ====
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    use_kernels: bool = False, remat: bool = True):
    """One-shot PEFT train step (grads with respect to the adapters only)."""

    def train_step(params, adapters, opt_state, batch):
        ad = tree_map(lambda t: t.detach().requires_grad_(), adapters)
        with torch.enable_grad():
            loss, metrics = MD.loss_fn(params, cfg, batch, adapters=ad,
                                       use_kernels=use_kernels, remat=remat)
            loss.backward()
        grads = tree_map(lambda t: t.grad, ad)
        new_adapters, new_opt = adamw_update(opt_cfg, grads, opt_state,
                                             tree_map(torch.Tensor.detach,
                                                      ad))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new_adapters, new_opt, metrics

    return train_step


# ===================================================== layer-unit engine ==
def n_units_per_mb(cfg: ModelConfig) -> int:
    _, _, n_scan, _ = MD._plan(cfg)
    return 2 * n_scan + 3


def units_per_iteration(cfg: ModelConfig, accum: int) -> int:
    return accum * n_units_per_mb(cfg) + 1


def front_tokens(cfg: ModelConfig) -> int:
    """Rows ahead of the tokens in the units' activations: a vision stub's
    patches (0 without a frontend)."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def init_ft_state(cfg: ModelConfig, pc: PeftConfig, params, seed: int,
                  staged: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """staged: {"tokens": (n_stage, B, S), "labels": ..., "mask": ...,
    ["frontend": (n_stage, B, F, d)], ["enc_frames": (n_stage, B, Se,
    d)]} from `data.Prefetcher.stacked()`, copied to the params' device.
    `x` and the residuals hold F + S rows (the reference sizes them S, and
    its EMBED fails on a frontend); an encoder-decoder model's state adds
    `enc_out` (B, Se, d) bf16."""
    _, _, n_scan, _ = MD._plan(cfg)
    dev = params["embed"].device
    B, d = pc.micro_batch, cfg.d_model
    F = front_tokens(cfg)
    if F and np.shape(staged.get("frontend"))[2:3] != (F,):
        raise ValueError(f"{cfg.name} trains on {F} stub patches per "
                         "sample: stage a 'frontend' of them "
                         "(DataConfig.frontend_tokens)")
    if cfg.enc_layers and "enc_frames" not in staged:
        raise ValueError(f"{cfg.name} trains on stub encoder frames: stage "
                         "'enc_frames' (DataConfig.enc_frames)")
    S = F + pc.seq_len
    adapters = MD.init_adapters(cfg, seed, device=dev)
    state = {
        "adapters": adapters,
        "opt": adamw_init(adapters),
        "grads": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          adapters),
        "x": torch.zeros((B, S, d), dtype=RESIDUAL_DTYPE, device=dev),
        "residuals": torch.zeros((n_scan + 1, B, S, d), dtype=RESIDUAL_DTYPE,
                                 device=dev),
        "data": {k: torch.as_tensor(v, device=dev) for k, v in staged.items()},
        "data_idx": 0,
        "unit_idx": 0,
        "loss": torch.zeros((), dtype=torch.float32, device=dev),
        "last_loss": torch.zeros((), dtype=torch.float32, device=dev),
        "iter": 0,
        "consumed": 0,
    }
    if cfg.enc_layers:
        se = np.shape(staged["enc_frames"])[2]
        state["enc_out"] = torch.zeros((B, se, d), dtype=RESIDUAL_DTYPE,
                                       device=dev)
    return state


# the staged inputs EMBED (and EMBED_BWD) copies; HEAD copies the others
FRONT_INPUTS = ("tokens", "frontend", "enc_frames")
UNIT_KINDS = ("EMBED", "FWD", "HEAD", "BWD", "EMBED_BWD", "OPT")


class UnitEngine:
    """`unit_step(state) -> state`: runs exactly one unit per call.

    A call has three parts, which the CUDA graph runner
    (`core/colocation.py`) takes apart:
      prepare(state)   host side, outside any graph: a microbatch's EMBED
                       (and, with "pre" layers, its EMBED_BWD) copies its
                       tokens (patches, frames) from the staged ring (at
                       the host's
                       `data_idx`) into a fixed batch buffer, its HEAD the
                       labels and mask; OPT writes its step's lr and bias
                       corrections into a small f32 tensor (`hp`).
      run(state, i)    unit i's tensor work: launches only, every result
                       written in place into the state's tensors, so that
                       it can be captured once per unit index and replayed.
      advance(state)   the host counters.
    The buffers belong to the engine, not the state, so the state keeps
    the reference's tree (`interop`)."""

    def __init__(self, cfg: ModelConfig, pc: PeftConfig, params, *,
                 use_kernels: bool = False):
        self.pre_kinds, self.scan_kind, self.n_scan, self.post_kinds = \
            MD._plan(cfg)
        self.cfg, self.pc, self.params = cfg, pc, params
        self.use_kernels = use_kernels
        self.scale = LR.lora_scale(cfg)
        self.upm = n_units_per_mb(cfg)
        self.total_units = units_per_iteration(cfg, pc.accum)
        dev = params["embed"].device
        self.front = front_tokens(cfg)
        S = self.front + pc.seq_len
        self.positions = torch.arange(S, dtype=torch.int32,
                                      device=dev).expand(pc.micro_batch, S)
        self.batch: Dict[str, torch.Tensor] = {}
        self.hp = torch.zeros((4,), dtype=torch.float32, device=dev)

    # ------------------------------------------------------------ plan --
    def key(self, unit_idx: int):
        """The unit's place in a microbatch ("opt" for OPT): units with one
        key run the same tensor work on the same buffers."""
        return "opt" if unit_idx >= self.pc.accum * self.upm \
            else unit_idx % self.upm

    def kind(self, unit_idx: int) -> str:
        u = self.key(unit_idx)
        n = self.n_scan
        return ("OPT" if u == "opt" else "EMBED" if u == 0 else "FWD"
                if u <= n else "HEAD" if u == n + 1 else "BWD"
                if u <= 2 * n + 1 else "EMBED_BWD")

    # ------------------------------------------------------------ host --
    def _stage(self, state, names) -> None:
        idx = state["data_idx"] % self.pc.n_stage
        for k in names:
            src = state["data"][k][idx]
            if k not in self.batch:
                self.batch[k] = torch.empty_like(src)
            self.batch[k].copy_(src)

    def prepare(self, state) -> None:
        unit_idx = state["unit_idx"]
        kind = self.kind(unit_idx)
        if kind in ("EMBED", "EMBED_BWD") and self.has_work(unit_idx):
            # EMBED_BWD recomputes the front on its microbatch's tokens
            # (the same ring entry: `data_idx` moves after it)
            self._stage(state, [k for k in FRONT_INPUTS
                                if k in state["data"]])
        elif kind == "HEAD":
            self._stage(state, [k for k in state["data"]
                                if k not in FRONT_INPUTS])
        elif kind == "OPT":
            hp = torch.from_numpy(adamw_hparams(self.pc.opt,
                                                state["opt"]["t"] + 1))
            if self.hp.is_cuda:
                hp = hp.pin_memory()
            self.hp.copy_(hp, non_blocking=True)

    def advance(self, state) -> None:
        unit_idx = state["unit_idx"]
        kind = self.kind(unit_idx)
        if kind == "EMBED_BWD":
            state["data_idx"] += 1
            state["consumed"] += 1
        elif kind == "OPT":
            state["opt"]["t"] += 1
            state["iter"] += 1
        state["unit_idx"] = (unit_idx + 1) % self.total_units

    def has_work(self, unit_idx: int) -> bool:
        """Whether the unit does tensor work (EMBED_BWD only with "pre"
        layers)."""
        return self.kind(unit_idx) != "EMBED_BWD" or bool(self.pre_kinds)

    # ---------------------------------------------------------- device --
    def _front(self, pre_ads):
        """The embedding and the "pre" layers (pairs-form adapters)."""
        x, _, _ = MD._embed_inputs(self.params, self.cfg, {
            "tokens": self.batch["tokens"],
            "frontend": self.batch.get("frontend")})
        for kind, lp, ad in zip(self.pre_kinds, self.params["pre"],
                                pre_ads):
            x = MD.apply_layer(lp, x, self.positions, self.cfg, kind,
                               mode="full", lora=ad, scale=self.scale,
                               use_kernels=self.use_kernels)[0]
        return x

    def _layer(self, i, x, lora, state):
        # an MoE layer's aux loss is dropped, as the reference's units drop
        # it (`repro/training/peft.py:156`, `:224`): unlike `loss_fn`, the
        # units train on the CE alone
        enc_out = state.get("enc_out")
        y, _, _ = MD.apply_layer(MD._layer(self.params["scan"], i), x,
                                 self.positions, self.cfg, self.scan_kind,
                                 mode="full", lora=lora, scale=self.scale,
                                 enc_out=None if enc_out is None
                                 else enc_out.to(x.dtype),
                                 use_kernels=self.use_kernels)
        return y

    def _embed(self, state, _u):
        x = self._front([LR.as_pairs(ad) for ad in state["adapters"]["pre"]])
        state["x"].copy_(x)
        state["residuals"][0] = x
        if "enc_out" in state:
            state["enc_out"].copy_(MD._encode(self.params, self.cfg, {
                "enc_frames": self.batch["enc_frames"]}))

    def _embed_bwd(self, state, _u):
        """The "pre" layers' adapter grads: the front recomputed on this
        microbatch's tokens and back-propagated from dy = state["x"] by
        one `torch.autograd.grad`, as the reference's one `jax.vjp` over
        `front` (`repro/training/peft.py:239-254`). The flash attention's
        backward recomputes its softmax blocks, so autograd holds no f32
        attention block of any pre layer."""
        ads = [{name: {k: t.detach().requires_grad_() for k, t in v.items()}
                for name, v in layer.items()}
               for layer in state["adapters"]["pre"]]
        leaves = tree_leaves(ads)
        with torch.enable_grad():
            x = self._front([LR.as_pairs(ad) for ad in ads])
            grads = torch.autograd.grad(x, leaves,
                                        grad_outputs=state["x"].to(x.dtype))
        for acc, g in zip(tree_leaves(state["grads"]["pre"]), grads):
            acc += g.float()

    def _fwd(self, state, u):
        i = u - 1
        ad = LR.slice_adapters(state["adapters"]["scan"], i)
        y = self._layer(i, state["x"], ad, state)
        state["x"].copy_(y)
        state["residuals"][i + 1] = y

    def _head_loss(self, x):
        """The CE of the microbatch's text rows (the first `front` rows
        are patches; the reference's HEAD pairs them with labels)."""
        cfg, params, batch = self.cfg, self.params, self.batch
        h = L.rms_norm(x[:, self.front:], params["final_norm"], cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        mask = batch.get("mask")
        return L.chunked_softmax_xent(
            h[:, :-1], table, batch["labels"][:, 1:],
            None if mask is None else mask[:, 1:])

    def _head(self, state, _u):
        """The "post" layers (the hybrid's trailing RG-LRU layers) with
        their adapters as leaves, then the loss; dx and the post adapters'
        grads by one backward pass (the reference's `jax.vjp` over both,
        `repro/training/peft.py:190-202`)."""
        x = state["x"].detach().requires_grad_()
        ads = tree_map(lambda t: t.detach().requires_grad_(),
                       state["adapters"]["post"])
        leaves = tree_leaves(ads)
        with torch.enable_grad():
            h = x
            for kind, lp, ad in zip(self.post_kinds, self.params["post"],
                                    ads):
                h, _, _ = MD.apply_layer(
                    lp, h, self.positions, self.cfg, kind, mode="full",
                    lora=LR.as_pairs(ad), scale=self.scale,
                    use_kernels=self.use_kernels)
            loss = self._head_loss(h)
            grads = torch.autograd.grad(loss, [x] + leaves)
        for acc, g in zip(tree_leaves(state["grads"]["post"]), grads[1:]):
            acc += g.float()
        state["x"].copy_(grads[0])
        state["loss"].add_(loss.detach() / self.pc.accum)

    def _bwd(self, state, u):
        i = 2 * self.n_scan + 1 - u              # layer index, descending
        x_in = state["residuals"][i].detach().requires_grad_()
        ad = tree_map(lambda t: t[i].detach().requires_grad_(),
                      state["adapters"]["scan"])
        leaves = tree_leaves(ad)
        with torch.enable_grad():
            y = self._layer(i, x_in, LR.as_pairs(ad), state)
            grads = torch.autograd.grad(
                y, [x_in] + leaves, grad_outputs=state["x"].to(y.dtype))
        for acc, g in zip(tree_leaves(state["grads"]["scan"]), grads[1:]):
            acc[i] += g.float()
        state["x"].copy_(grads[0])

    def _opt(self, state, _u):
        adamw_update_(self.pc.opt, state["grads"], state["opt"],
                      state["adapters"], self.hp)
        for g in tree_leaves(state["grads"]):
            g.zero_()
        state["last_loss"].copy_(state["loss"])
        state["loss"].zero_()

    def run(self, state, unit_idx: int) -> None:
        """Unit `unit_idx`'s tensor work (none for EMBED_BWD without "pre"
        layers)."""
        if not self.has_work(unit_idx):
            return
        fn = {"EMBED": self._embed, "FWD": self._fwd, "HEAD": self._head,
              "BWD": self._bwd, "EMBED_BWD": self._embed_bwd,
              "OPT": self._opt}[self.kind(unit_idx)]
        with torch.no_grad():
            fn(state, unit_idx % self.upm)

    def __call__(self, state):
        self.prepare(state)
        self.run(state, state["unit_idx"])
        self.advance(state)
        return state


def make_unit_step(cfg: ModelConfig, pc: PeftConfig, params, *,
                   use_kernels: bool = False) -> UnitEngine:
    """Build `unit_step(state) -> state`, which runs exactly one unit."""
    return UnitEngine(cfg, pc, params, use_kernels=use_kernels)


def run_units(unit_step, state, k: int):
    """Run k units, in order, on the current stream."""
    for _ in range(max(k, 0)):
        state = unit_step(state)
    return state
