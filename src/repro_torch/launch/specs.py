"""Meta-tensor input stand-ins for every (arch x shape) dry-run cell.

Port of `repro/launch/specs.py`. The reference's stand-ins are
`jax.ShapeDtypeStruct`s from `jax.eval_shape` over the real initializers;
the port's are tensors on the meta device (shapes and dtypes, no memory),
with the reference's shapes and dtypes leaf by leaf. The weight, adapter
and cache trees are built by the real initializers under `FakeTensorMode`,
which draws no numbers (the initializers draw from a generator on their
device, which the meta device refuses), then each leaf is mapped to an
empty meta tensor: a DTensor step on fake tensors fails in the sharding
propagation of a product whose rows are flattened from two mesh axes
(`aten._local_scalar_dense`), and the same step on meta tensors runs.
Batches and decode inputs are made on the meta device directly.
Modality frontends are stubs, as in the reference: ``vlm`` cells get
precomputed patch embeddings, ``audio`` cells precomputed frame
embeddings.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import ShapeCell
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.training import peft as P
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.tree import tree_map

AUDIO_DECODE_ENC_LEN = 2048   # cross-attention source length for decode cells


def _meta(tree):
    """Each tensor of a tree as an empty meta tensor of its shape and
    dtype; other leaves (host counters) as they are."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)


def built(fn):
    """fn()'s tree built under `FakeTensorMode`, as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return _meta(tree)


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def param_structs(cfg: ModelConfig, dtype=torch.bfloat16):
    return built(lambda: MD.init_params(cfg, 0, dtype=dtype, device="cpu"))


def adapter_structs(cfg: ModelConfig):
    return built(lambda: MD.init_adapters(cfg, 0, device="cpu"))


def opt_structs(adapters):
    return adamw_init(adapters)


def cache_structs(cfg: ModelConfig, batch: int, s_max: int,
                  enc_len: int = 0):
    return built(lambda: MD.init_cache(cfg, batch, s_max, enc_len=enc_len,
                                        device="cpu"))


def _seq_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(text_tokens, frontend_len) so total context == seq_len."""
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        return seq_len - cfg.frontend_tokens, cfg.frontend_tokens
    if cfg.enc_layers:                       # enc-dec: half frames, half text
        return seq_len // 2, seq_len // 2
    return seq_len, 0


def _frontends(cfg: ModelConfig, B: int, front: int) -> Dict[str, Any]:
    out = {}
    if cfg.frontend == "vision" and front:
        out["frontend"] = _empty((B, front, cfg.d_model), torch.bfloat16)
    if cfg.enc_layers:
        out["enc_frames"] = _empty((B, front, cfg.d_model), torch.bfloat16)
    return out


def train_batch_structs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    B = cell.global_batch
    S_text, front = _seq_split(cfg, cell.seq_len)
    batch = {"tokens": _empty((B, S_text), torch.int32),
             "labels": _empty((B, S_text), torch.int32),
             "mask": _empty((B, S_text), torch.float32)}
    batch.update(_frontends(cfg, B, front))
    return batch


def prefill_structs(cfg: ModelConfig, cell: ShapeCell):
    B = cell.global_batch
    S_text, front = _seq_split(cfg, cell.seq_len)
    batch = {"tokens": _empty((B, S_text), torch.int32)}
    batch.update(_frontends(cfg, B, front))
    enc_len = front if cfg.enc_layers else 0
    return batch, cache_structs(cfg, B, cell.seq_len, enc_len)


def decode_structs(cfg: ModelConfig, cell: ShapeCell):
    B = cell.global_batch
    enc_len = AUDIO_DECODE_ENC_LEN if cfg.enc_layers else 0
    cache = cache_structs(cfg, B, cell.seq_len, enc_len)
    return (_empty((B,), torch.int32), _empty((B,), torch.int32), cache)


# ------------------------------------------------------------- step fns ---
def make_cell_fn(cfg: ModelConfig, cell: ShapeCell
                 ) -> Tuple[Callable, Tuple[Any, ...]]:
    """Returns (step_fn, arg stand-ins) for a dry-run cell.

    train  -> PEFT train step (paper workload: LoRA finetune)
    prefill-> prompt processing into a fresh cache
    decode -> one serve_step token over a seq_len cache

    The steps are the port's own, with the kernels off, as the reference's
    are (and a kernel's wrapper refuses a DTensor)."""
    if cell.kind == "train":
        step = P.make_train_step(cfg, AdamWConfig(), use_kernels=False,
                                 remat=True)
        params = param_structs(cfg)
        adapters = adapter_structs(cfg)
        opt = opt_structs(adapters)
        batch = train_batch_structs(cfg, cell)
        return step, (params, adapters, opt, batch)
    if cell.kind == "prefill":
        batch, cache = prefill_structs(cfg, cell)

        def step(params, batch, cache):
            return MD.prefill(params, cfg, batch, cache)

        return step, (param_structs(cfg), batch, cache)
    # decode
    tokens, positions, cache = decode_structs(cfg, cell)

    def step(params, tokens, positions, cache):
        return MD.decode_step(params, cfg, tokens, positions, cache)

    return step, (param_structs(cfg), tokens, positions, cache)
