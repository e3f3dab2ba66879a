"""Architecture registry + assigned shape cells.

``--arch <id>`` everywhere resolves through ``get_config``. Each arch also has
a reduced smoke sibling (``smoke_config``) exercised by tests; full configs
are only lowered symbolically by the dry-run.

The port's own copy of `repro.configs`; the config files beside it are
copies too.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.models.config import ModelConfig, scale_down

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-14b": "qwen3_14b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "qwen3-8b": "qwen3_8b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's own evaluation models
    "llama3-8b": "llama3_8b",
    "qwen2.5-7b": "qwen2_5_7b",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k not in
                       ("llama3-8b", "qwen2.5-7b"))
PAPER_ARCHS = ("llama3-8b", "qwen2.5-7b")


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    return scale_down(get_config(name))


# ------------------------------------------------------------ shape cells --
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic / bounded-cache decode (DESIGN.md §4):
# SSM and hybrid run it; SWA archs run it (decode cost O(window)); pure
# full-attention archs skip it.
_SUBQUADRATIC = ("mamba2-780m", "recurrentgemma-2b", "mixtral-8x7b",
                 "h2o-danube-1.8b")


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "pure full-attention decode (sub-quadratic required)"
    return True, ""


def cells(include_skipped: bool = False
          ) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Yield (arch, shape, skip_reason|None) over the assigned 40-cell grid."""
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            if ok:
                yield arch, shape, None
            elif include_skipped:
                yield arch, shape, why
