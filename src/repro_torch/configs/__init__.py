"""Architecture registry of the port: every config of the reference's
registry under the reference's names. The paper's qwen2.5-0.5b, the
reference's other dense decoders (smollm-360m, gemma-2b, gemma3-4b,
glm4-9b), its MoE family (qwen2-moe-a2.7b; deepseek-v2-lite-16b, MLA
+ MoE), its SSM (mamba2-130m, attention-free Mamba-2 SSD), its hybrid
(hymba-1.5b, attention beside SSD in every layer), its encoder
(hubert-xlarge: stub frame features through ``frame_proj``, a
bidirectional stack, a head over 504 codewords) and its VLM
(phi-3-vision-4.2b: stub patch embeddings through ``patch_proj``,
prepended to the tokens of a phi3-mini decoder).

Each config module exposes ``config()`` (the published dims) and
``smoke_config()`` (a reduced same-family variant for CPU tests). The
reference's shape cells and skip rules are here too: `SHAPES`,
`cells_for` and `skipped_cells`, which `roofline.costmodel` prices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (deepseek_v2_lite, gemma3_4b, gemma_2b,
                                 glm4_9b, hubert_xlarge, hymba_15b,
                                 mamba2_130m, phi3_vision, qwen2_moe_a27b,
                                 qwen25_05b, smollm_360m)
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: F401

_REGISTRY: dict[str, tuple[Callable, Callable]] = {
    "gemma-2b": (gemma_2b.config, gemma_2b.smoke_config),
    "gemma3-4b": (gemma3_4b.config, gemma3_4b.smoke_config),
    "glm4-9b": (glm4_9b.config, glm4_9b.smoke_config),
    "smollm-360m": (smollm_360m.config, smollm_360m.smoke_config),
    "qwen2-moe-a2.7b": (qwen2_moe_a27b.config, qwen2_moe_a27b.smoke_config),
    "deepseek-v2-lite-16b": (deepseek_v2_lite.config,
                             deepseek_v2_lite.smoke_config),
    "hymba-1.5b": (hymba_15b.config, hymba_15b.smoke_config),
    "hubert-xlarge": (hubert_xlarge.config, hubert_xlarge.smoke_config),
    "mamba2-130m": (mamba2_130m.config, mamba2_130m.smoke_config),
    "phi-3-vision-4.2b": (phi3_vision.config, phi3_vision.smoke_config),
    "qwen25-05b": (qwen25_05b.config, qwen25_05b.smoke_config),
}


ASSIGNED_ARCHS = tuple(a for a in _REGISTRY if a != "qwen25-05b")


def list_archs() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name][0]()


def get_smoke_config(name: str) -> ModelConfig:
    return _REGISTRY[name][1]()


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One lowered step's shape: seq_len × global_batch × step kind."""
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: runs for SSM/hybrid/local-global.
_LONG_OK = ("mamba2-130m", "hymba-1.5b", "gemma3-4b")


def cells_for(arch: str) -> list[str]:
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder:
        cells.append("decode_32k")
        if arch in _LONG_OK:
            cells.append("long_500k")
    return cells


def skipped_cells(arch: str) -> dict[str, str]:
    cfg = get_config(arch)
    skips = {}
    if cfg.is_encoder:
        skips["decode_32k"] = "encoder-only: no autoregressive decode step"
        skips["long_500k"] = "encoder-only: no decode step"
    elif arch not in _LONG_OK:
        skips["long_500k"] = ("pure full-attention arch: 500k decode needs "
                              "sub-quadratic attention (DESIGN.md §4)")
    return skips
