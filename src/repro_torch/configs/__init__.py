"""Architecture registry of the port: the paper's qwen2.5-0.5b and the
reference's other dense decoders (smollm-360m, gemma-2b, gemma3-4b,
glm4-9b).

Each config module exposes ``config()`` (the published dims) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (gemma3_4b, gemma_2b, glm4_9b, qwen25_05b,
                                 smollm_360m)
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: F401

_REGISTRY: dict[str, tuple[Callable, Callable]] = {
    "gemma-2b": (gemma_2b.config, gemma_2b.smoke_config),
    "gemma3-4b": (gemma3_4b.config, gemma3_4b.smoke_config),
    "glm4-9b": (glm4_9b.config, glm4_9b.smoke_config),
    "smollm-360m": (smollm_360m.config, smollm_360m.smoke_config),
    "qwen25-05b": (qwen25_05b.config, qwen25_05b.smoke_config),
}


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
    step: str  # "prefill" | "decode"
