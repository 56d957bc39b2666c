"""Architecture registry of the port: so far only the paper's qwen2.5-0.5b.

Each config module exposes ``config()`` (the published dims) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import qwen25_05b
from repro_torch.configs.base import LayerKind, ModelConfig  # noqa: F401

_REGISTRY: dict[str, tuple[Callable, Callable]] = {
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
