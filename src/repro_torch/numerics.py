"""Float32 contractions whose rows do not depend on the batch.

CPU BLAS libraries pick their blocking, and with it the order of the
sums, from the shapes of a call, so one row's product can round
differently when it shares a call with 47 other rows than when it is
alone. The serving engine batches rows that `generate` computes one at a
time, and its greedy streams must equal `generate`'s token for token;
a last-bit difference, rounded once more into a bf16 cache, is enough
to flip a near-tied argmax. On the CPU these products therefore run in
float64 and are rounded once to float32, which makes each row's result
independent of its neighbours (the inputs are f32 or narrower, so every
product is exact in f64). On CUDA they run in float32 (TF32 off).
"""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float64 if t.device.type == "cpu" else torch.float32)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 (see the module docstring)."""
    return torch.matmul(_wide(a), _wide(b)).to(torch.float32)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in float32 (see the module docstring)."""
    return torch.einsum(eq, _wide(a), _wide(b)).to(torch.float32)
