"""Group-wise asymmetric INT4 quantization primitives (AWQ numerics).

Weight convention: ``W`` has shape ``[K, N]`` (input-channels,
output-channels) and a linear layer computes ``y = x @ W``. Groups are
contiguous runs of ``group_size`` rows along K, one (scale, zero) pair per
(group, output-channel): scales/zeros are ``[K // group_size, N]``.

The arithmetic is the reference's step for step (f32 min/max, divide,
round-half-to-even, clip), so codes are bit-identical to it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Weight-only group quantization: 4 bits, GS 64 (the paper's choice),
    asymmetric zero-points; ``compute_dtype`` is what weights dequantize
    to inside the matmul pipeline."""

    bits: int = 4
    group_size: int = 64
    sym: bool = False
    compute_dtype: torch.dtype = torch.float32

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1

    def validate_k(self, k: int) -> None:
        if k % self.group_size != 0:
            raise ValueError(
                f"K={k} must be divisible by group_size={self.group_size}")


def quantize_groupwise(w: torch.Tensor, cfg: QuantConfig):
    """Quantize ``w [..., K, N]`` → (q int32 [..., K, N] in [0, qmax],
    scales f32 [..., K//GS, N], zeros int32 [..., K//GS, N]); leading dims
    (AWQ's candidate grid) are independent weights."""
    *lead, k, n = w.shape
    cfg.validate_k(k)
    g = k // cfg.group_size
    wg = w.reshape(*lead, g, cfg.group_size, n).to(torch.float32)
    if cfg.sym:
        amax = wg.abs().amax(dim=-2)
        qhalf = cfg.qmax // 2
        scales = amax / qhalf
        scales = torch.where(scales == 0, torch.ones_like(scales), scales)
        zeros = torch.full((*lead, g, n), qhalf + 1, dtype=torch.int32,
                           device=w.device)
        q = torch.round(wg / scales[..., None, :]) + (qhalf + 1)
    else:
        wmax = wg.amax(dim=-2)
        wmin = wg.amin(dim=-2)
        scales = (wmax - wmin) / cfg.qmax
        scales = torch.where(scales == 0, torch.ones_like(scales), scales)
        zeros = torch.clip(torch.round(-wmin / scales), 0,
                           cfg.qmax).to(torch.int32)
        q = torch.round(wg / scales[..., None, :]) + zeros[..., None, :]
    q = torch.clip(q, 0, cfg.qmax).to(torch.int32)
    return q.reshape(*lead, k, n), scales, zeros


def dequantize_groupwise(q: torch.Tensor, scales: torch.Tensor,
                         zeros: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Inverse of `quantize_groupwise`: ``w = (q - zero) * scale``."""
    *lead, k, n = q.shape
    g = k // cfg.group_size
    qg = q.reshape(*lead, g, cfg.group_size, n).to(torch.float32)
    w = (qg - zeros[..., None, :].to(torch.float32)) * scales[..., None, :]
    return w.reshape(*lead, k, n).to(cfg.compute_dtype)


def fake_quantize(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize roundtrip (the operator AWQ's search minimizes)."""
    return dequantize_groupwise(*quantize_groupwise(w, cfg), cfg).to(w.dtype)


def quantization_mse(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Mean squared quantization error of plain round-to-nearest (a 0-d
    f32 tensor for an f32 ``w``)."""
    return torch.mean((fake_quantize(w, cfg) - w) ** 2)


def fake_quantize_fast(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """The reference's jitted fake-quant for AWQ's grid search; eager
    PyTorch has no jit to take, so it is `fake_quantize`."""
    return fake_quantize(w, cfg)
