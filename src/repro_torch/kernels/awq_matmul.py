"""K1: fused int4 unpack + dequantize + matmul (`csrc/awq_matmul.cu`).

Port of the reference's Pallas kernel `awq_matmul_pallas` and its oracle
`ref.awq_matmul_ref`. `awq_matmul` launches the hand-written CUDA kernel
for CUDA tensors and takes the plain version, `awq_matmul_ref`, only for
CPU tensors. There is no row padding: any M works.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PACK, dequantize_int4
from repro_torch.kernels.build import LaunchCounter, check, load
from repro_torch.numerics import matmul_f32

COUNTER = LaunchCounter()


def awq_matmul_ref(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor, zeros: torch.Tensor,
                   group_size: int,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x [M, K] @ dequant(qweight) [K, N] -> [M, N] float32``.

    x and W are rounded to ``compute_dtype`` and every product is exact,
    so this is the reference's ``dot(..., preferred_element_type=f32)``
    up to the order of the sums (`numerics.matmul_f32`).
    """
    w = dequantize_int4(qweight, scales, zeros, group_size, compute_dtype)
    return matmul_f32(x.to(compute_dtype), w)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"awq_matmul: {msg}")


def awq_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               zeros: torch.Tensor, group_size: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused quantized matmul ``x [M, K] -> [M, N] float32``.

    CPU tensors take `awq_matmul_ref`; CUDA tensors launch the kernel,
    which takes bf16 x and ``compute_dtype=bfloat16`` only, and raises on
    anything else.
    """
    if x.device.type == "cpu":
        return awq_matmul_ref(x, qweight, scales, zeros, group_size,
                              compute_dtype)
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    _check(compute_dtype == torch.bfloat16 and x.dtype == torch.bfloat16,
           f"the kernel takes bf16 x and compute dtype, got {x.dtype} / "
           f"{compute_dtype}")
    _check(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [M, K]")
    m, k = x.shape
    n = qweight.shape[-1]
    _check(k % PACK == 0 and group_size % PACK == 0 and k % group_size == 0,
           f"K={k} must be a multiple of group_size={group_size}, itself a "
           f"multiple of 8")
    _check(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    for t, name, dtype, shape in (
            (qweight, "qweight", torch.int32, (k // PACK, n)),
            (scales, "scales", torch.float32, (k // group_size, n)),
            (zeros, "zeros", torch.int8, (k // group_size, n))):
        _check(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    lib = load("awq_matmul")
    err = lib.awq_matmul_bf16(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        out.data_ptr(), m, k, n, group_size, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "awq_matmul")
    COUNTER.count += 1
    return out
