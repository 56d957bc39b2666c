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
product is exact in f64). On CUDA they run in float32 (TF32 off), where
cuBLAS picks its kernel from the shape (a GEMV for one row, a tiled GEMM
for more), so `matmul_f32_rows` feeds it blocks of a fixed row count,
except inside `free_rows` (a full-sequence forward, whose rows are never
held against rows of another M).
"""
from __future__ import annotations

import contextlib

import torch


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type these products sum in: float64 on the CPU,
    float32 on CUDA."""
    return t.to(torch.float64 if t.device.type == "cpu" else torch.float32)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 (see the module docstring)."""
    return torch.matmul(wide(a), wide(b)).to(torch.float32)


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in float32 (see the module docstring)."""
    return torch.einsum(eq, wide(a), wide(b)).to(torch.float32)


def einsum_wide(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`einsum_f32` before its one rounding to float32 (float64 on the
    CPU, float32 on CUDA): partial products that shards sum first."""
    return torch.einsum(eq, wide(a), wide(b))


def einsum_f64(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` in float64 on every device, left in
    float64. For a chain of products whose rows must not depend on the
    call's batch or on the length of the axis it sums over, on CUDA too
    (MLA's absorbed decode, whose keys span the whole cache): the chain
    stays in float64 and is rounded to float32 once at its end, so a
    different order of the sums moves only bits that rounding drops."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64))


# Rows a cuBLAS call takes. At 4 rows cuBLAS serves an f32 product with
# kernels that spread over many blocks; at 16 it gave the k / v
# projections' 896 → 128 product one 32 × 128 tile, one block, 51 µs a
# call on the H100 (chip_smoke.py's profile, PR 21).
ROW_BLOCK = 4
_FREE_ROWS = False


@contextlib.contextmanager
def free_rows(on: bool = True):
    """Within, `matmul_f32_rows` makes one call whatever its row count.

    For full-sequence forwards (train, prefill, the calibration forward):
    their rows are never held against rows computed at another M (a
    one-shot prefill and `generate()`'s prefill of one prompt have the
    same M), and blocks of `ROW_BLOCK` would cost M / 4 launches a linear
    at M up to 1,024. Serving steps (decode, chunk, verify) and the head stay
    blocked."""
    global _FREE_ROWS
    prev, _FREE_ROWS = _FREE_ROWS, on
    try:
        yield
    finally:
        _FREE_ROWS = prev


def matmul_wide_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`matmul_f32_rows` before its one rounding to float32: float64 on
    the CPU, float32 on CUDA. A row-parallel linear's shards sum these
    partial products and round once, as the unsharded product does."""
    if a.device.type != "cuda" or _FREE_ROWS:
        return torch.matmul(wide(a), wide(b))
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k).to(torch.float32)
    m = a2.shape[0]
    a2 = torch.cat([a2, a2.new_zeros(-m % ROW_BLOCK, k)])
    bw = b.to(torch.float32)
    outs = [torch.matmul(a2[i:i + ROW_BLOCK], bw)
            for i in range(0, a2.shape[0], ROW_BLOCK)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:m].reshape(*lead, b.shape[-1])


def matmul_f32_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 with each row's bits independent of how many
    rows the call holds: on CUDA the rows go through cuBLAS in blocks of
    `ROW_BLOCK` (the last one zero-padded), so every row meets the same
    kernel at the same shape whether it is one of 1 (`generate`), of 4 (a
    decode step of 4 slots) or of 20 (a verify step of 4 rows × 5
    positions). ``b``
    is widened once for all blocks. On the CPU, and inside `free_rows`,
    `matmul_f32`."""
    return matmul_wide_rows(a, b).to(torch.float32)
