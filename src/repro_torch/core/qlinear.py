"""Quantized-linear application — the runtime half of the paper's technique.

``qlinear_apply`` is the dispatch point of one linear, and
``qgateup_apply`` of a GLU's gate/up pair (kernel K3,
`kernels.awq_matmul.awq_gateup`, where the kernel is selected), between:

  * ``ref``    — unpack → dequant → ``torch.matmul`` (the generic path),
  * ``kernel`` — the fused unpack + dequant + MAC kernel K1
                 (`kernels.awq_matmul`), the analogue of the paper's
                 MACRO_MAC units. For CPU tensors its wrapper runs the
                 kernel's plain version.

``impl="auto"`` resolves to the kernel for CUDA tensors and to ``ref``
elsewhere. The paper's hybrid split (§III) is kept as the reference has
it: matmuls below ``offload_min_flops`` stay on the generic path even
when the kernel is selected — at Qwen2.5 width that is the k / v
projections at M <= 4 (2·M·896·128 < 2^20). The gate/up pair counts
both products' flops, 2·M·K·2N. The generic path's product keeps a
row's bits independent of M on the card (`numerics.matmul_f32_rows`), as
K1's and K3's summation rule does: a decode row at M 4 equals the same
row of `generate()` at M 1.

``qlinear_experts_apply`` and ``qgateup_experts_apply`` are the same
dispatch for a MoE layer's stacked experts (a `PackedLinear` whose
tensors carry a leading expert dim) over their capacity buffer
``[E, C, K]``: one K1 / K3 launch for all experts on the kernel path,
each expert in turn on the generic path (one expert's dense weight live
at a time, as the reference's ``lax.map``). The threshold counts the
whole call's flops.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.packing import PackedLinear, dequantize_packed
from repro_torch.kernels import awq_matmul as k1
from repro_torch.numerics import matmul_wide_rows


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Runtime knobs for the quantized path."""

    impl: str = "auto"                   # "auto" | "ref" | "kernel"
    compute_dtype: torch.dtype = torch.bfloat16
    offload_min_flops: float = 2 ** 20   # hybrid threshold (paper §III)


@dataclasses.dataclass
class PathCounts:
    """Calls of `qlinear_apply` and `qgateup_apply` by the path they
    took."""
    kernel: int = 0
    generic: int = 0


_EXEC = ExecutionConfig()
COUNTS = PathCounts()


def set_execution_config(**kw) -> ExecutionConfig:
    """Replace the ambient execution config's fields (``impl``,
    ``compute_dtype``, ``offload_min_flops``) for every later call that
    passes no ``cfg=``; returns the new config."""
    global _EXEC
    _EXEC = dataclasses.replace(_EXEC, **kw)
    return _EXEC


def get_execution_config() -> ExecutionConfig:
    """The ambient execution config."""
    return _EXEC


@contextlib.contextmanager
def execution_config(cfg: ExecutionConfig):
    """Pin the ambient execution config for the duration of the block."""
    global _EXEC
    prev, _EXEC = _EXEC, cfg
    try:
        yield cfg
    finally:
        _EXEC = prev


def _resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in ("auto", "ref", "kernel"):
        raise ValueError(f"unknown qlinear impl {impl!r}")
    if impl != "auto":
        return impl
    return "kernel" if x.device.type == "cuda" else "ref"


def _qlinear_rows(p: PackedLinear, x2: torch.Tensor, impl: str,
                  cfg: ExecutionConfig, out_dtype: torch.dtype | None
                  ) -> torch.Tensor:
    """``(x2 * input_scale) [M, K] @ dequant(qweight)`` without the bias,
    rounded to ``out_dtype``, or left unrounded for ``out_dtype=None``
    (K1's f32; the generic path's `numerics.matmul_wide_rows`). The
    hybrid threshold counts the unsharded product (``p.shards``)."""
    m, k = x2.shape
    if impl == "kernel" and 2.0 * m * k * p.n * p.shards \
            < cfg.offload_min_flops:
        impl = "ref"  # hybrid threshold: tiny GEMV stays on the generic path
    if impl == "kernel":
        COUNTS.kernel += 1
        return k1.awq_matmul(x2.contiguous(), p.qweight, p.scales, p.zeros,
                             p.group_size, compute_dtype=cfg.compute_dtype,
                             input_scale=p.input_scale,
                             out_dtype=out_dtype or torch.float32)
    COUNTS.generic += 1
    if p.input_scale is not None:
        x2 = x2.to(torch.float32) * p.input_scale[None, :]
    w = dequantize_packed(p, cfg.compute_dtype)
    y = matmul_wide_rows(x2.to(cfg.compute_dtype), w)
    return y if out_dtype is None else y.to(torch.float32).to(out_dtype)


def qlinear_apply(p: PackedLinear, x: torch.Tensor, impl: str | None = None,
                  cfg: ExecutionConfig | None = None, *,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``y = (x * input_scale) @ dequant(qweight) + bias``.

    ``x`` [..., K]; returns [..., N] in ``out_dtype`` (default x.dtype).
    The casts follow the reference: x → f32, times ``input_scale`` (none
    for a linear whose input arrives scaled), → ``compute_dtype``; the
    product comes out in f32, is cast to the output dtype, and the bias is
    added in that dtype. The kernel route hands x, ``input_scale`` and the
    output dtype to K1, which makes the same roundings itself.
    """
    cfg = cfg if cfg is not None else _EXEC
    impl = _resolve_impl(impl or cfg.impl, x)
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    y = _qlinear_rows(p, x.reshape(-1, k), impl, cfg, out_dtype)
    if p.bias is not None:
        y = y + p.bias.to(out_dtype)
    return y.reshape(*lead, p.n)


def qlinear_partial(p: PackedLinear, x: torch.Tensor,
                    impl: str | None = None,
                    cfg: ExecutionConfig | None = None) -> torch.Tensor:
    """One shard's partial product of a row-parallel linear, ``(x *
    input_scale) @ dequant(qweight)`` over its K slice, unrounded and
    without the bias: the shards' partials are summed in shard order,
    then rounded and biased once (`models.layers.linear_tp`)."""
    cfg = cfg if cfg is not None else _EXEC
    impl = _resolve_impl(impl or cfg.impl, x)
    lead, k = x.shape[:-1], x.shape[-1]
    y = _qlinear_rows(p, x.reshape(-1, k), impl, cfg, None)
    return y.reshape(*lead, p.n)


def qlinear_prescale(p: PackedLinear, x: torch.Tensor,
                     cfg: ExecutionConfig | None = None) -> torch.Tensor:
    """``x`` times ``input_scale`` in f32, rounded to ``compute_dtype``:
    `qlinear_apply`'s first step, on its own. A shard whose input is split
    over K but whose weight is split over N takes it on its K slice
    before the slices are joined (`models.layers.linear_tp`)."""
    cfg = cfg if cfg is not None else _EXEC
    return (x.to(torch.float32) * p.input_scale).to(cfg.compute_dtype)


def fusable_gateup(gate, up, act: str) -> bool:
    """Whether a GLU front runs as one K3 pair: SiLU over two packed,
    bias-free linears of equal K, N and group size (every quantized SiLU
    front; float weights, during calibration, take two linears)."""
    return (act == "silu" and isinstance(gate, PackedLinear)
            and isinstance(up, PackedLinear) and gate.bias is None
            and up.bias is None and gate.group_size == up.group_size
            and (gate.k, gate.n) == (up.k, up.n))


def qgateup_apply(gate: PackedLinear, up: PackedLinear, x: torch.Tensor,
                  impl: str | None = None,
                  cfg: ExecutionConfig | None = None) -> torch.Tensor:
    """``silu(qlinear_apply(gate, x)) * qlinear_apply(up, x)`` in one
    pass over x, for two bias-free linears of equal K, N and group size.

    Returns [..., N] in x.dtype, rounded as the two calls round it (see
    `kernels.awq_matmul.awq_gateup`), so on the plain path the result is
    bit-identical to theirs.
    """
    cfg = cfg if cfg is not None else _EXEC
    impl = _resolve_impl(impl or cfg.impl, x)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if impl == "kernel" and 2.0 * x2.shape[0] * k * 2 * gate.n \
            * gate.shards < cfg.offload_min_flops:
        impl = "ref"
    if impl == "kernel":
        COUNTS.kernel += 1
        fn = k1.awq_gateup
    else:
        COUNTS.generic += 1
        fn = k1.awq_gateup_ref
    h = fn(x2.contiguous(), gate.qweight, gate.scales, gate.zeros,
           up.qweight, up.scales, up.zeros, gate.group_size,
           cfg.compute_dtype, input_scales=(gate.input_scale, up.input_scale),
           out_dtype=x.dtype)
    return h.reshape(*lead, gate.n)


def qlinear_experts_apply(p: PackedLinear, x: torch.Tensor,
                          impl: str | None = None,
                          cfg: ExecutionConfig | None = None
                          ) -> torch.Tensor:
    """Expert e's `qlinear_apply` on ``x[e]``: x ``[E, C, K]`` -> ``[E, C,
    N]`` in x.dtype, for stacked bias-free experts (`PackedLinear` with
    qweight ``[E, K/8, N]``)."""
    cfg = cfg if cfg is not None else _EXEC
    impl = _resolve_impl(impl or cfg.impl, x)
    e, c, k = x.shape
    if impl == "kernel" and 2.0 * e * c * k * p.n * p.shards \
            < cfg.offload_min_flops:
        impl = "ref"
    if impl == "kernel":
        COUNTS.kernel += 1
        fn = k1.awq_matmul_experts
    else:
        COUNTS.generic += 1
        fn = k1.awq_matmul_experts_ref
    return fn(x.contiguous(), p.qweight, p.scales, p.zeros, p.group_size,
              cfg.compute_dtype, input_scale=p.input_scale, out_dtype=x.dtype)


def qgateup_experts_apply(gate: PackedLinear, up: PackedLinear,
                          x: torch.Tensor, impl: str | None = None,
                          cfg: ExecutionConfig | None = None
                          ) -> torch.Tensor:
    """Expert e's `qgateup_apply` on ``x[e]``: x ``[E, C, K]`` -> ``[E, C,
    N]`` in x.dtype, for stacked gate / up experts."""
    cfg = cfg if cfg is not None else _EXEC
    impl = _resolve_impl(impl or cfg.impl, x)
    e, c, k = x.shape
    if impl == "kernel" and 2.0 * e * c * k * 2 * gate.n * gate.shards \
            < cfg.offload_min_flops:
        impl = "ref"
    if impl == "kernel":
        COUNTS.kernel += 1
        fn = k1.awq_gateup_experts
    else:
        COUNTS.generic += 1
        fn = k1.awq_gateup_experts_ref
    return fn(x.contiguous(), gate.qweight, gate.scales, gate.zeros,
              up.qweight, up.scales, up.zeros, gate.group_size,
              cfg.compute_dtype,
              input_scales=(gate.input_scale, up.input_scale),
              out_dtype=x.dtype)
