"""K1: fused int4 unpack + dequantize + matmul (`csrc/awq_matmul.cu`), and
K3: the fused gate/up GLU front over two packed weights
(`csrc/awq_gateup.cu`); both instantiate the tensor-core kernels of
`csrc/awq_common.cuh`, one weight or two, under one summation rule.

Ports of the reference's Pallas kernels `awq_matmul_pallas` and
`awq_gateup_pallas` and their oracles `ref.awq_matmul_ref` and
`ref.awq_gateup_ref`. `awq_matmul` and `awq_gateup` launch the
hand-written CUDA kernels for CUDA tensors and take the plain versions
(`awq_matmul_ref`, `awq_gateup_ref`) only for CPU tensors (and ``meta``
tensors, whose shapes the dry run reads). There is no
row padding: any M works. `awq_matmul_experts` and `awq_gateup_experts`
run the same kernels over a MoE layer's stacked experts, one launch for
all of them (the expert axis), beside their plain versions
`awq_matmul_experts_ref` / `awq_gateup_experts_ref`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PACK, dequantize_int4
from repro_torch.kernels.build import LaunchCounter, check, load, plain
from repro_torch.numerics import matmul_f32

COUNTER = LaunchCounter()
GATEUP_COUNTER = LaunchCounter()
# launches over a MoE layer's stacked experts (counted in the two above too)
EXPERT_COUNTER = LaunchCounter()
GATEUP_EXPERT_COUNTER = LaunchCounter()


def awq_matmul_ref(x: torch.Tensor, qweight: torch.Tensor,
                   scales: torch.Tensor, zeros: torch.Tensor,
                   group_size: int,
                   compute_dtype: torch.dtype = torch.float32, *,
                   input_scale: torch.Tensor | None = None,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(x * input_scale) [M, K] @ dequant(qweight) [K, N] -> [M, N]``.

    x (times ``input_scale`` in f32, where it is given) and W are rounded
    to ``compute_dtype`` and every product is exact, so this is the
    reference's ``dot(..., preferred_element_type=f32)`` up to the order
    of the sums (`numerics.matmul_f32`); the f32 result is rounded once
    to ``out_dtype``.
    """
    w = dequantize_int4(qweight, scales, zeros, group_size, compute_dtype)
    if input_scale is not None:
        x = x.to(torch.float32) * input_scale[None, :]
    return matmul_f32(x.to(compute_dtype), w).to(out_dtype)


def _checker(kernel: str):
    def chk(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{kernel}: {msg}")
    return chk


_check = _checker("awq_matmul")

SPAN = 128      # k per span of the summation rule (csrc/awq_common.cuh)
SMS = 132       # the H100's SMs
SPLIT_BYTES = 48 << 20      # largest span-partial scratch worth a split


def span_block(m: int, k: int, n: int, experts: int = 1) -> int:
    """Spans of 128 k each block of K1's launch takes (all of them: no
    split; fewer: the spans are split over blocks, their partials go to
    scratch and a merge pass adds them in span order).

    Up to M 16 (the decode kernel: 16 columns a block, one span per warp
    of 8) up to 8 spans stay in one block; more go in 8 groups, each one
    round of the block's warps, unless the call covers ``experts``
    stacked weights whose column blocks alone give two blocks an SM
    (a MoE layer's experts: 60 x 128 blocks for qwen2-moe's down). Above,
    the prefill kernel's 64-column x 64- or 128-row tiles (of every
    expert) are split only when they fill less than half the SMs and the
    scratch is small, into groups that give about two blocks an SM.
    (Measured on the H100: unsplit, down's 38 spans take 4x as long at
    M 128; split, 896 -> 896 at M 1024 takes 1.6x as long.)
    """
    nspan = -(-k // SPAN)
    if m <= 16:
        if experts > 1 and experts * -(-n // 16) >= 2 * SMS:
            return nspan
        return nspan if nspan <= 8 else -(-nspan // 8)
    tiles = experts * -(-n // 64) * -(-m // (64 if m <= 64 else 128))
    if 2 * tiles >= SMS or experts * nspan * m * n * 4 > SPLIT_BYTES:
        return nspan
    groups = min(nspan, -(-2 * SMS // tiles))
    return -(-nspan // groups)


def _check_launch(chk, x, weights, vectors, group_size, compute_dtype,
                  out_dtype):
    """Check a launch's operands: x ``[E, M, K]``; each weight's (qweight,
    scales, zeros) ``[E, K/8, N]``, ``[E, K/GS, N]``, ``[E, K/GS, N]``;
    each input scale ``[E, K]`` (without the leading E for one linear,
    E = 1). Returns (E, M, K, N)."""
    chk(x.device.type == "cuda", f"unsupported device {x.device}")
    chk(compute_dtype == torch.bfloat16,
        f"the kernel computes in bf16, got {compute_dtype}")
    chk(x.dtype in (torch.bfloat16, torch.float32),
        f"x must be bf16 or f32, got {x.dtype}")
    chk(out_dtype in (torch.bfloat16, torch.float32),
        f"out_dtype must be bf16 or f32, got {out_dtype}")
    chk(x.dim() == 3 and x.is_contiguous(), "x must be contiguous")
    e, m, k = x.shape
    n = weights[0][0].shape[-1]
    chk(k % PACK == 0 and group_size % PACK == 0 and k % group_size == 0,
        f"K={k} must be a multiple of group_size={group_size}, itself a "
        f"multiple of 8")
    chk(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    lead = (e,) if weights[0][0].dim() == 3 else ()
    for (qw, sc, zr), names in zip(weights, (("qweight", "scales", "zeros"),
                                             ("qw_up", "s_up", "z_up"))):
        for t, name, dtype, shape in (
                (qw, names[0], torch.int32, (k // PACK, n)),
                (sc, names[1], torch.float32, (k // group_size, n)),
                (zr, names[2], torch.int8, (k // group_size, n))):
            chk(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
            chk(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
            chk(tuple(t.shape) == lead + shape,
                f"{name} must be {lead + shape}, got {tuple(t.shape)}")
            chk(t.is_contiguous(), f"{name} must be contiguous")
    for v in vectors:
        chk(v.device == x.device, f"input scale on {v.device}, x on {x.device}")
        chk(v.dtype == torch.float32, f"input scale must be f32, got {v.dtype}")
        chk(tuple(v.shape) == lead + (k,),
            f"input scale must be {lead + (k,)}, got {tuple(v.shape)}")
        chk(v.is_contiguous(), "input scale must be contiguous")
        chk(v.data_ptr() % 16 == 0, "input scale must be 16-byte aligned")
    return e, m, k, n


def _launch_matmul(x, qweight, scales, zeros, group_size, compute_dtype,
                   input_scale, out_dtype) -> torch.Tensor:
    """One K1 launch over x ``[E, M, K]`` and E stacked weights (E = 1: a
    plain linear, weights without the leading dim) -> ``[E, M, N]``."""
    vectors = [] if input_scale is None else [input_scale]
    e, m, k, n = _check_launch(_check, x, [(qweight, scales, zeros)],
                               vectors, group_size, compute_dtype, out_dtype)
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    if m == 0 or e == 0:
        return out
    sb = span_block(m, k, n, e)
    nspan = -(-k // SPAN)
    part = (torch.empty(e * nspan * m * n, dtype=torch.float32,
                        device=x.device) if sb < nspan else None)
    lib = load("awq_matmul")
    err = lib.awq_matmul(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        None if input_scale is None else input_scale.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        int(x.dtype == torch.float32), int(out_dtype == torch.bfloat16),
        m, k, n, group_size, sb, e, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "awq_matmul")
    COUNTER.count += 1
    if qweight.dim() == 3:
        EXPERT_COUNTER.count += 1
    return out


def awq_matmul(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
               zeros: torch.Tensor, group_size: int,
               compute_dtype: torch.dtype = torch.bfloat16, *,
               input_scale: torch.Tensor | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused quantized matmul ``(x * input_scale) [M, K] -> [M, N]``.

    The rule: ``x`` — times the linear's per-K ``input_scale`` in f32
    where it is given, as `qlinear_apply` scales it — is rounded to
    ``compute_dtype``, multiplied by the dequantized weight with f32
    accumulation, and the f32 result is rounded once to ``out_dtype``.
    Without ``input_scale`` and with ``out_dtype=float32`` this is the
    TPU kernel's function.

    CPU tensors take `awq_matmul_ref`; CUDA tensors launch the kernel,
    which takes bf16 or f32 x, ``compute_dtype=bfloat16`` and an f32 or
    bf16 output, and raises on anything else. The kernel runs on tensor
    cores under K3's summation rule (`awq_gateup`; stated in full in
    `csrc/awq_common.cuh`), so a row's bits do not depend on M or on the
    run, and its total for a weight equals K3's. `span_block` picks how
    the spans are split over blocks (a split call is two launches,
    counted as one).
    """
    if plain(x):
        return awq_matmul_ref(x, qweight, scales, zeros, group_size,
                              compute_dtype, input_scale=input_scale,
                              out_dtype=out_dtype)
    _check(x.dim() == 2, "x must be [M, K]")
    return _launch_matmul(x[None], qweight, scales, zeros, group_size,
                          compute_dtype, input_scale, out_dtype)[0]


def awq_matmul_experts_ref(x: torch.Tensor, qweight: torch.Tensor,
                           scales: torch.Tensor, zeros: torch.Tensor,
                           group_size: int,
                           compute_dtype: torch.dtype = torch.float32, *,
                           input_scale: torch.Tensor | None = None,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain version of `awq_matmul_experts`: `awq_matmul_ref` on each
    expert in turn (one expert's dense weight live at a time)."""
    return torch.stack([awq_matmul_ref(
        x[e], qweight[e], scales[e], zeros[e], group_size, compute_dtype,
        input_scale=None if input_scale is None else input_scale[e],
        out_dtype=out_dtype) for e in range(x.shape[0])])


def awq_matmul_experts(x: torch.Tensor, qweight: torch.Tensor,
                       scales: torch.Tensor, zeros: torch.Tensor,
                       group_size: int,
                       compute_dtype: torch.dtype = torch.bfloat16, *,
                       input_scale: torch.Tensor | None = None,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """K1 over a MoE layer's stacked experts: x ``[E, M, K]`` (expert e's
    capacity rows) times expert e's packed weight (qweight ``[E, K/8,
    N]``, scales / zeros ``[E, K/GS, N]``, input_scale ``[E, K]``) ->
    ``[E, M, N]``, each slice under `awq_matmul`'s rule.

    CPU tensors take `awq_matmul_experts_ref`; CUDA tensors make one
    launch for all E experts (the expert axis of `csrc/awq_common.cuh`),
    whose slice e is bit-equal to `awq_matmul` on expert e alone.
    `EXPERT_COUNTER` counts these launches besides `COUNTER` (a call
    with no rows launches nothing and counts nothing).
    """
    if plain(x):
        return awq_matmul_experts_ref(x, qweight, scales, zeros, group_size,
                                      compute_dtype, input_scale=input_scale,
                                      out_dtype=out_dtype)
    _check(x.dim() == 3 and qweight.dim() == 3
           and qweight.shape[0] == x.shape[0],
           "x must be [E, M, K] beside a qweight of E experts")
    return _launch_matmul(x, qweight, scales, zeros, group_size,
                          compute_dtype, input_scale, out_dtype)


def awq_gateup_ref(x: torch.Tensor, qw_gate: torch.Tensor,
                   s_gate: torch.Tensor, z_gate: torch.Tensor,
                   qw_up: torch.Tensor, s_up: torch.Tensor,
                   z_up: torch.Tensor, group_size: int,
                   compute_dtype: torch.dtype = torch.float32, *,
                   input_scales: tuple[torch.Tensor, torch.Tensor] | None = None,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `awq_gateup` (the rule is stated there), built on
    `awq_matmul_ref`: ``silu(x @ Wg) * (x @ Wu) -> [M, N]``."""
    sg, su = input_scales if input_scales is not None else (None, None)
    g = awq_matmul_ref(x, qw_gate, s_gate, z_gate, group_size,
                       compute_dtype, input_scale=sg, out_dtype=out_dtype)
    u = awq_matmul_ref(x, qw_up, s_up, z_up, group_size,
                       compute_dtype, input_scale=su, out_dtype=out_dtype)
    return F.silu(g) * u


def _launch_gateup(x, weights, group_size, compute_dtype, input_scales,
                   out_dtype) -> torch.Tensor:
    """One K3 launch over x ``[E, M, K]`` and E stacked gate/up pairs
    (E = 1: one GLU front, weights without the leading dim)."""
    chk = _checker("awq_gateup")
    vectors = [] if input_scales is None else list(input_scales)
    chk(len(vectors) in (0, 2), "input_scales takes (gate, up) vectors")
    e, m, k, n = _check_launch(chk, x, weights, vectors, group_size,
                               compute_dtype, out_dtype)
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    if m == 0 or e == 0:
        return out
    lib = load("awq_gateup")
    (qg, sg, zg), (qu, su, zu) = weights
    isg, isu = (v.data_ptr() for v in vectors) if vectors else (None, None)
    err = lib.awq_gateup_f32(
        x.data_ptr(), qg.data_ptr(), sg.data_ptr(), zg.data_ptr(),
        qu.data_ptr(), su.data_ptr(), zu.data_ptr(), isg, isu, out.data_ptr(),
        int(x.dtype == torch.float32), int(out_dtype == torch.bfloat16),
        m, k, n, group_size, e, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "awq_gateup")
    GATEUP_COUNTER.count += 1
    if qg.dim() == 3:
        GATEUP_EXPERT_COUNTER.count += 1
    return out


def awq_gateup(x: torch.Tensor, qw_gate: torch.Tensor, s_gate: torch.Tensor,
               z_gate: torch.Tensor, qw_up: torch.Tensor, s_up: torch.Tensor,
               z_up: torch.Tensor, group_size: int,
               compute_dtype: torch.dtype = torch.bfloat16, *,
               input_scales: tuple[torch.Tensor, torch.Tensor] | None = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fused GLU front ``silu(x @ Wg) * (x @ Wu)``: x [M, K] -> [M, N].

    Both weights are packed at the same group size and N. The rule:
    each product is ``awq_matmul`` of ``x`` — times that linear's per-K
    ``input_scales`` entry in f32 where they are given, as
    `qlinear_apply` scales it — rounded to ``compute_dtype`` (f32
    accumulation); ``g`` and ``u`` are then rounded to ``out_dtype``, and
    ``silu(g) * u`` is taken in ``out_dtype`` (each op in f32, rounded to
    ``out_dtype``). With ``out_dtype=float32`` and no input scales this
    is the TPU kernel's function; with the activations' dtype and the
    two linears' input scales it rounds exactly as the two-`linear` MLP
    does, so fusing changes only the order of the sums.

    CPU tensors take `awq_gateup_ref`; CUDA tensors launch the kernel,
    which takes bf16 or f32 x, ``compute_dtype=bfloat16`` and an f32 or
    bf16 output, and raises on anything else. The kernel runs on tensor
    cores under one summation rule for every M: K in spans of 128, each
    span a chain of m16n8k16 MMAs (the dequantized weight as A, the
    scaled x as B) from 0, the span partials added in span order. So a
    row's bits do not depend on M or on the run, and g and u are K1's
    totals for the two weights. M <= 16 streams the weights once (bytes
    bound it); larger M dequantizes a 64-column weight tile once for 64
    or 128 rows and scales their x once, in shared memory (operations
    bound it). `csrc/awq_common.cuh` states the rule in full.
    """
    if plain(x):
        return awq_gateup_ref(x, qw_gate, s_gate, z_gate, qw_up, s_up, z_up,
                              group_size, compute_dtype,
                              input_scales=input_scales, out_dtype=out_dtype)
    _checker("awq_gateup")(x.dim() == 2, "x must be [M, K]")
    return _launch_gateup(x[None], [(qw_gate, s_gate, z_gate),
                                    (qw_up, s_up, z_up)], group_size,
                          compute_dtype, input_scales, out_dtype)[0]


def awq_gateup_experts_ref(x: torch.Tensor, qw_gate: torch.Tensor,
                           s_gate: torch.Tensor, z_gate: torch.Tensor,
                           qw_up: torch.Tensor, s_up: torch.Tensor,
                           z_up: torch.Tensor, group_size: int,
                           compute_dtype: torch.dtype = torch.float32, *,
                           input_scales: tuple[torch.Tensor, torch.Tensor]
                           | None = None,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain version of `awq_gateup_experts`: `awq_gateup_ref` on each
    expert in turn (one expert's dense pair live at a time)."""
    return torch.stack([awq_gateup_ref(
        x[e], qw_gate[e], s_gate[e], z_gate[e], qw_up[e], s_up[e], z_up[e],
        group_size, compute_dtype,
        input_scales=None if input_scales is None
        else (input_scales[0][e], input_scales[1][e]),
        out_dtype=out_dtype) for e in range(x.shape[0])])


def awq_gateup_experts(x: torch.Tensor, qw_gate: torch.Tensor,
                       s_gate: torch.Tensor, z_gate: torch.Tensor,
                       qw_up: torch.Tensor, s_up: torch.Tensor,
                       z_up: torch.Tensor, group_size: int,
                       compute_dtype: torch.dtype = torch.bfloat16, *,
                       input_scales: tuple[torch.Tensor, torch.Tensor]
                       | None = None,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """K3 over a MoE layer's stacked experts: x ``[E, M, K]`` and expert
    e's gate / up pair (each ``[E, ...]`` as in `awq_matmul_experts`) ->
    ``[E, M, N]``, each slice under `awq_gateup`'s rule.

    CPU tensors take `awq_gateup_experts_ref`; CUDA tensors make one
    launch for all E experts, whose slice e is bit-equal to `awq_gateup`
    on expert e alone. `GATEUP_EXPERT_COUNTER` counts these launches
    besides `GATEUP_COUNTER` (a call with no rows counts nothing).
    """
    if plain(x):
        return awq_gateup_experts_ref(x, qw_gate, s_gate, z_gate, qw_up,
                                      s_up, z_up, group_size, compute_dtype,
                                      input_scales=input_scales,
                                      out_dtype=out_dtype)
    _checker("awq_gateup")(x.dim() == 3 and qw_gate.dim() == 3
                           and qw_gate.shape[0] == x.shape[0],
                           "x must be [E, M, K] beside E gate/up pairs")
    return _launch_gateup(x, [(qw_gate, s_gate, z_gate), (qw_up, s_up, z_up)],
                          group_size, compute_dtype, input_scales, out_dtype)
