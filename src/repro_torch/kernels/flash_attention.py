"""K4: tiled online-softmax attention, forward (`csrc/flash_attention.cu`).

Port of the reference's Pallas kernel `flash_attention` and its oracle
`ref.flash_attention_ref`: full-sequence attention with GQA (query head
h reads kv head h // G), a causal and/or sliding-window mask, f32 math
whatever the input type, and the output in q's type. `flash_attention`
launches the hand-written CUDA kernel for CUDA tensors and takes the
plain version, `flash_attention_ref`, only for CPU tensors (and ``meta``
tensors, whose shapes the dry run reads). Any S works
(the TPU kernel needs S to be a multiple of its blocks; this one masks
the ragged tail itself), and inputs are read through their strides, so
a ``[B, S, H, hd]`` projection can be passed as its ``transpose(1, 2)``
view without a copy; the output takes q's layout. bf16 and f16 run on
tensor cores, f32 (which only tests pass) on the CUDA cores. Every row
of this square attention sees at least its own key; a row that saw none
would give exactly 0 in both versions, as in the reference.

Training differentiates it. The reference has no custom gradient (XLA
differentiates its jnp attention); here `FlashAttentionFn` is a
`torch.autograd.Function` whose forward is K4 with each row's
log-sum-exp (``lse``) as a second output and whose backward is K4b
(`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``): it recomputes
the probabilities from ``lse`` and returns dq, dk and dv. For bf16 and
f16 its five products run on tensor cores in two launches (dQ with
``D = rowsum(dO ∘ O)``, then dK / dV with GQA's group summed inside the
kernel), f32 on the CUDA cores in three; no atomics, so two calls give
the same bits. Its plain version, `flash_attention_bwd_ref`, is the same
formula in PyTorch. `flash_attention` goes through the Function when
grad is enabled and an input requires it; serving, under
``torch.no_grad``, launches the bare forward. On CPU tensors both
directions take their plain versions; on CUDA tensors they launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import LaunchCounter, check, load, plain
from repro_torch.numerics import einsum_f32

COUNTER = LaunchCounter()
# K4b's calls (each two launches for bf16 / f16: dQ and D, then dK / dV;
# three for f32: D, dK / dV, dQ)
BWD_COUNTER = LaunchCounter()
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 80, 96, 128, 256)  # head dims K4 is built for
BWD_HEAD_DIMS = HEAD_DIMS           # ... and K4b


def visibility(s: int, *, causal: bool, window: int,
               device=None) -> torch.Tensor:
    """``[S, S]`` bool: query row i may see key j."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(q, k, scale, causal, window):
    """Masked f32 scores ``[B, Hkv, G, S, S]`` (NEG_INF where not visible)
    and the ``[1, 1, 1, S, S]`` mask."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, hd)
    sc = einsum_f32("bkgqd,bksd->bkgqs", qg, k) * scale
    mask = visibility(s, causal=causal, window=window,
                      device=q.device)[None, None, None]
    return torch.where(mask, sc, torch.full_like(sc, NEG_INF)), mask


def _plain(q, k, v, scale, causal, window):
    """(output in q's dtype, masked scores, mask) of the plain version."""
    b, h, s, hd = q.shape
    sc, mask = _scores(q, k, scale, causal, window)
    p = torch.softmax(sc, dim=-1)
    # a row that sees no key gives 0 (the softmax alone would average v)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    o = einsum_f32("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(b, h, s, hd).to(q.dtype), sc, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain masked-softmax attention: q ``[B, H, S, hd]``, k/v
    ``[B, Hkv, S, hd]`` → ``[B, H, S, hd]`` in q's dtype (f32 math)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _plain(q, k, v, scale, causal, window)[0]


def flash_attention_lse_ref(q, k, v, *, scale: float | None = None,
                            causal: bool = True, window: int = 0):
    """`flash_attention_ref`'s output and each row's log-sum-exp of its
    visible scaled scores, f32 ``[B, H, S]`` (+inf for a row that sees no
    key, whose recomputed probabilities are then 0)."""
    b, h, s, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    out, sc, mask = _plain(q, k, v, scale, causal, window)
    lse = torch.logsumexp(sc, dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, torch.full_like(lse, math.inf))
    return out, lse.reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, scale: float | None = None,
                            causal: bool = True, window: int = 0):
    """Plain K4b: the gradient of `flash_attention_ref` from the forward's
    output ``o`` and ``lse``, by the explicit formula (f32 math):
    ``P = exp(s·scale − lse)`` on visible pairs, ``D = rowsum(dO ∘ O)``,
    ``dS = P ∘ (dO Vᵀ − D)``, ``dV = Pᵀ dO``, ``dK = scale · dSᵀ Q``,
    ``dQ = scale · dS K`` (dK, dV summed over each kv head's group).
    Returns (dq, dk, dv) in the inputs' dtypes."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = scale if scale is not None else hd ** -0.5
    sc, mask = _scores(q, k, scale, causal, window)
    lse_g = lse.reshape(b, hkv, g, s, 1).to(torch.float32)
    p = torch.where(mask, torch.exp(sc - lse_g), torch.zeros_like(sc))
    og = o.reshape(b, hkv, g, s, hd).to(torch.float32)
    dog = do.reshape(b, hkv, g, s, hd).to(torch.float32)
    delta = (dog * og).sum(dim=-1, keepdim=True)
    dp = einsum_f32("bkgqd,bksd->bkgqs", dog, v)
    ds = p * (dp - delta)
    dv = einsum_f32("bkgqs,bkgqd->bksd", p, dog)
    dk = einsum_f32("bkgqs,bkgqd->bksd", ds, q.reshape(b, hkv, g, s, hd)
                    ) * scale
    dq = einsum_f32("bkgqs,bksd->bkgqd", ds, k) * scale
    return (dq.reshape(b, h, s, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous and, unless f32, every row 16-byte aligned
    (pointer and strides): what the tensor-core bodies' copies take."""
    if t.stride(3) != 1:
        return False
    step = 16 // t.element_size()
    return t.dtype == torch.float32 or (
        t.data_ptr() % 16 == 0 and all(st % step == 0 for st in t.stride()[:3]))


def _check_rows(tensors) -> None:
    for t, name in tensors:
        _check(t.stride(3) == 1, f"{name}'s head dim must be contiguous")
        _check(_rows_aligned(t), f"{name}'s rows must be 16-byte aligned")


def _check_qkv(q, k, v, head_dims=HEAD_DIMS) -> None:
    """What both CUDA kernels take: q, k and v of one type among f32 /
    bf16 / f16 on one card, a head dim the kernel is built for
    (``head_dims``: K4's `HEAD_DIMS`, K4b's `BWD_HEAD_DIMS`), H a
    multiple of Hkv."""
    b, h, s, hd = q.shape
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _check(hd in head_dims, f"head_dim {hd} (kernel built for "
                            f"{', '.join(map(str, head_dims))})")
    hkv = k.shape[1]
    _check(hkv > 0 and h % hkv == 0, f"H={h} is not a multiple of Hkv={hkv}")
    for t, name in ((k, "k"), (v, "v")):
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")
        _check(tuple(t.shape) == (b, hkv, s, hd),
               f"{name} must be {(b, hkv, s, hd)}, got {tuple(t.shape)}")


def _forward(q, k, v, scale: float, causal: bool, window: int,
             with_lse: bool):
    """Launch K4: (out, lse or None)."""
    b, h, s, hd = q.shape
    _check_qkv(q, k, v)
    _check(window >= 0, f"window must be >= 0, got {window}")
    out = torch.empty_like(q)             # q's layout (strides) and type
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _check_rows(((q, "q"), (k, "k"), (v, "v"), (out, "out")))
    if out.numel() == 0:
        return out, lse
    lib = load("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, k.shape[1], s, hd, _DTYPES[q.dtype], int(causal), int(window),
        float(scale), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention")
    COUNTER.count += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float | None = None,
                        causal: bool = True, window: int = 0):
    """K4b: (dq, dk, dv) of `flash_attention` at (q, k, v), given its
    output ``o``, its ``lse`` (f32 ``[B, H, S]``) and the output's gradient
    ``do``. CPU tensors take `flash_attention_bwd_ref`; CUDA tensors launch
    ``csrc/flash_attention_bwd.cu`` (hd 32, 64, 80, 96, 128 or 256; o and
    do of q's type and shape, every operand's head dim contiguous and,
    for bf16 / f16, every row of all eight operands 16-byte aligned) and
    raise on anything else: bf16 and
    f16 on tensor cores in two launches, f32 on the CUDA cores in three.
    The gradients take their inputs' layouts and types."""
    b, h, s, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    if plain(q):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                       causal=causal, window=window)
    _check_qkv(q, k, v, BWD_HEAD_DIMS)
    for t, name in ((o, "o"), (do, "do")):
        _check(t.device == q.device and t.dtype == q.dtype
               and t.shape == q.shape, f"{name} must match q")
    _check(lse.dtype == torch.float32 and lse.is_contiguous()
           and tuple(lse.shape) == (b, h, s),
           "lse must be a contiguous f32 [B, H, S]")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    operands = (q, k, v, o, do, dq, dk, dv)
    _check_rows(zip(operands, ("q", "k", "v", "o", "do", "dq", "dk", "dv")))
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(st for t in operands
                                         for st in t.stride()[:3]))
    lib = load("flash_attention_bwd")
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, b, h, k.shape[1], s, hd,
        _DTYPES[q.dtype], int(causal), int(window), float(scale),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_bwd")
    BWD_COUNTER.count += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K4 forward (with ``lse``), K4b backward; the plain versions of both
    on CPU tensors. Nothing falls back: a CUDA launch that fails raises."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int):
        if plain(q):
            out, lse = flash_attention_lse_ref(q, k, v, scale=scale,
                                               causal=causal, window=window)
        else:
            out, lse = _forward(q, k, v, scale, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or (do.device.type == "cuda"
                                  and not _rows_aligned(do)):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q ``[B, H, S, hd]``, k/v ``[B, Hkv, S, hd]`` → ``[B, H, S, hd]``.

    CPU tensors take `flash_attention_ref`; CUDA tensors launch the
    kernel (q, k and v of one type among f32 / bf16 / f16, hd 32, 64, 80, 96,
    128 or 256, the head dim contiguous) and raise on anything else. bf16 and f16
    run on tensor cores, whose 16-byte copies want every row 16-byte
    aligned (pointer and strides); f32 runs on the CUDA cores. With grad
    enabled and an input that requires it, the call goes through
    `FlashAttentionFn` (K4b in the backward).
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, scale, causal, window)
    if plain(q):
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window)
    return _forward(q, k, v, scale, causal, window, False)[0]
