"""K4: tiled online-softmax attention, forward (`csrc/flash_attention.cu`).

Port of the reference's Pallas kernel `flash_attention` and its oracle
`ref.flash_attention_ref`: full-sequence attention with GQA (query head
h reads kv head h // G), a causal and/or sliding-window mask, f32 math
whatever the input type, and the output in q's type. `flash_attention`
launches the hand-written CUDA kernel for CUDA tensors and takes the
plain version, `flash_attention_ref`, only for CPU tensors. Any S works
(the TPU kernel needs S to be a multiple of its blocks; this one masks
the ragged tail itself), and inputs are read through their strides, so
a ``[B, S, H, hd]`` projection can be passed as its ``transpose(1, 2)``
view without a copy; the output takes q's layout. bf16 and f16 run on
tensor cores, f32 (which only tests pass) on the CUDA cores. Every row
of this square attention sees at least its own key; a row that saw none
would give exactly 0 in both versions, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check, load
from repro_torch.numerics import einsum_f32

COUNTER = LaunchCounter()
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float | None = None, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain masked-softmax attention: q ``[B, H, S, hd]``, k/v
    ``[B, Hkv, S, hd]`` → ``[B, H, S, hd]`` in q's dtype (f32 math)."""
    b, h, s, hd = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(b, hkv, g, s, hd).to(torch.float32)
    sc = einsum_f32("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * scale
    mask = visibility(s, causal=causal, window=window,
                      device=q.device)[None, None, None]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    # a row that sees no key gives 0 (the softmax alone would average v)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    o = einsum_f32("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(b, h, s, hd).to(q.dtype)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q ``[B, H, S, hd]``, k/v ``[B, Hkv, S, hd]`` → ``[B, H, S, hd]``.

    CPU tensors take `flash_attention_ref`; CUDA tensors launch the
    kernel (q, k and v of one type among f32 / bf16 / f16, hd 64 or 128,
    the head dim contiguous) and raise on anything else. bf16 and f16
    run on tensor cores, whose 16-byte copies want every row 16-byte
    aligned (pointer and strides); f32 runs on the CUDA cores.
    """
    b, h, s, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    _check(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _check(hd in (64, 128), f"head_dim {hd} (kernel built for 64, 128)")
    _check(window >= 0, f"window must be >= 0, got {window}")
    hkv = k.shape[1]
    _check(hkv > 0 and h % hkv == 0, f"H={h} is not a multiple of Hkv={hkv}")
    for t, name in ((k, "k"), (v, "v")):
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")
        _check(tuple(t.shape) == (b, hkv, s, hd),
               f"{name} must be {(b, hkv, s, hd)}, got {tuple(t.shape)}")
    out = torch.empty_like(q)             # q's layout (strides) and type
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _check(t.stride(3) == 1, f"{name}'s head dim must be contiguous")
        if q.dtype != torch.float32:
            step = 16 // t.element_size()
            _check(t.data_ptr() % 16 == 0
                   and all(st % step == 0 for st in t.stride()[:3]),
                   f"{name}'s rows must be 16-byte aligned")
    if out.numel() == 0:
        return out
    lib = load("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, hkv, s, hd, _DTYPES[q.dtype], int(causal), int(window),
        float(scale), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention")
    COUNTER.count += 1
    return out
