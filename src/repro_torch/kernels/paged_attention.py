"""K2: fused int8 dequant + multi-query paged attention
(`csrc/paged_attention.cu`).

Port of the reference's Pallas kernel `paged_attention_chunk` and its
oracle `ref.paged_attention_chunk_ref` + `ref.chunk_visibility_ref`.

Layout: q ``[B, C, Hkv, G, hd]`` (head = kv_head·G + group), pools
``[N, P, Hkv, hd]`` int8 with f32 scale strips ``[N, P, Hkv]``, page_table
``[B, pages_per_slot]`` int32, pos / rpos ``[B, C]`` int32 (``-1`` =
padding query), amask ``[B, C, C]`` bool. Visibility has three parts:
committed keys (``k < pos[b, 0]``, bounded below by
``k > rpos[b, i] - window`` when windowed), in-span keys
(``pos[b, 0] <= k < pos[b, 0] + C``, visible iff ``amask[b, i, k -
pos[b, 0]]``), and nothing else. Rows that see nothing give exactly 0.
Output ``[B, C, Hkv, G, hd]`` float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LaunchCounter, check, load
from repro_torch.numerics import einsum_f32

NEG_INF = -1e30
COUNTER = LaunchCounter()
_KT = 32                 # keys per tile in the kernel
_SMEM_LIMIT = 227 * 1024


def default_amask(pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Plain-causal ancestor mask for a linear chunk: in-span token j is
    visible to query i iff ``j <= i`` and token j is not padding, with the
    in-span half of any sliding-window bound folded in."""
    c = pos.shape[1]
    ar = torch.arange(c, device=pos.device)
    tri = ar[:, None] >= ar[None, :]
    am = tri[None] & (pos >= 0)[:, None, :]                # [B, C, C]
    if window:
        am = am & (ar[None, None, :] > ar[None, :, None] - window)
    return am


def chunk_visibility_ref(pos: torch.Tensor, *, s_slot: int,
                         rpos: torch.Tensor | None = None,
                         amask: torch.Tensor | None = None,
                         window: int = 0) -> torch.Tensor:
    """Boolean visibility ``[B, C, S_slot]`` of every slot position to every
    in-span query under the three-part rule (see the module docstring)."""
    b, c = pos.shape
    if rpos is None:
        rpos = pos
    if amask is None:
        amask = default_amask(pos, window)
    base = pos[:, 0][:, None, None]                        # [B, 1, 1]
    k_slot = torch.arange(s_slot, device=pos.device)[None, None, :]
    committed = k_slot < base
    if window:
        committed = committed & (k_slot > rpos[:, :, None] - window)
    off = k_slot - base                                    # [B, 1, S]
    in_span = (off >= 0) & (off < c)
    offc = torch.clip(off, 0, c - 1).expand(b, c, s_slot)
    vis_in = torch.gather(amask.to(torch.bool), 2, offc)
    return (pos >= 0)[:, :, None] & (committed | (in_span & vis_in))


def paged_attention_chunk_ref(q, k_pool, ks, v_pool, vs, page_table, pos, *,
                              scale: float | None = None, rpos=None,
                              amask=None, window: int = 0) -> torch.Tensor:
    """Plain version: gather the slot's pages into logical order,
    dequantize in f32, masked softmax with exact-zero empty rows."""
    b, c, hkv, g, hd = q.shape
    page_size = k_pool.shape[1]
    s_slot = page_table.shape[1] * page_size
    scale = scale if scale is not None else hd ** -0.5
    tbl = page_table.long()
    k = (k_pool.float() * ks[..., None].float())[tbl].reshape(b, s_slot,
                                                             hkv, hd)
    v = (v_pool.float() * vs[..., None].float())[tbl].reshape(b, s_slot,
                                                             hkv, hd)
    sc = einsum_f32("bckgd,bskd->bckgs", q, k) * scale
    vis = chunk_visibility_ref(pos, s_slot=s_slot, rpos=rpos, amask=amask,
                               window=window)              # [B, C, S]
    vism = vis[:, :, None, None, :]
    sc = torch.where(vism, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(vism, torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, torch.ones_like(l), l)
    return einsum_f32("bckgs,bskd->bckgd", p, v)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_chunk: {msg}")


def smem_bytes(rows: int, hd: int) -> int:
    """Dynamic shared memory of one block for ``rows = C·G`` query rows."""
    return 4 * (2 * rows * hd + 2 * rows + _KT * (2 * hd + 1) + _KT)


def paged_attention_chunk(q, k_pool, ks, v_pool, vs, page_table, pos, *,
                          scale: float | None = None, rpos=None, amask=None,
                          window: int = 0) -> torch.Tensor:
    """Fused dequant + multi-query masked attention over int8 KV pages.

    CPU tensors take `paged_attention_chunk_ref`; CUDA tensors launch the
    kernel (f32 q, int8 pools, f32 strips, int32 tables / positions, hd 64
    or 128) and raise on anything else.
    """
    b, c, hkv, g, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return paged_attention_chunk_ref(q, k_pool, ks, v_pool, vs,
                                         page_table, pos, scale=scale,
                                         rpos=rpos, amask=amask,
                                         window=window)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    if rpos is None:
        rpos = pos
    if amask is None:
        amask = default_amask(pos, window)
    if amask.dtype == torch.bool:
        amask = amask.view(torch.uint8)
    n_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    n_blocks = page_table.shape[1]
    _check(hd in (64, 128), f"head_dim {hd} (kernel built for 64, 128)")
    _check(smem_bytes(c * g, hd) <= _SMEM_LIMIT,
           f"C·G = {c * g} query rows exceed one block's shared memory")
    for t, name, dtype, shape in (
            (q, "q", torch.float32, (b, c, hkv, g, hd)),
            (k_pool, "k_pool", torch.int8, (n_pages, page_size, hkv, hd)),
            (v_pool, "v_pool", torch.int8, (n_pages, page_size, hkv, hd)),
            (ks, "ks", torch.float32, (n_pages, page_size, hkv)),
            (vs, "vs", torch.float32, (n_pages, page_size, hkv)),
            (page_table, "page_table", torch.int32, (b, n_blocks)),
            (pos, "pos", torch.int32, (b, c)),
            (rpos, "rpos", torch.int32, (b, c)),
            (amask, "amask", torch.uint8, (b, c, c))):
        _check(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _check(tuple(t.shape) == shape,
               f"{name} must be {shape}, got {tuple(t.shape)}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((b, c, hkv, g, hd), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    lib = load("paged_attention")
    err = lib.paged_attention_chunk_f32(
        q.data_ptr(), k_pool.data_ptr(), ks.data_ptr(), v_pool.data_ptr(),
        vs.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
        rpos.data_ptr(), amask.data_ptr(), out.data_ptr(),
        b, c, hkv, g, hd, page_size, n_blocks, n_pages, int(window),
        float(scale), q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_attention_chunk")
    COUNTER.count += 1
    return out


def paged_attention(q, k_pool, ks, v_pool, vs, page_table, pos, *,
                    scale: float | None = None,
                    window: int = 0) -> torch.Tensor:
    """Single-token decode form: q ``[B, Hkv, G, hd]``, pos ``[B]`` →
    ``[B, Hkv, G, hd]`` (the C = 1 case of `paged_attention_chunk`)."""
    out = paged_attention_chunk(q[:, None], k_pool, ks, v_pool, vs,
                                page_table, pos[:, None], scale=scale,
                                window=window)
    return out[:, 0]
