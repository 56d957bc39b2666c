"""Multi-head Latent Attention (DeepSeek-V2) with absorbed decode.

Train/prefill uses the explicit form (latent -> per-head K/V expansion).
Decode uses the **absorbed** form of the DeepSeek-V2 paper (arXiv:
2405.04434 §2.1.2): the per-head up-projections W_UK / W_UV are folded
into the query and output sides, so the cache stays in the compressed
latent space, ``[B, S, kv_lora + rope_dim]`` instead of ``[B, S, H,
2·hd]`` (for deepseek-v2-lite 576 against 16 · (192 + 128) = 5,120
values a token).

As in the reference, the attention products are plain tensor code (their
q·k width, 192, is not their v width, 128: kernel K4 does not apply),
computed in f32 (`numerics.einsum_f32`) for prefill and in f64 rounded
once to f32 (`numerics.einsum_f64`) for decode, whose rows must not
depend on the step's slots or the cache's length; the projections go
through `layers.linear`, so a quantized model runs them on K1. The
latent cache is per-slot state: a serving engine keeps it dense beside
the page pools and serves the model on the one-shot path. Caches update
in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packing import PackedLinear, dequantize_packed
from repro_torch.distributed.sharding import concat, split
from repro_torch.models import layers
from repro_torch.models.attention import _fill_stripes, _write_row
from repro_torch.models.layers import (apply_rope, gathered, linear,
                                      linear_tp, rmsnorm, rope_cos_sin)
from repro_torch.numerics import einsum_f32, einsum_f64


def mla_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h, r, vdim = cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q_proj": layers.linear_init(gen, d, h * (nope + rope), **kw),
        "kv_down": layers.linear_init(gen, d, r + rope, **kw),
        "kv_norm": layers.norm_init(r, **kw),
        "kv_up": layers.linear_init(gen, r, h * (nope + vdim), **kw),
        "wo": layers.linear_init(gen, h * vdim, d, **kw),
    }


def _project_latent(p, x, cfg, positions, name):
    """x -> (c_kv [..., r] after kv_norm, k_pe [..., rope] rope'd, one per
    token, shared by the heads)."""
    nm = (lambda s: None) if name is None else name
    return _latent(p["kv_norm"], linear(p["kv_down"], x, nm("kv_down")), cfg,
                   positions)


def _latent(norm_p, ckv, cfg, positions):
    """``kv_down``'s output ``[..., r + rope]`` -> (c_kv normed, k_pe
    rope'd)."""
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    c = rmsnorm(norm_p, ckv[..., :r], eps=cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    k_pe = apply_rope(ckv[..., r:][..., None, :], cos, sin, rope)[..., 0, :]
    return c, k_pe


def project_latent_tp(ps: list, x, cfg, positions, devices: list):
    """`_project_latent` under a ``model`` mesh: ``kv_down``'s column
    stripes (they cross the latent / rope boundary: 576 -> 288 a shard at
    deepseek-v2-lite's width) joined, then normed (``kv_norm``, the first
    shard's copy) and roped once, on the first shard."""
    ckv = gathered(linear_tp([p["kv_down"] for p in ps], x, devices,
                             cfg.d_model, cfg.kv_lora_rank
                             + cfg.qk_rope_head_dim), devices)
    return _latent(ps[0]["kv_norm"], ckv, cfg, positions)


def _attend(q, kv, k_pe, positions, heads: int, cfg) -> torch.Tensor:
    """The explicit form's attention over ``heads`` heads: q [B, S,
    heads·(nope + rope)] (before RoPE), kv [B, S, heads·(nope + vdim)],
    k_pe [B, S, rope] (shared by the heads) -> [B, S, heads·vdim]. Queries
    are taken ``attn_chunk`` at a time where S is a multiple of it, as the
    reference scans them (a row's result does not depend on the
    chunking)."""
    b, s = q.shape[:2]
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    q = q.reshape(b, s, heads, nope + rope)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    q_nope, q_rope = q[..., :nope], apply_rope(q[..., nope:], cos, sin, rope)
    kv = kv.reshape(b, s, heads, nope + vdim)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    scale = (nope + rope) ** -0.5

    def attend(qn, qr, qpos):
        sc = einsum_f32("bqhd,bshd->bhqs", qn, k_nope)
        sc = (sc + einsum_f32("bqhd,bsd->bhqs", qr, k_pe)) * scale
        mask = positions[:, None, :] <= qpos[:, :, None]
        sc = torch.where(mask[:, None], sc, torch.full_like(sc, -1e30))
        pr = torch.softmax(sc, dim=-1).to(v.dtype)
        return einsum_f32("bhqs,bshd->bqhd", pr, v).to(v.dtype)

    chunk = cfg.attn_chunk
    if s > chunk and s % chunk == 0:
        out = torch.cat([attend(q_nope[:, i:i + chunk], q_rope[:, i:i + chunk],
                                positions[:, i:i + chunk])
                         for i in range(0, s, chunk)], dim=1)
    else:
        out = attend(q_nope, q_rope, positions)
    return out.reshape(b, s, heads * vdim)


def mla_attention(p, x, cfg, *, positions, name=None) -> torch.Tensor:
    """Train/prefill MLA (explicit form). x [B, S, D] -> [B, S, D]."""
    nm = (lambda s_: None) if name is None else name
    q = linear(p["q_proj"], x, nm("q_proj"))
    c, k_pe = _project_latent(p, x, cfg, positions, name)
    kv = linear(p["kv_up"], c, nm("kv_up"))
    out = _attend(q, kv, k_pe, positions, cfg.num_heads, cfg)
    return linear(p["wo"], out, nm("wo"))


def mla_attention_tp(ps: list, x, cfg, *, devices: list, positions
                     ) -> torch.Tensor:
    """`mla_attention` over a ``model`` mesh's shards (``ps``: one layer's
    MLA params a shard). ``kv_down``'s column stripes (they cross the
    latent / rope boundary: 576 -> 288 a shard at deepseek-v2-lite's
    width) are joined, then normed (``kv_norm``, the first shard's copy)
    and roped once; ``q_proj`` and ``kv_up`` run column-parallel, and
    where their stripes hold whole heads (both are head-major) each shard
    attends over its own heads, else the stripes are joined and the
    heads attend on the first shard; ``wo`` is row-parallel
    (`layers.linear_tp`). The attention products stay tensor code, as
    `mla_attention`'s. x [B, S, D] replicated -> [B, S, D] replicated."""
    n = len(devices)
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.kv_lora_rank
    vdim = cfg.v_head_dim

    def col(key, inp, k, width):
        return linear_tp([p[key] for p in ps], inp, devices, k, width)

    c, k_pe = project_latent_tp(ps, x, cfg, positions, devices)
    q = col("q_proj", x, d, h * (nope + rope))
    kv = col("kv_up", c, r, h * (nope + vdim))
    if h % n == 0 and isinstance(q, list) and isinstance(kv, list):
        outs = [_attend(qs, kvs, k_pe.to(dv), positions.to(dv), h // n, cfg)
                for qs, kvs, dv in zip(q, kv, devices)]
    else:
        outs = _attend(gathered(q, devices), gathered(kv, devices), k_pe,
                       positions, h, cfg)
    return gathered(linear_tp([p["wo"] for p in ps], outs, devices,
                              h * vdim, d), devices)


# ---------------------------------------------------------------------------
# Decode (absorbed) + latent cache
# ---------------------------------------------------------------------------

def init_mla_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                               dtype=dtype, device=device)}


def fill_mla_cache_from_prefill(cache, c, k_pe):
    """The prefill's latents [B, S, *] into positions 0..S-1, in place."""
    s = c.shape[1]
    cache["ckv"][:, :s] = c.to(cache["ckv"].dtype)
    cache["kpe"][:, :s] = k_pe.to(cache["kpe"].dtype)
    return cache


def _packed_col_block(pl: PackedLinear, heads: int, width: int,
                      sl: slice) -> PackedLinear:
    """Per-head column block of a packed ``[r, heads * width]`` linear,
    without dequantizing: qweight, scales and zeros all carry N in their
    last dim, so slicing output columns commutes with the int4 packing
    along K."""
    def take(a):
        return a.reshape(a.shape[0], heads, width)[..., sl].reshape(
            a.shape[0], -1)

    return PackedLinear(take(pl.qweight), take(pl.scales), take(pl.zeros),
                        pl.input_scale, None, pl.group_size)


def fill_mla_cache_from_prefill_tp(cache, c, k_pe, positions):
    """`fill_mla_cache_from_prefill` into a placed latent cache: striped
    along S (lists), each stripe receives its own positions
    (`attention._fill_stripes`), else whole on the first shard."""
    if isinstance(cache["ckv"], list):
        _fill_stripes(cache, {"ckv": c, "kpe": k_pe}, positions, 0)
        return cache
    return fill_mla_cache_from_prefill(cache, c, k_pe)


def _up_blocks(pk, heads: int, cfg):
    """``kv_up`` ``[r, heads·(nope + vdim)]`` as its absorbed blocks:
    (W_UK ``[r, heads, nope]``, a function giving W_UV ``[r, heads,
    vdim]``). A `PackedLinear` is dequantized block by block where each
    is used, so one block's dense weight is live at a time; its
    effective weight is ``diag(input_scale) @ dequant``."""
    nope, vdim, r = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    if isinstance(pk, PackedLinear):
        def up_block(sl, width):
            blk = _packed_col_block(pk, heads, nope + vdim, sl)
            w = dequantize_packed(blk, torch.float32) * pk.input_scale[:, None]
            return w.reshape(r, heads, width)
        return (up_block(slice(None, nope), nope),
                lambda: up_block(slice(nope, None), vdim))
    w_up = pk["w"].reshape(r, heads, nope + vdim)
    return w_up[..., :nope], lambda: w_up[..., nope:]


def _absorbed_q(q, pk, heads: int, cfg, pos):
    """A q projection ``[B, heads·(nope + rope)]`` -> (q_abs ``[B, heads,
    r]`` f64: W_UK absorbed, q_rope ``[B, heads, rope]`` rope'd, W_UV's
    function)."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = q.reshape(q.shape[0], heads, nope + rope)
    cos, sin = rope_cos_sin(pos, rope, cfg.rope_theta)
    w_uk, w_uv = _up_blocks(pk, heads, cfg)
    return (einsum_f64("bhd,rhd->bhr", q[..., :nope], w_uk),
            apply_rope(q[..., nope:], cos, sin, rope), w_uv)


def mla_decode(p, cache, x, cfg, *, pos, name=None):
    """Absorbed single-token decode. x [B, D], pos [B] -> (y, cache); the
    token's latent is written at ``pos`` of its row, in place, and every
    position ``<= pos`` of the row is attended."""
    b = x.shape[0]
    nm = (lambda s_: None) if name is None else name
    h, vdim = cfg.num_heads, cfg.v_head_dim
    q = linear(p["q_proj"], x, nm("q_proj"))
    c1, kpe1 = _project_latent(p, x, cfg, pos, name)           # [B, r/rope]
    bidx = torch.arange(b, device=x.device)
    ckv, kpe = cache["ckv"], cache["kpe"]
    ckv[bidx, pos.long()] = c1.to(ckv.dtype)
    kpe[bidx, pos.long()] = kpe1.to(kpe.dtype)
    # W_UK absorbed into the query: q_abs[h, r] = q_nope[h, :] · W_UK[r, h, :]
    q_abs, q_rope, w_uv = _absorbed_q(q, p["kv_up"], h, cfg, pos)
    ctx = _latent_read(q_abs, q_rope, ckv, kpe, pos, cfg)
    out = einsum_f64("bhr,rhd->bhd", ctx, w_uv()).to(torch.float32)
    y = linear(p["wo"], out.reshape(b, h * vdim).to(x.dtype), nm("wo"))
    return y, cache


def _latent_read(q_abs, q_rope, ckv, kpe, pos, cfg) -> torch.Tensor:
    """The absorbed read of one whole latent cache -> ctx ``[B, H, r]``
    f64. From q_abs to the output everything stays in f64, rounded once
    to f32 after W_UV (`numerics.einsum_f64`): a row's bits then depend
    neither on how many slots the step holds nor on the cache's length
    (an engine's slots and generate()'s cache differ in length), on the
    card as on the CPU."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    ckv64 = ckv.to(torch.float64)
    scores = einsum_f64("bhr,bsr->bhs", q_abs, ckv64)
    scores = (scores + einsum_f64("bhd,bsd->bhs", q_rope, kpe)) * scale
    k_pos = torch.arange(ckv.shape[1], device=ckv.device)[None, :]
    seen = (k_pos <= pos[:, None].long())[:, None, :]
    scores = torch.where(seen, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return einsum_f64("bhs,bsr->bhr", probs, ckv64)


def _latent_read_striped(q_abs, q_rope, ckvs: list, kpes: list, pos, cfg
                         ) -> torch.Tensor:
    """`_latent_read` over latents striped along S (one stripe a ``model``
    shard, on its device): each stripe scores its own positions in f64
    and keeps its partial max m_i, sum l_i and unnormalized context o_i;
    the partials are joined on the first stripe's device (`concat`) and
    combined in shard order, ``Σ o_i e^(m_i − M) / Σ l_i e^(m_i − M)``,
    still in f64. A stripe that holds no seen position adds nothing."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    devices = [t.device for t in ckvs]
    n_s = ckvs[0].shape[1]
    ms, ls, os_ = [], [], []
    for i, (ckv, kpe) in enumerate(zip(ckvs, kpes)):
        d = ckv.device
        ckv64 = ckv.to(torch.float64)
        scores = einsum_f64("bhr,bsr->bhs", q_abs.to(d), ckv64)
        scores = (scores + einsum_f64("bhd,bsd->bhs", q_rope.to(d), kpe)) \
            * scale
        k_pos = i * n_s + torch.arange(n_s, device=d)[None, :]
        seen = (k_pos <= pos.to(d)[:, None].long())[:, None, :]
        scores = torch.where(seen, scores, torch.full_like(scores, -1e30))
        m = scores.amax(dim=-1, keepdim=True)
        pr = torch.where(seen, torch.exp(scores - m), torch.zeros_like(scores))
        ms.append(m[None])
        ls.append(pr.sum(dim=-1, keepdim=True)[None])
        os_.append(einsum_f64("bhs,bsr->bhr", pr, ckv64)[None])
    m_all, l_all, o_all = (concat(t, 0, devices) for t in (ms, ls, os_))
    top = m_all.amax(dim=0)
    den = torch.zeros_like(l_all[0])
    acc = torch.zeros_like(o_all[0])
    for i in range(len(ckvs)):                      # shard order
        w = torch.exp(m_all[i] - top)
        den = den + l_all[i] * w
        acc = acc + o_all[i] * w
    return acc / den


def _joined(pks: list, n: int, devices: list):
    """A ``[k, n]`` linear split over N, joined whole on the first shard
    (a `PackedLinear`'s words, scales and zeros gathered over N): the
    absorbed decode contracts each head's whole ``kv_up`` block, which
    stripes that cut heads do not hold. An unsplit one as it is."""
    if layers._kn(pks[0])[1] == n:
        return pks[0]
    if isinstance(pks[0], PackedLinear):
        return dataclasses.replace(pks[0], shards=1, **{
            f: concat([getattr(p, f) for p in pks], -1, devices)
            for f in ("qweight", "scales", "zeros")})
    return {"w": concat([p["w"] for p in pks], -1, devices)}


def mla_decode_tp(ps: list, cache, x, cfg, *, devices: list, pos
                  ) -> torch.Tensor:
    """`mla_decode` under a ``model`` mesh (``ps``: one layer's MLA params
    a shard; ``cache``: its `place_cache` piece, the latents striped
    along S or whole). x [B, D] replicated -> y [B, D] replicated; the
    cache is updated in place.

    The token's latent is projected as in `project_latent_tp` and written
    by the stripe that owns ``pos`` (`attention._write_row`). Where the
    ``q_proj`` / ``kv_up`` stripes hold whole heads, each shard absorbs
    W_UK into its heads' queries; the absorbed ``q_abs`` (f64) and
    ``q_rope`` are joined and handed to every latent stripe
    (`_latent_read_striped`; a whole cache is read on the first shard,
    `_latent_read`). The context's heads go back to their shards for
    W_UV, and ``wo`` runs row-parallel (`layers.linear_tp`). Where the
    stripes do not hold whole heads, the heads run on the first
    shard."""
    n = len(devices)
    b, h = x.shape[0], cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    q = linear_tp([p["q_proj"] for p in ps], x, devices, cfg.d_model,
                  h * (nope + rope))
    split_heads = (h % n == 0 and isinstance(q, list)
                   and layers._kn(ps[0]["kv_up"])[1] < h * (nope + vdim))
    c1, kpe1 = project_latent_tp(ps, x, cfg, pos, devices)
    ckv, kpe = cache["ckv"], cache["kpe"]
    if isinstance(ckv, list):
        _write_row(ckv, c1, pos.long())
        _write_row(kpe, kpe1, pos.long())
    else:
        bidx = torch.arange(b, device=x.device)
        ckv[bidx, pos.long()] = c1.to(ckv.dtype)
        kpe[bidx, pos.long()] = kpe1.to(kpe.dtype)
    if split_heads:
        parts = [_absorbed_q(qs, p["kv_up"], h // n, cfg, pos.to(d))
                 for qs, p, d in zip(q, ps, devices)]
        q_abs = concat([a for a, _, _ in parts], 1, devices)
        q_rope = concat([qr for _, qr, _ in parts], 1, devices)
    else:
        q_abs, q_rope, w_uv = _absorbed_q(gathered(q, devices), _joined(
            [p["kv_up"] for p in ps], h * (nope + vdim), devices), h, cfg,
            pos)
    ctx = (_latent_read_striped(q_abs, q_rope, ckv, kpe, pos, cfg)
           if isinstance(ckv, list)
           else _latent_read(q_abs, q_rope, ckv, kpe, pos, cfg))
    if split_heads:
        outs = [einsum_f64("bhr,rhd->bhd", cs, wv()).to(torch.float32)
                .reshape(b, -1).to(x.dtype)
                for cs, (_, _, wv) in zip(split(ctx, 1, devices), parts)]
    else:
        outs = einsum_f64("bhr,rhd->bhd", ctx, w_uv()).to(
            torch.float32).reshape(b, h * vdim).to(x.dtype)
    return gathered(linear_tp([p["wo"] for p in ps], outs, devices,
                              h * vdim, cfg.d_model), devices)
