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

import torch

from repro_torch.core.packing import PackedLinear, dequantize_packed
from repro_torch.models import layers
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


def _project_q(p, x, cfg, positions, name):
    """x [..., D] -> (q_nope [..., H, nope], q_rope [..., H, rope] rope'd)."""
    nm = (lambda s: None) if name is None else name
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = linear(p["q_proj"], x, nm("q_proj"))
    q = q.reshape(*x.shape[:-1], cfg.num_heads, nope + rope)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    return q[..., :nope], apply_rope(q[..., nope:], cos, sin, rope)


def _project_latent(p, x, cfg, positions, name):
    """x -> (c_kv [..., r] after kv_norm, k_pe [..., rope] rope'd, one per
    token, shared by the heads)."""
    nm = (lambda s: None) if name is None else name
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ckv = linear(p["kv_down"], x, nm("kv_down"))
    c = rmsnorm(p["kv_norm"], ckv[..., :r], eps=cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    k_pe = apply_rope(ckv[..., r:][..., None, :], cos, sin, rope)[..., 0, :]
    return c, k_pe


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
    p0 = ps[0]

    def col(key, inp, k, width):
        return linear_tp([p[key] for p in ps], inp, devices, k, width)

    ckv = gathered(col("kv_down", x, d, r + rope), devices)
    c = rmsnorm(p0["kv_norm"], ckv[..., :r], eps=cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    k_pe = apply_rope(ckv[..., r:][..., None, :], cos, sin, rope)[..., 0, :]
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


def mla_decode(p, cache, x, cfg, *, pos, name=None):
    """Absorbed single-token decode. x [B, D], pos [B] -> (y, cache); the
    token's latent is written at ``pos`` of its row, in place, and every
    position ``<= pos`` of the row is attended."""
    b = x.shape[0]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h, r, vdim = cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
    q_nope, q_rope = _project_q(p, x, cfg, pos, name)          # [B, H, *]
    c1, kpe1 = _project_latent(p, x, cfg, pos, name)           # [B, r/rope]
    bidx = torch.arange(b, device=x.device)
    ckv, kpe = cache["ckv"], cache["kpe"]
    ckv[bidx, pos.long()] = c1.to(ckv.dtype)
    kpe[bidx, pos.long()] = kpe1.to(kpe.dtype)

    # W_UK absorbed into the query: q_abs[h, r] = q_nope[h, :] · W_UK[r, h, :]
    pk = p["kv_up"]
    if isinstance(pk, PackedLinear):
        # quantized serving: each block (the W_UK columns for the query,
        # the W_UV columns after attention) dequantized where it is used,
        # so one block's dense weight is live at a time; the effective
        # weight is diag(input_scale) @ dequant
        def up_block(sl, width):
            blk = _packed_col_block(pk, h, nope + vdim, sl)
            w = dequantize_packed(blk, torch.float32) * pk.input_scale[:, None]
            return w.reshape(r, h, width)

        w_uk = up_block(slice(None, nope), nope)
        w_uv = lambda: up_block(slice(nope, None), vdim)  # noqa: E731
    else:
        w_up = pk["w"].reshape(r, h, nope + vdim)
        w_uk = w_up[..., :nope]
        w_uv = lambda: w_up[..., nope:]  # noqa: E731
    # From here to `out` in f64, rounded once to f32 at the end
    # (`numerics.einsum_f64`): a row's bits then depend neither on how many
    # slots the step holds nor on the cache's length (an engine's slots
    # and generate()'s cache differ in length), on the card as on the CPU.
    q_abs = einsum_f64("bhd,rhd->bhr", q_nope, w_uk)
    ckv64 = ckv.to(torch.float64)

    scale = (nope + rope) ** -0.5
    scores = einsum_f64("bhr,bsr->bhs", q_abs, ckv64)
    scores = (scores + einsum_f64("bhd,bsd->bhs", q_rope, kpe)) * scale
    k_pos = torch.arange(ckv.shape[1], device=x.device)[None, :]
    seen = (k_pos <= pos[:, None].long())[:, None, :]
    scores = torch.where(seen, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    ctx = einsum_f64("bhs,bsr->bhr", probs, ckv64)
    out = einsum_f64("bhr,rhd->bhd", ctx, w_uv()).to(torch.float32)
    nm = (lambda s_: None) if name is None else name
    y = linear(p["wo"], out.reshape(b, h * vdim).to(x.dtype), nm("wo"))
    return y, cache
