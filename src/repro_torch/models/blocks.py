"""Transformer block assembly: mixer (attn / MLA) + MLP (glu / plain /
moe), pre-norm residual wiring, per-kind caches.

`block_apply` is mode-polymorphic, as in the reference:
  * mode="train"   — full-sequence forward, no cache.
  * mode="prefill" — full-sequence forward, fills the dense decode cache
    (K/V, or MLA's latents).
  * mode="decode"  — single token [B, D] against the dense cache, or
    against the page pools when the cache holds ``kv_pool`` (the one-shot
    engine's decode step; ``page_table`` routes its reads and writes; an
    MLA layer's latents stay dense per slot beside them).
  * mode="chunk"   — token-budget block [B, C, D] against the paged pools
    (serving's unified prefill/decode step). Only pure paged-attention
    blocks take it: MLA's latents are per-slot sequential state, served
    on the one-shot path.
The Mamba and Hymba mixers are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind
from repro_torch.core.qlinear import fusable_gateup, qgateup_apply
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import activation, linear, norm


def _mixer(kind: LayerKind) -> str:
    if kind.mixer not in ("attn", "mla"):
        raise NotImplementedError(
            f"block kind {kind.tag!r} is not ported yet (the {kind.mixer} "
            f"mixer)")
    return kind.mixer


def mlp_init(gen, cfg, dtype=torch.float32, device=None):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_type == "glu":
        p["gate"] = layers.linear_init(gen, d, f, dtype=dtype, device=device)
    p["up"] = layers.linear_init(gen, d, f, dtype=dtype, device=device)
    p["down"] = layers.linear_init(gen, f, d, dtype=dtype, device=device)
    return p


def block_init(gen, cfg, kind: LayerKind, dtype=torch.float32, device=None):
    kw = dict(norm_type=cfg.norm_type, dtype=dtype, plus_one=cfg.rms_plus_one,
              device=device)
    mixer = (attn_mod.attn_init if _mixer(kind) == "attn"
             else mla_mod.mla_init)
    p = {"pre_norm": layers.norm_init(cfg.d_model, **kw),
         "attn": mixer(gen, cfg, dtype, device=device)}
    if kind.mlp != "none":
        p["mlp_norm"] = layers.norm_init(cfg.d_model, **kw)
        if kind.mlp == "moe":
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device=device)
        else:
            p["mlp"] = mlp_init(gen, cfg, dtype, device=device)
    return p


def init_block_cache(cfg, kind: LayerKind, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None):
    if _mixer(kind) == "mla":
        return {"mla": mla_mod.init_mla_cache(cfg, batch, max_seq, dtype,
                                              device=device)}
    return {"kv": attn_mod.init_kv_cache(cfg, batch, max_seq, kind.window,
                                         dtype, device=device)}


def init_block_cache_paged(cfg, kind: LayerKind, num_pages: int,
                           page_size: int, dtype=torch.bfloat16,
                           kv_quant: str | None = None, device=None, *,
                           num_slots: int | None = None,
                           slot_seq: int | None = None):
    """Per-layer serving cache: one shared page pool (``kv_pool``) for an
    attention layer; an MLA layer's latents stay dense, ``[num_slots,
    slot_seq, ...]`` in ``dtype`` (both required for such a layer, which
    the others ignore)."""
    if _mixer(kind) == "mla":
        if num_slots is None or slot_seq is None:
            raise ValueError("an MLA layer's serving cache is dense per "
                             "slot: pass num_slots and slot_seq")
        return {"mla": mla_mod.init_mla_cache(
            cfg, num_slots, slot_seq, dtype, device=device)}
    return {"kv_pool": attn_mod.init_paged_kv_cache(
        cfg, num_pages, page_size, dtype, kv_quant=kv_quant, device=device)}


def _fused_gateup(mp, cfg) -> bool:
    """Whether the dense GLU front runs as one K3 pair
    (`qlinear.fusable_gateup`)."""
    return fusable_gateup(mp["gate"], mp["up"], cfg.act)


def _mlp_apply(p, x, cfg, kind: LayerKind, name=None):
    """The block's dense MLP (glu or plain)."""
    mp = p["mlp"]
    nm = (lambda s: name(f"mlp/{s}")) if name else (lambda s: None)
    if kind.mlp == "glu" and _fused_gateup(mp, cfg):
        h = qgateup_apply(mp["gate"], mp["up"], x)
    elif kind.mlp == "glu":
        h = activation(cfg.act, linear(mp["gate"], x, nm("gate"))) \
            * linear(mp["up"], x, nm("up"))
    else:
        h = activation(cfg.act, linear(mp["up"], x, nm("up")))
    return linear(mp["down"], h, nm("down"))


def _mixer_train(p, h, cfg, kind: LayerKind, positions, name):
    sub = (lambda s: name(f"attn/{s}")) if name else None
    if kind.mixer == "mla":
        return mla_mod.mla_attention(p["attn"], h, cfg, positions=positions,
                                     name=sub)
    return attn_mod.attention(p["attn"], h, cfg, positions=positions,
                              window=kind.window, causal=not cfg.is_encoder,
                              name=sub)


def _prefill_cache(p, h, cfg, kind: LayerKind, positions, cache):
    """Recompute the prefilled tokens' K/V (or latents) into the cache."""
    if kind.mixer == "mla":
        c, k_pe = mla_mod._project_latent(p["attn"], h, cfg, positions, None)
        return {"mla": mla_mod.fill_mla_cache_from_prefill(cache["mla"], c,
                                                           k_pe)}
    _, k, v = attn_mod._project_qkv(p["attn"], h, cfg, positions, kind.window)
    return {"kv": attn_mod.fill_cache_from_prefill(cache["kv"], k, v,
                                                   positions, kind.window)}


def _mixer_decode(p, cache, h, cfg, kind: LayerKind, pos, page_table):
    if kind.mixer == "mla":
        y, mc = mla_mod.mla_decode(p["attn"], cache["mla"], h, cfg, pos=pos)
        return y, {"mla": mc}
    if "kv_pool" in cache:
        y, pool = attn_mod.attention_decode_paged(
            p["attn"], cache["kv_pool"], page_table, h, cfg, pos=pos,
            window=kind.window)
        return y, {"kv_pool": pool}
    y, kv = attn_mod.attention_decode(p["attn"], cache["kv"], h, cfg, pos=pos,
                                      window=kind.window)
    return y, {"kv": kv}


def block_apply(p, x, cfg, kind: LayerKind, *, mode: str, positions=None,
                cache=None, name=None, page_table=None, rpos=None,
                amask=None):
    """Returns (x_out, cache_out, aux_loss: the MoE router's, None for a
    block without one). ``name`` (local path -> capture name, or None)
    labels the block's linears for calibration."""
    h = norm(p["pre_norm"], x, cfg)
    if mode == "decode":
        y, cache = _mixer_decode(p, cache, h, cfg, kind, positions,
                                 page_table)
    elif mode == "chunk":
        if kind.mixer != "attn" or "kv_pool" not in cache:
            raise ValueError(
                f"chunked execution needs a pure paged-attention cache; "
                f"{kind.tag!r} keeps per-slot sequential state: serve it "
                f"through the one-shot prefill path")
        y, pool = attn_mod.attention_chunk_paged(
            p["attn"], cache["kv_pool"], page_table, h, cfg, pos=positions,
            rpos=rpos, amask=amask, window=kind.window)
        cache = {"kv_pool": pool}
    else:
        y = _mixer_train(p, h, cfg, kind, positions, name)
        if mode == "prefill":
            cache = _prefill_cache(p, h, cfg, kind, positions, cache)
    x = x + y
    aux = None
    if kind.mlp == "none":
        return x, cache, aux
    h2 = norm(p["mlp_norm"], x, cfg)
    if kind.mlp == "moe":
        sub = (lambda s: name(f"moe/{s}")) if name else None
        y2, aux = moe_mod.moe_apply(p["moe"], h2, cfg, name=sub)
    else:
        y2 = _mlp_apply(p, h2, cfg, kind, name)
    return x + y2, cache, aux
