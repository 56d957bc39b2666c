"""Transformer block: attention mixer + MLP (glu / plain), pre-norm
residual wiring, per-kind caches.

`block_apply` is mode-polymorphic, as in the reference:
  * mode="train"   — full-sequence forward, no cache.
  * mode="prefill" — full-sequence forward, fills the dense decode cache.
  * mode="decode"  — single token [B, D] against the dense cache, or
    against the page pools when the cache holds ``kv_pool`` (the one-shot
    engine's decode step; ``page_table`` routes its reads and writes).
  * mode="chunk"   — token-budget block [B, C, D] against the paged pools
    (serving's unified prefill/decode step).
Only the ``attn`` mixer is ported (MLA, Mamba and Hymba blocks are not).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind
from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import qgateup_apply
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models.layers import activation, linear, norm


def _attn_only(kind: LayerKind) -> None:
    if kind.mixer != "attn" or kind.mlp not in ("glu", "plain"):
        raise NotImplementedError(
            f"block kind {kind.tag!r} is not ported yet (attn mixer with a "
            f"glu or plain MLP only)")


def mlp_init(gen, cfg, dtype=torch.float32, device=None):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_type == "glu":
        p["gate"] = layers.linear_init(gen, d, f, dtype=dtype, device=device)
    p["up"] = layers.linear_init(gen, d, f, dtype=dtype, device=device)
    p["down"] = layers.linear_init(gen, f, d, dtype=dtype, device=device)
    return p


def block_init(gen, cfg, kind: LayerKind, dtype=torch.float32, device=None):
    _attn_only(kind)
    kw = dict(norm_type=cfg.norm_type, dtype=dtype, plus_one=cfg.rms_plus_one,
              device=device)
    return {"pre_norm": layers.norm_init(cfg.d_model, **kw),
            "attn": attn_mod.attn_init(gen, cfg, dtype, device=device),
            "mlp_norm": layers.norm_init(cfg.d_model, **kw),
            "mlp": mlp_init(gen, cfg, dtype, device=device)}


def init_block_cache(cfg, kind: LayerKind, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None):
    _attn_only(kind)
    return {"kv": attn_mod.init_kv_cache(cfg, batch, max_seq, kind.window,
                                         dtype, device=device)}


def init_block_cache_paged(cfg, kind: LayerKind, num_pages: int,
                           page_size: int, dtype=torch.bfloat16,
                           kv_quant: str | None = None, device=None):
    """Per-layer serving cache: one shared page pool (``kv_pool``)."""
    _attn_only(kind)
    return {"kv_pool": attn_mod.init_paged_kv_cache(
        cfg, num_pages, page_size, dtype, kv_quant=kv_quant, device=device)}


def _fused_gateup(mp, cfg) -> bool:
    """Whether the GLU front runs as one K3 pair: SiLU over two packed,
    bias-free linears of equal K, N and group size (every Qwen2.5 layer
    once quantized; float weights, during calibration, take two linears)."""
    g, u = mp["gate"], mp["up"]
    return (cfg.act == "silu" and isinstance(g, PackedLinear)
            and isinstance(u, PackedLinear) and g.bias is None
            and u.bias is None and g.group_size == u.group_size
            and (g.k, g.n) == (u.k, u.n))


def _mlp_apply(p, x, cfg, kind: LayerKind, name=None):
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


def block_apply(p, x, cfg, kind: LayerKind, *, mode: str, positions=None,
                cache=None, name=None, page_table=None, rpos=None,
                amask=None):
    """Returns (x_out, cache_out). ``name`` (local path → capture name, or
    None) labels the block's linears for calibration."""
    h = norm(p["pre_norm"], x, cfg)
    if mode == "decode" and "kv_pool" in cache:
        y, pool = attn_mod.attention_decode_paged(
            p["attn"], cache["kv_pool"], page_table, h, cfg, pos=positions,
            window=kind.window)
        cache = {"kv_pool": pool}
    elif mode == "decode":
        y, kv = attn_mod.attention_decode(p["attn"], cache["kv"], h, cfg,
                                          pos=positions, window=kind.window)
        cache = {"kv": kv}
    elif mode == "chunk":
        if "kv_pool" not in cache:
            raise ValueError("chunked execution needs a paged-attention cache")
        y, pool = attn_mod.attention_chunk_paged(
            p["attn"], cache["kv_pool"], page_table, h, cfg, pos=positions,
            rpos=rpos, amask=amask, window=kind.window)
        cache = {"kv_pool": pool}
    else:
        sub = (lambda s: name(f"attn/{s}")) if name else None
        y = attn_mod.attention(p["attn"], h, cfg, positions=positions,
                               window=kind.window,
                               causal=not cfg.is_encoder, name=sub)
        if mode == "prefill":
            _, k, v = attn_mod._project_qkv(p["attn"], h, cfg, positions,
                                            kind.window)
            cache = {"kv": attn_mod.fill_cache_from_prefill(
                cache["kv"], k, v, positions, kind.window)}
    x = x + y
    h2 = norm(p["mlp_norm"], x, cfg)
    return x + _mlp_apply(p, h2, cfg, kind, name), cache
