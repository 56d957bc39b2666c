"""Transformer block assembly: mixer (attn / MLA / mamba / hymba) + MLP
(glu / plain / moe / none), pre-norm residual wiring, per-kind caches.

`block_apply` is mode-polymorphic, as in the reference:
  * mode="train"   — full-sequence forward, no cache.
  * mode="prefill" — full-sequence forward, fills the dense decode cache
    (K/V or a windowed layer's ring, MLA's latents, an SSM layer's conv
    caches and state).
  * mode="decode"  — single token [B, D] against the dense cache, or
    against the page pools when the cache holds ``kv_pool`` (the one-shot
    engine's decode step; ``page_table`` routes its reads and writes;
    per-slot state — MLA's latents, SSM states, hymba's windowed rings —
    stays dense per slot beside them).
  * mode="chunk"   — token-budget block [B, C, D] against the paged pools
    (serving's unified prefill/decode step). Only pure paged-attention
    blocks take it: per-slot state is sequential, served on the one-shot
    path.

Hymba (arXiv:2411.13676) blocks run attention and the Mamba-2 SSD branch
in parallel on the same normed input, each branch's output normed again,
then averaged.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LayerKind
from repro_torch.core.qlinear import fusable_gateup, qgateup_apply
from repro_torch.distributed.sharding import model_devices
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import activation, linear, norm


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
    p = {"pre_norm": layers.norm_init(cfg.d_model, **kw)}
    if kind.mixer in ("attn", "hymba"):
        p["attn"] = attn_mod.attn_init(gen, cfg, dtype, device=device)
    elif kind.mixer == "mla":
        p["attn"] = mla_mod.mla_init(gen, cfg, dtype, device=device)
    elif kind.mixer != "mamba":
        raise ValueError(f"unknown mixer {kind.mixer!r}")
    if kind.mixer in ("mamba", "hymba"):
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype, device=device)
    if kind.mixer == "hymba":
        p["attn_out_norm"] = layers.norm_init(cfg.d_model, **kw)
        p["ssm_out_norm"] = layers.norm_init(cfg.d_model, **kw)
    if kind.mlp != "none":
        p["mlp_norm"] = layers.norm_init(cfg.d_model, **kw)
        if kind.mlp == "moe":
            p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device=device)
        else:
            p["mlp"] = mlp_init(gen, cfg, dtype, device=device)
    return p


def init_block_cache(cfg, kind: LayerKind, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None):
    c = {}
    if kind.mixer in ("attn", "hymba"):
        c["kv"] = attn_mod.init_kv_cache(cfg, batch, max_seq, kind.window,
                                         dtype, device=device)
    if kind.mixer == "mla":
        c["mla"] = mla_mod.init_mla_cache(cfg, batch, max_seq, dtype,
                                          device=device)
    if kind.mixer in ("mamba", "hymba"):
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, device=device)
    return c


def init_block_cache_paged(cfg, kind: LayerKind, num_pages: int,
                           page_size: int, dtype=torch.bfloat16,
                           kv_quant: str | None = None, device=None, *,
                           num_slots: int | None = None,
                           slot_seq: int | None = None):
    """Per-layer serving cache. Full attention (an attention layer, global
    or windowed; a hymba global layer) shares one page pool
    (``kv_pool``, in ``kv_quant``'s storage). Bounded per-slot state stays
    dense with the slot as its batch dim: an MLA layer's latents
    ``[num_slots, slot_seq, ...]`` in ``dtype``, a windowed hymba layer's
    ring ``kv`` of ``min(window, slot_seq)`` positions (in the config's
    own KV regime), an SSM layer's conv caches and state (f32). A layer
    with per-slot state needs ``num_slots`` and ``slot_seq`` (it raises
    without them); the others ignore them."""
    if kind.mixer != "attn" and (num_slots is None or slot_seq is None):
        raise ValueError(f"a {kind.tag!r} layer's serving cache keeps "
                         f"per-slot state: pass num_slots and slot_seq")
    c = {}
    if kind.mixer == "attn" or (kind.mixer == "hymba" and not kind.window):
        c["kv_pool"] = attn_mod.init_paged_kv_cache(
            cfg, num_pages, page_size, dtype, kv_quant=kv_quant,
            device=device)
    if kind.mixer == "hymba" and kind.window:
        c["kv"] = attn_mod.init_kv_cache(cfg, num_slots, slot_seq,
                                         kind.window, dtype, device=device)
    if kind.mixer == "mla":
        c["mla"] = mla_mod.init_mla_cache(cfg, num_slots, slot_seq, dtype,
                                          device=device)
    if kind.mixer in ("mamba", "hymba"):
        c["ssm"] = ssm_mod.init_ssm_cache(cfg, num_slots, device=device)
    return c


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


def _hymba_merge(p, ya, ys, cfg):
    """Hymba's fusion: each branch normed on its own, then averaged."""
    return (norm(p["attn_out_norm"], ya, cfg)
            + norm(p["ssm_out_norm"], ys, cfg)) * 0.5


def _mixer_train(p, h, cfg, kind: LayerKind, positions, name):
    def sub(prefix):
        return (lambda s: name(f"{prefix}/{s}")) if name else None

    if kind.mixer == "mla":
        return mla_mod.mla_attention(p["attn"], h, cfg, positions=positions,
                                     name=sub("attn"))
    if kind.mixer == "mamba":
        return ssm_mod.ssm_mixer(p["ssm"], h, cfg, name=sub("ssm"))
    ya = attn_mod.attention(p["attn"], h, cfg, positions=positions,
                            window=kind.window, causal=not cfg.is_encoder,
                            name=sub("attn"))
    if kind.mixer == "attn":
        return ya
    ys = ssm_mod.ssm_mixer(p["ssm"], h, cfg, name=sub("ssm"))
    return _hymba_merge(p, ya, ys, cfg)


def _prefill_cache(p, h, cfg, kind: LayerKind, positions, cache):
    """Recompute the prefilled tokens' K/V (or latents) and, for an SSM
    branch, its conv inputs and final state into the cache (in place;
    its linears run unnamed, outside the calibration capture)."""
    cache = dict(cache)
    if kind.mixer == "mla":
        c, k_pe = mla_mod._project_latent(p["attn"], h, cfg, positions, None)
        cache["mla"] = mla_mod.fill_mla_cache_from_prefill(cache["mla"], c,
                                                           k_pe)
    if kind.mixer in ("attn", "hymba"):
        _, k, v = attn_mod._project_qkv(p["attn"], h, cfg, positions,
                                        kind.window)
        cache["kv"] = attn_mod.fill_cache_from_prefill(
            cache["kv"], k, v, positions, kind.window)
    if kind.mixer in ("mamba", "hymba"):
        cache["ssm"] = ssm_mod.fill_ssm_cache_from_prefill(
            cache["ssm"], p["ssm"], h, cfg)
    return cache


def _attn_decode(p, cache, h, cfg, kind: LayerKind, pos, page_table):
    """Full-attention decode over the page pools (``kv_pool``) or the
    dense cache / ring (``kv``) -> (y, {that key: its cache})."""
    if "kv_pool" in cache:
        y, pool = attn_mod.attention_decode_paged(
            p["attn"], cache["kv_pool"], page_table, h, cfg, pos=pos,
            window=kind.window)
        return y, {"kv_pool": pool}
    y, kv = attn_mod.attention_decode(p["attn"], cache["kv"], h, cfg, pos=pos,
                                      window=kind.window)
    return y, {"kv": kv}


def _mixer_decode(p, cache, h, cfg, kind: LayerKind, pos, page_table):
    if kind.mixer == "mla":
        y, mc = mla_mod.mla_decode(p["attn"], cache["mla"], h, cfg, pos=pos)
        return y, {"mla": mc}
    if kind.mixer == "mamba":
        y, sc = ssm_mod.ssm_decode(p["ssm"], cache["ssm"], h, cfg)
        return y, {"ssm": sc}
    ya, out = _attn_decode(p, cache, h, cfg, kind, pos, page_table)
    if kind.mixer == "attn":
        return ya, out
    ys, out["ssm"] = ssm_mod.ssm_decode(p["ssm"], cache["ssm"], h, cfg)
    return _hymba_merge(p, ya, ys, cfg), out


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


# ---------------------------------------------------------------------------
# Tensor parallelism (the serving engine under a ``model`` mesh)
# ---------------------------------------------------------------------------

def _mlp_apply_tp(ps: list, x, cfg, kind: LayerKind, devices: list):
    """The block's MLP over the shards → (y, the MoE router's aux loss or
    None): a dense MLP through `layers.mlp_tp`, a MoE layer through
    `moe.moe_apply_tp`. Replicated x in and out."""
    if kind.mlp == "moe":
        return moe_mod.moe_apply_tp([p["moe"] for p in ps], x, cfg, devices)
    return layers.mlp_tp([p["mlp"] for p in ps], x, cfg.act, devices,
                         cfg.d_model, cfg.d_ff, glu=kind.mlp == "glu"), None


def _mixer_train_tp(ps: list, h, cfg, kind: LayerKind, devices: list,
                    positions):
    """`_mixer_train` over the shards: attention (`attention.
    attention_tp`), MLA (`mla.mla_attention_tp`), the SSD (`ssm.
    ssm_mixer_tp`), or hymba's two branches merged on the first shard's
    norms. Replicated h in, replicated y out."""
    if kind.mixer == "mla":
        return mla_mod.mla_attention_tp([p["attn"] for p in ps], h, cfg,
                                        devices=devices, positions=positions)
    if kind.mixer == "mamba":
        return ssm_mod.ssm_mixer_tp([p["ssm"] for p in ps], h, cfg, devices)
    ya = attn_mod.attention_tp([p["attn"] for p in ps], h, cfg,
                               devices=devices, positions=positions,
                               window=kind.window, causal=not cfg.is_encoder)
    if kind.mixer == "attn":
        return ya
    ys = ssm_mod.ssm_mixer_tp([p["ssm"] for p in ps], h, cfg, devices)
    return _hymba_merge(ps[0], ya, ys, cfg)


def _prefill_cache_tp(ps: list, h, cfg, kind: LayerKind, positions, cache,
                      devices: list):
    """`_prefill_cache` under a ``model`` mesh, into a `place_cache`
    block cache (in place): the latents joined once and striped along S
    (MLA), k / v projected on each shard's kv heads or once (attention,
    written head stripe by head stripe or each S stripe its slots), the
    SSM's conv inputs and final state by their stripes."""
    if kind.mixer == "mla":
        c, k_pe = mla_mod.project_latent_tp([p["attn"] for p in ps], h, cfg,
                                            positions, devices)
        mla_mod.fill_mla_cache_from_prefill_tp(cache["mla"], c, k_pe,
                                               positions)
    if kind.mixer in ("attn", "hymba"):
        aps = [p["attn"] for p in ps]
        k, v = attn_mod._project_kv_tp(aps, h, cfg, positions, kind.window,
                                       devices)
        attn_mod.fill_cache_from_prefill_tp(cache["kv"], k, v, positions,
                                            kind.window, cfg, devices)
    if kind.mixer in ("mamba", "hymba"):
        ssm_mod.fill_ssm_cache_from_prefill_tp(
            cache["ssm"], [p["ssm"] for p in ps], h, cfg, devices)
    return cache


def _mixer_decode_tp(ps: list, cache, h, cfg, kind: LayerKind, pos,
                     devices: list):
    """`_mixer_decode` under a ``model`` mesh over a `place_cache` block
    cache (updated in place): attention (`attention.attention_decode_tp`,
    a windowed layer's ring too), MLA (`mla.mla_decode_tp`), the SSD
    (`ssm.ssm_decode_tp`), or hymba's two branches merged on the first
    shard's norms. Replicated h in, replicated y out."""
    if kind.mixer == "mla":
        return mla_mod.mla_decode_tp([p["attn"] for p in ps], cache["mla"],
                                     h, cfg, devices=devices, pos=pos)
    if kind.mixer == "mamba":
        return ssm_mod.ssm_decode_tp([p["ssm"] for p in ps], cache["ssm"], h,
                                     cfg, devices)
    ya = attn_mod.attention_decode_tp([p["attn"] for p in ps], cache["kv"],
                                      h, cfg, devices=devices, pos=pos,
                                      window=kind.window)
    if kind.mixer == "attn":
        return ya
    ys = ssm_mod.ssm_decode_tp([p["ssm"] for p in ps], cache["ssm"], h, cfg,
                               devices)
    return _hymba_merge(ps[0], ya, ys, cfg)


def block_apply_tp(ps: list, x, cfg, kind: LayerKind, *, mesh, positions,
                   mode: str = "chunk", caches: list | None = None,
                   cache=None, page_table=None, rpos=None, amask=None):
    """`block_apply` under a ``model`` mesh: ``ps`` (and, in chunk mode,
    ``caches``) hold one block's params (pool) a shard. The norms are
    replicated (computed once, on the first shard's copy); the mixer runs
    per shard on its heads (or its stripe) and its output projection's
    partials are summed; the MLP runs per shard (`_mlp_apply_tp`).
    ``mode="chunk"``: the serving step over the paged pools (updated in
    place; attention blocks only); ``"train"``: the full-sequence forward
    (train, `Model.forward_logits`) of every mixer (`_mixer_train_tp`),
    attention through K4 and, under grad, K4b on each shard's heads;
    ``"prefill"``: that forward, then the block's `place_cache` piece
    ``cache`` filled (`_prefill_cache_tp`); ``"decode"``: one token
    ``[B, D]`` against ``cache`` (`_mixer_decode_tp`), every mixer.
    Returns (the replicated x, the MoE aux loss or None)."""
    if mode == "chunk" and (kind.mixer != "attn"
                            or "kv_pool" not in caches[0]):
        raise ValueError(
            f"chunked execution needs a pure paged-attention cache; "
            f"{kind.tag!r} keeps per-slot sequential state: serve it "
            f"through the one-shot prefill path")
    devices = model_devices(mesh)
    h = norm(ps[0]["pre_norm"], x, cfg)
    if mode == "chunk":
        y, _ = attn_mod.attention_chunk_paged_tp(
            [p["attn"] for p in ps], [c["kv_pool"] for c in caches],
            page_table, h, cfg, mesh=mesh, pos=positions, rpos=rpos,
            amask=amask, window=kind.window)
    elif mode == "decode":
        y = _mixer_decode_tp(ps, cache, h, cfg, kind, positions, devices)
    else:
        y = _mixer_train_tp(ps, h, cfg, kind, devices, positions)
        if mode == "prefill":
            _prefill_cache_tp(ps, h, cfg, kind, positions, cache, devices)
    x = x + y
    if kind.mlp == "none":
        return x, None
    h2 = norm(ps[0]["mlp_norm"], x, cfg)
    y2, aux = _mlp_apply_tp(ps, h2, cfg, kind, devices)
    return x + y2, aux
