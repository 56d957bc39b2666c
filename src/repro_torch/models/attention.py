"""Attention: GQA, train/prefill, the dense decode cache, the paged chunk.

Execution regimes (as in the reference):

  * train/prefill — full-sequence attention through kernel K4
    (`kernels.flash_attention`: tiled online softmax, so no S × S score
    matrix is formed on the card; the reference chunks queries by
    ``attn_chunk`` for the same reason). Training differentiates it:
    K4 forward, K4b backward (`flash_attention.FlashAttentionFn`).
  * decode (dense cache) — single-token attention against a
    ``[B, S_max, Hkv, hd]`` cache (`GenerationEngine.generate`); a
    sliding-window layer keeps a ring of ``min(window, S_max)`` slots.
    The cache may be striped along S (SP-decode, whole parameters) or,
    under a ``model`` mesh, placed by `cache_pspec` beside placed
    parameters (`fill_cache_from_prefill_tp`, `attention_decode_tp`).
  * paged chunk (serving) — `attention_chunk_paged`: the engine's unified
    prefill/decode step over the page pools (scatter the block's K/V,
    then attend per token under the three-part visibility rule);
    `attention_decode_paged` is its C = 1 form, the one-shot engine's
    decode step.

Pools and caches are updated **in place** (``index_put_``), where the
reference returns new arrays: a serving step would otherwise copy every
layer's pool. Functions still return the (same) cache objects so their
signatures match the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import torch_dtype
from repro_torch.distributed.sharding import (concat, model_devices,
                                              record_collective, split)
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import paged_attention as k2
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, linear, rmsnorm, rope_cos_sin
from repro_torch.numerics import einsum_f32, einsum_f64


def attn_init(gen, cfg, dtype=torch.float32, device=None):
    d = cfg.d_model
    p = {
        "wq": layers.linear_init(gen, d, cfg.q_dim, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wk": layers.linear_init(gen, d, cfg.kv_dim, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wv": layers.linear_init(gen, d, cfg.kv_dim, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wo": layers.linear_init(gen, cfg.q_dim, d, dtype=dtype,
                                 device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.norm_init(cfg.head_dim, dtype=dtype,
                                       plus_one=cfg.rms_plus_one,
                                       device=device)
        p["k_norm"] = layers.norm_init(cfg.head_dim, dtype=dtype,
                                       plus_one=cfg.rms_plus_one,
                                       device=device)
    return p


def _rope_theta(cfg, window: int) -> float:
    if window > 0 and cfg.local_rope_theta:
        return cfg.local_rope_theta
    return cfg.rope_theta


def _rot_dim(cfg) -> int:
    rd = int(cfg.head_dim * cfg.rope_fraction)
    return rd - rd % 2


def _heads(lin, norm_p, x, cfg, heads: int, positions, window, name=None):
    """One projection's heads: ``linear`` → [..., heads, hd] → the
    qk-norm (``norm_p``, None without) → RoPE on the rotated channels."""
    t = linear(lin, x, name).reshape(*x.shape[:-1], heads, cfg.head_dim)
    if norm_p is not None:
        t = rmsnorm(norm_p, t, eps=cfg.norm_eps, plus_one=cfg.rms_plus_one)
    rd = _rot_dim(cfg)
    if rd:
        cos, sin = rope_cos_sin(positions, rd, _rope_theta(cfg, window))
        t = apply_rope(t, cos, sin, rd)
    return t


def _project_qkv(p, x, cfg, positions, window, name=None):
    """x [..., D] -> q [..., H, hd], k/v [..., Hkv, hd], rope'd + qk-norm'd.
    ``name`` (local → capture name, or None) labels the projections for
    calibration."""
    nm = (lambda s: None) if name is None else name
    qn, kn = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
    q = _heads(p["wq"], qn, x, cfg, cfg.num_heads, positions, window,
               nm("wq"))
    k = _heads(p["wk"], kn, x, cfg, cfg.num_kv_heads, positions, window,
               nm("wk"))
    v = linear(p["wv"], x, nm("wv")).reshape(*x.shape[:-1],
                                             cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _cache_probs_dtype(v_dtype: torch.dtype, adt: torch.dtype) -> torch.dtype:
    """The type a cache read's probabilities take into the value product.

    f32, as K2 and K4 keep them, while the cache holds the activations'
    own type: then the engine's reads and `generate`'s K4 prefill compute
    one function (under bf16 the reference's rounding of the
    probabilities, which K4 does not make, flipped a near-tied greedy
    token between them). A cache stored narrower than the activations (a
    bf16 pool or cache under f32 activations) keeps the reference's
    rounding to its storage type, and with it the reference's numerics:
    without that rounding the port's chunk step over a bf16 pool leaves
    the reference's logits by more than the bf16-cache tolerance.
    """
    return v_dtype if v_dtype.itemsize < adt.itemsize else torch.float32


def _position_mask(q_pos, k_pos, causal: bool, window: int
                   ) -> torch.Tensor:
    """Which keys each query sees by position → ``[B, 1, 1, C, S]`` (a
    slot with ``k_pos < 0`` is invalid; causal and window bounds on
    request)."""
    mask = k_pos[:, None, :] >= 0
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return mask[:, None, None, :, :]


def _sdpa(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
          scale: float, vis: torch.Tensor | None = None,
          probs_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Grouped scaled-dot-product attention over full key rows: every
    cache read of a decode or serving step that K2 does not take (the
    dense decode cache and its rings, bf16 page pools, the CPU).

    q [B, C, Hkv, G, hd]; k/v [B, S, Hkv, hd]; *_pos [B, C]/[B, S] absolute
    positions (k_pos < 0 ⇒ invalid slot). Returns [B, C, Hkv, G, hd] in
    v's dtype; the probabilities are rounded to ``probs_dtype`` (the
    caller's choice, `_cache_probs_dtype`) before the value product. A
    row's bits depend neither on how many rows share the call nor on how
    many masked keys its row holds. On the CPU the two products run in
    f64 rounded once to f32 (`einsum_f32`) and the softmax in f32: the
    plain K4's arithmetic, so a chunked prefill over bf16 pages gives
    `generate()`'s K4 prefill bits. On the card the f32 products
    (cuBLAS) and the softmax pick their kernels, and with them the order
    of their sums, from the batch and the key count: a one-shot engine's
    decode rows over bf16 pages (4 slots,
    keys up to the context bucket) parted from `generate()`'s (B 1, keys
    up to max_seq) in 3 of 8 glm4-9b, 3 of 8 qwen2-moe-a2.7b and 2 of 8
    hymba-1.5b streams on an H100 (`scripts/queue3_oneshot_bf16.py`,
    which runs both). There the scores, the softmax and the value product stay in
    f64 (`einsum_f64`) and the output is rounded once to f32. An explicit
    ``vis [B, C, S]`` mask overrides the positional mask; rows whose mask
    is empty then give exactly 0. Both masks feed the same softmax, so a
    row sees the same bits under either when they show it the same keys
    (a tree verify row's chain nodes and the sequential decode rows they
    stand for).
    """
    ein = einsum_f64 if q.device.type == "cuda" else einsum_f32
    scores = ein("bqkgd,bskd->bkgqs", q, k) * scale
    neg = torch.full_like(scores, -1e30)
    if vis is not None:
        vism = vis[:, None, None, :, :]
        probs = torch.softmax(torch.where(vism, scores, neg), dim=-1)
        probs = torch.where(vism.any(dim=-1, keepdim=True), probs,
                            torch.zeros_like(probs))
    else:
        mask = _position_mask(q_pos, k_pos, causal, window)
        probs = torch.softmax(torch.where(mask, scores, neg), dim=-1)
    out = ein("bkgqs,bskd->bqkgd", probs.to(probs_dtype), v)
    return out.to(torch.float32).to(v.dtype)


def _sdpa_striped(q, ks: list, vs: list, q_pos, k_pos, *, causal: bool,
                  window: int, scale: float,
                  probs_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`_sdpa` over keys striped along S (SP-decode): ``ks`` / ``vs`` one
    ``[B, S/n, Hkv, hd]`` stripe a ``model`` shard, each on its device,
    ``k_pos [B, S]`` the whole cache's positions. Stripe i scores its own
    keys on its device and keeps its partial max m_i, sum l_i and
    unnormalized output o_i (f64 on the card, as `_sdpa` reads the decode
    cache; the CPU's f32 arithmetic there); the partials are joined on
    the first stripe's device (`concat`) and combined in shard order:
    ``M = max m_i``, ``out = Σ o_i e^(m_i − M) / Σ l_i e^(m_i − M)``. A
    stripe that shows a row no key adds nothing (l_i = 0, o_i = 0).
    Returns ``[B, C, Hkv, G, hd]`` in v's dtype."""
    cuda = q.device.type == "cuda"
    ein = einsum_f64 if cuda else einsum_f32
    wdt = torch.float64 if cuda else torch.float32
    devices = [k.device for k in ks]
    n_s = ks[0].shape[1]
    ms, ls, os_ = [], [], []
    for i, (k, v) in enumerate(zip(ks, vs)):
        d = k.device
        qd, qp = q.to(d), q_pos.to(d)
        kp = k_pos[:, i * n_s:(i + 1) * n_s].to(d)
        scores = ein("bqkgd,bskd->bkgqs", qd, k).to(wdt) * scale
        mask = _position_mask(qp, kp, causal, window)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        m = scores.amax(dim=-1, keepdim=True)
        pr = torch.where(mask, torch.exp(scores - m),
                         torch.zeros_like(scores))
        ms.append(m[None])
        ls.append(pr.sum(dim=-1, keepdim=True)[None])
        os_.append(ein("bkgqs,bskd->bkgqd", pr.to(probs_dtype), v)
                   .to(wdt)[None])
    m_all, l_all, o_all = (concat(t, 0, devices) for t in (ms, ls, os_))
    top = m_all.amax(dim=0)
    den = torch.zeros_like(l_all[0])
    acc = torch.zeros_like(o_all[0])
    for i in range(len(ks)):                        # shard order
        w = torch.exp(m_all[i] - top)
        den = den + l_all[i] * w
        acc = acc + o_all[i] * w
    out = (acc / den).permute(0, 3, 1, 2, 4)        # -> [B, C, Hkv, G, hd]
    return out.to(torch.float32).to(vs[0].dtype)


def attention(p, x, cfg, *, positions, window: int = 0,
              causal: bool = True, name=None) -> torch.Tensor:
    """Train/prefill attention. x [B, S, D] -> [B, S, D].

    Positions are ``arange(S)`` on this path (`Model._embed`), so the
    mask is K4's: query i sees key j iff ``j <= i`` (causal) and
    ``j > i - window`` (windowed); ``positions`` feeds RoPE. The kernel
    reads the [B, S, H, hd] projections through ``transpose(1, 2)`` views
    and writes its output in the same layout, so no copy is made on
    either side. Probabilities stay f32 up to the output, where the
    reference's `_sdpa` rounds them to v's dtype before the value
    product: under bf16 activations the two agree to bf16 precision.

    Training goes through the same call: with grad enabled the kernel
    runs as `flash_attention.FlashAttentionFn`, K4 forward (saving each
    row's log-sum-exp) and K4b backward, so dq, dk and dv (and with them
    every q / k / v weight and bias) get their gradient on the card.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, window, name)
    out = k4.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), scale=cfg.head_dim ** -0.5,
                             causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    nm = (lambda s_: None) if name is None else name
    return linear(p["wo"], out, nm("wo"))


def attention_tp(ps: list, x, cfg, *, devices: list, positions,
                 window: int = 0, causal: bool = True) -> torch.Tensor:
    """`attention` over a ``model`` mesh's shards (``ps``: one layer's
    attention params a shard): shard s projects its q heads ``[s·H/n,
    (s+1)·H/n)`` with its column of ``wq`` and runs K4 (K4b under grad)
    over them and the kv heads they read — its own ``wk`` / ``wv``
    column where the rule splits them, else a slice of the kv heads
    projected once on the first shard (a replicated leaf is read on the
    first shard only, so only that copy takes a gradient); ``wo``
    (row-parallel) sums the shards' partials (`layers.linear_tp`). With
    ``wq`` whole (heads that do not divide) the attention runs on the
    first shard. x [B, S, D] replicated → y [B, S, D] replicated."""
    n = len(devices)
    b, s, _ = x.shape
    p0 = ps[0]
    scale = cfg.head_dim ** -0.5
    qn, kn = (p0["q_norm"], p0["k_norm"]) if cfg.qk_norm else (None, None)

    def k4_run(q, k, v):
        out = k4.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale=scale,
                                 causal=causal, window=window)
        return out.transpose(1, 2).reshape(b, s, -1)

    if layers._kn(p0["wq"])[1] == cfg.q_dim:
        outs = k4_run(*_project_qkv(p0, x, cfg, positions, window))
    else:
        hs, g = cfg.num_heads // n, cfg.num_heads // cfg.num_kv_heads
        kv_split = layers._kn(p0["wk"])[1] < cfg.kv_dim
        if not kv_split:
            k = _heads(p0["wk"], kn, x, cfg, cfg.num_kv_heads, positions,
                       window)
            v = linear(p0["wv"], x).reshape(b, s, cfg.num_kv_heads,
                                            cfg.head_dim)
        outs = []
        for sh, (p, d) in enumerate(zip(ps, devices)):
            xd = x.to(d)
            q = _heads(p["wq"], qn, xd, cfg, hs, positions.to(d), window)
            if kv_split:
                hk = cfg.num_kv_heads // n
                ks = _heads(p["wk"], kn, xd, cfg, hk, positions.to(d),
                            window)
                vs = linear(p["wv"], xd).reshape(b, s, hk, cfg.head_dim)
            elif hs % g == 0 or g % hs == 0:
                lo = sh * hs // g
                hi = ((sh + 1) * hs - 1) // g + 1
                ks, vs = k[:, :, lo:hi].to(d), v[:, :, lo:hi].to(d)
            else:
                # the shard's q heads cut a group: each reads its own kv
                # head (G 1)
                idx = [(sh * hs + j) // g for j in range(hs)]
                ks, vs = k[:, :, idx].to(d), v[:, :, idx].to(d)
            outs.append(k4_run(q, ks, vs))
    return layers.gathered(layers.linear_tp(
        [p["wo"] for p in ps], outs, devices, cfg.q_dim, cfg.d_model),
        devices)


# ---------------------------------------------------------------------------
# Dense decode cache (GenerationEngine.generate)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_seq: int, window: int,
                  dtype=torch.bfloat16, device=None):
    """Dense decode cache ``[B, S, Hkv, hd]`` (int8 codes plus f32
    per-(position, head) scale strips under ``cfg.kv_quant == "int8"``).
    A windowed layer keeps a ring of ``S = min(window, max_seq)`` slots:
    position p lives at slot ``p % window`` (`_ring_positions`)."""
    s = min(window, max_seq) if window else max_seq
    shape = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        sshape = (batch, s, cfg.num_kv_heads)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
                "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] → (int8 codes, per-[...] absmax scale).

    The divisor 127 is a tensor on x's device: CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal, which moves some
    scales by an ulp and flips codes at .5, so the card's codes would
    leave the CPU's (and the reference's) true division."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / amax.new_full((), 127.0))
    q = torch.clip(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)).to(dtype)


def _ring_positions(pos: torch.Tensor, w: int) -> torch.Tensor:
    """Absolute position held by each ring slot; < 0 ⇒ not yet written.

    Slot s (0..W-1) at current position ``pos [B]`` (the token being
    written) holds the newest absolute position p ≤ pos with p ≡ s
    (mod W). → ``[B, W]``."""
    slots = torch.arange(w, device=pos.device)[None, :]
    p = pos.long()[:, None]
    return p - ((p - slots) % w)


def _striped(cache) -> bool:
    """A decode cache whose leaves are lists of sequence stripes
    (SP-decode, `distributed.sharding.shard_cache`)."""
    return isinstance(cache["k"], list)


def _fill_stripes(cache, rows: dict, positions, window: int) -> None:
    """`fill_cache_from_prefill` into a cache striped along S: ``rows``
    the prefill's k / v (and int8 scales) ``[B, S, ...]`` on its device.
    They are put in slot order (a ring's kept tokens by ``position %
    W``), and each stripe receives only the slots it owns, written on
    its own device; the pieces handed out are counted as `split`'s."""
    s = next(iter(rows.values())).shape[1]
    if window and s > window:
        order = torch.argsort(positions[:, -window:].long() % window, dim=1)
        rows = {n: torch.gather(r[:, -window:], 1, order.reshape(
            *order.shape, *[1] * (r.dim() - 2)).expand_as(r[:, -window:]))
            for n, r in rows.items()}
        s = window
    for name, row in rows.items():
        parts = cache[name]
        n_s = parts[0].shape[1]
        for i, t in enumerate(parts):
            piece = row[:, i * n_s:min((i + 1) * n_s, s)]
            if piece.shape[1]:
                t[:, :piece.shape[1]] = piece.to(t.device).to(t.dtype)
        if len(parts) > 1:      # a device's piece: one stripe's slots
            record_collective("split", parts[0].numel()
                              * parts[0].element_size())


def _fill_dense(leaves: dict, rows: dict, positions, window: int) -> None:
    """Prefill rows ``[B, S, ...]`` into dense leaves of the same names
    (on their device): slots 0 … S−1, or a ring's last W tokens each at
    slot ``position % W``."""
    b, s = next(iter(rows.values())).shape[:2]
    dev = next(iter(leaves.values())).device
    if not window or s <= window:
        idx = (slice(None), slice(0, s))
    else:
        rows = {n: r[:, -window:] for n, r in rows.items()}
        idx = (torch.arange(b, device=dev)[:, None],
               positions[:, -window:].to(dev).long() % window)
    for name, row in rows.items():
        leaves[name][idx] = row.to(dev).to(leaves[name].dtype)


def fill_cache_from_prefill(cache, k, v, positions, window: int):
    """Write prefill keys/values [B, S, ...] into a fresh decode cache. A
    windowed layer whose prompt is longer than its ring keeps the last W
    tokens, each at slot ``position % W``. A cache striped along S
    (SP-decode) gets the same bytes, each stripe its own slots."""
    rows = {"k": k, "v": v}
    if "ks" in cache:
        rows["k"], rows["ks"] = _kv_quantize(k)
        rows["v"], rows["vs"] = _kv_quantize(v)
    if _striped(cache):
        _fill_stripes(cache, rows, positions, window)
    else:
        _fill_dense(cache, rows, positions, window)
    return cache


def _head_stripes(cache, cfg) -> bool:
    """A placed cache whose k / v pieces hold the shards' kv heads
    (`distributed.sharding.place_cache` where S does not stripe)."""
    return _striped(cache) and cache["k"][0].shape[-2] < cfg.num_kv_heads


def _fill_heads(cache, k: list, v: list, positions, window: int,
                devices: list) -> None:
    """`fill_cache_from_prefill` into a cache split over kv heads: each
    shard writes its own heads' rows into its pieces; int8 scale strips,
    which the rule leaves whole, take the shards' scales joined."""
    scales: dict = {"ks": [], "vs": []}
    for s in range(len(devices)):
        rows = {"k": k[s], "v": v[s]}
        if "ks" in cache:
            rows["k"], ks = _kv_quantize(k[s])
            rows["v"], vs = _kv_quantize(v[s])
            scales["ks"].append(ks)
            scales["vs"].append(vs)
        _fill_dense({n: cache[n][s] for n in rows}, rows, positions, window)
    if "ks" in cache:
        _fill_dense({n: cache[n] for n in scales},
                    {n: concat(parts, -1, devices)
                     for n, parts in scales.items()}, positions, window)


def fill_cache_from_prefill_tp(cache, k, v, positions, window: int, cfg,
                               devices: list):
    """`fill_cache_from_prefill` under a ``model`` mesh: ``k`` / ``v`` the
    prefill's rows, lists of kv-head stripes (``wk`` / ``wv`` split) or
    whole on the first shard. A cache split over kv heads is written
    shard by shard; a cache striped along S, or whole, takes the whole
    rows (the head stripes joined), each S stripe its own slots."""
    if _head_stripes(cache, cfg):
        if not isinstance(k, list):
            k, v = split(k, -2, devices), split(v, -2, devices)
        _fill_heads(cache, k, v, positions, window, devices)
        return cache
    if isinstance(k, list):
        k, v = concat(k, -2, devices), concat(v, -2, devices)
    return fill_cache_from_prefill(cache, k, v, positions, window)


def _write_row(parts: list, row: torch.Tensor, slot: torch.Tensor) -> None:
    """A decode step's new row ``[B, ...]`` into a leaf striped along S,
    at slot ``slot [B]`` of the whole sequence: every stripe writes the
    row where it owns the slot and its own bytes back elsewhere (a
    `where`; no row index leaves a device)."""
    n_s = parts[0].shape[1]
    b = row.shape[0]
    for i, t in enumerate(parts):
        d = t.device
        local = (slot - i * n_s).to(d)
        owned = ((local >= 0) & (local < n_s)).reshape(
            b, *[1] * (row.dim() - 1))
        local = local.clamp(0, n_s - 1)
        bidx = torch.arange(b, device=d)
        t[bidx, local] = torch.where(owned, row.to(d).to(t.dtype),
                                     t[bidx, local])


def _decode_rw(cache, q, k1, v1, cfg, pos, window: int) -> torch.Tensor:
    """A decode step's cache write and read, whole heads: the new rows
    ``k1`` / ``v1`` ``[B, Hkv, hd]`` written at the step's slot (in the
    stripe that owns it, for a cache striped along S), then ``q [B, H,
    hd]`` read against every held position → ``[B, q_dim]`` on q's
    device."""
    b = q.shape[0]
    striped = _striped(cache)
    slot = (pos.long() % window) if window else pos.long()
    new = {"k": k1, "v": v1}
    if "ks" in cache:
        new["k"], new["ks"] = _kv_quantize(k1)
        new["v"], new["vs"] = _kv_quantize(v1)
    bidx = torch.arange(b, device=q.device)
    for name, row in new.items():
        if striped:
            _write_row(cache[name], row, slot)
        else:
            cache[name][bidx, slot] = row.to(cache[name].dtype)
    if not striped:
        return _read(cache, q, cfg, pos, window)
    adt = torch_dtype(cfg.activation_dtype)
    ck, cv = cache["k"], cache["v"]
    if "ks" in cache:
        ck = [_kv_dequant(c, sc, adt) for c, sc in zip(ck, cache["ks"])]
        cv = [_kv_dequant(c, sc, adt) for c, sc in zip(cv, cache["vs"])]
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, 1, cfg.num_kv_heads, g, cfg.head_dim)
    out = _sdpa_striped(qg, ck, cv, pos[:, None],
                        _key_positions(pos, sum(c.shape[1] for c in ck),
                                       window),
                        causal=bool(window), window=window,
                        scale=cfg.head_dim ** -0.5,
                        probs_dtype=_cache_probs_dtype(cv[0].dtype, adt))
    return out.to(q.device).reshape(b, cfg.q_dim)


def _key_positions(pos, s_max: int, window: int) -> torch.Tensor:
    """The position each of a decode cache's ``s_max`` slots holds at
    step ``pos [B]`` (< 0: not yet written) → ``[B, s_max]``."""
    if window:
        return _ring_positions(pos, s_max)
    ar = torch.arange(s_max, device=pos.device)[None, :]
    return torch.where(ar <= pos[:, None], ar, torch.full_like(ar, -1))


def attention_decode(p, cache, x, cfg, *, pos, window: int = 0):
    """Single-token decode. x [B, D], pos [B] -> (y [B, D], cache).

    A windowed layer writes slot ``pos % window`` of its ring and attends
    over the positions the ring holds (`_ring_positions`) under the
    causal window mask; a full layer writes slot ``pos`` and attends over
    ``k <= pos``. Through `_sdpa`, a slot's row depends neither on the
    step's slot count nor on the cache's length, so `generate()`'s rows
    equal a one-shot engine's (a hymba engine keeps one ring row a slot;
    its global layers and every other model's read bf16 pages). A cache
    striped along S (SP-decode) takes the new row in the stripe that
    owns its slot (`_write_row`) and is read stripe by stripe
    (`_sdpa_striped`)."""
    q, k1, v1 = _project_qkv(p, x, cfg, pos, window)    # [B, H(kv), hd]
    out = _decode_rw(cache, q, k1, v1, cfg, pos, window)
    return linear(p["wo"], out), cache


def _project_q_tp(ps: list, x, cfg, positions, window: int, devices: list):
    """The q heads under a ``model`` mesh: one stripe of ``H / n`` heads a
    shard where ``wq`` splits, else all heads on the first shard."""
    qn = [p["q_norm"] if cfg.qk_norm else None for p in ps]
    if layers._kn(ps[0]["wq"])[1] == cfg.q_dim:
        return _heads(ps[0]["wq"], qn[0], x, cfg, cfg.num_heads, positions,
                      window)
    hs = cfg.num_heads // len(devices)
    return [_heads(p["wq"], nq, x.to(d), cfg, hs, positions.to(d), window)
            for p, nq, d in zip(ps, qn, devices)]


def _project_kv_tp(ps: list, x, cfg, positions, window: int, devices: list):
    """k / v ``[..., Hkv, hd]`` under a ``model`` mesh: one stripe of kv
    heads a shard where ``wk`` / ``wv`` split (lists), else projected once
    on the first shard."""
    kn = [p["k_norm"] if cfg.qk_norm else None for p in ps]
    lead, hd = x.shape[:-1], cfg.head_dim
    if layers._kn(ps[0]["wk"])[1] == cfg.kv_dim:
        return (_heads(ps[0]["wk"], kn[0], x, cfg, cfg.num_kv_heads,
                       positions, window),
                linear(ps[0]["wv"], x).reshape(*lead, cfg.num_kv_heads, hd))
    hk = cfg.num_kv_heads // len(devices)
    ks, vs = [], []
    for p, nk, d in zip(ps, kn, devices):
        xd = x.to(d)
        ks.append(_heads(p["wk"], nk, xd, cfg, hk, positions.to(d), window))
        vs.append(linear(p["wv"], xd).reshape(*lead, hk, hd))
    return ks, vs


def attention_decode_tp(ps: list, cache, x, cfg, *, devices: list, pos,
                        window: int = 0) -> torch.Tensor:
    """`attention_decode` under a ``model`` mesh (``ps``: one layer's
    attention params a shard; ``cache``: its `place_cache` piece). x [B,
    D] replicated → y [B, D] replicated; the cache is updated in place.

    A cache split over kv heads (S too short to stripe) is all local:
    each shard projects its q and kv heads, writes its heads' rows into
    its pieces and reads them (`_sdpa`); int8 scale strips, which the rule
    leaves whole, take the shards' new scales joined and hand each shard
    its heads' strips. A cache striped along S, or whole, needs every
    head at every stripe: the shards' kv rows are joined and written by
    the stripe that owns the slot (`_write_row`), the q heads are joined
    (an all-gather of ``[B, H, hd]``, or all of them projected on the
    first shard where ``wq`` stays whole) and every stripe returns its
    partial max, sum and output, combined in shard order
    (`_sdpa_striped`). The output's heads feed the row-parallel ``wo``
    (`layers.linear_tp`: cut from the whole output where it was
    combined on the first shard)."""
    b = x.shape[0]
    q = _project_q_tp(ps, x, cfg, pos, window, devices)
    k1, v1 = _project_kv_tp(ps, x, cfg, pos, window, devices)
    wo = [p["wo"] for p in ps]
    if not _head_stripes(cache, cfg):
        if isinstance(k1, list):
            k1, v1 = concat(k1, -2, devices), concat(v1, -2, devices)
        if isinstance(q, list):
            q = concat(q, -2, devices)
        out = _decode_rw(cache, q, k1, v1, cfg, pos, window)
        return layers.gathered(layers.linear_tp(wo, out, devices, cfg.q_dim,
                                                cfg.d_model), devices)
    if not isinstance(k1, list):
        k1, v1 = split(k1, -2, devices), split(v1, -2, devices)
    if not isinstance(q, list):
        q = split(q, -2, devices)
    n = len(devices)
    hk, hs = cfg.num_kv_heads // n, cfg.num_heads // n
    lcfg = dataclasses.replace(cfg, num_heads=hs, num_kv_heads=hk)
    quant = "ks" in cache
    slot = (pos.long() % window) if window else pos.long()
    scales: dict = {"ks": [], "vs": []}
    for s, d in enumerate(devices):
        new = {"k": k1[s], "v": v1[s]}
        if quant:
            new["k"], ks = _kv_quantize(k1[s])
            new["v"], vs = _kv_quantize(v1[s])
            scales["ks"].append(ks)
            scales["vs"].append(vs)
        bidx = torch.arange(b, device=d)
        for name, row in new.items():
            cache[name][s][bidx, slot.to(d)] = row.to(cache[name][s].dtype)
    strips = {}
    if quant:
        bidx = torch.arange(b, device=devices[0])
        for name, parts in scales.items():
            cache[name][bidx, slot.to(devices[0])] = concat(parts, -1,
                                                            devices)
            strips[name] = split(cache[name], -1, devices)
    outs = []
    for s, d in enumerate(devices):
        # the shard's pieces read as a whole cache of its heads
        piece = {"k": cache["k"][s], "v": cache["v"][s]}
        if quant:
            piece.update(ks=strips["ks"][s], vs=strips["vs"][s])
        outs.append(_read(piece, q[s], lcfg, pos.to(d), window))
    return layers.gathered(layers.linear_tp(wo, outs, devices, cfg.q_dim,
                                            cfg.d_model), devices)


def _read(cache, q, cfg, pos, window: int) -> torch.Tensor:
    """A whole (unstriped) cache's read by ``q [B, H, hd]`` at ``pos``
    (its rows already written) → ``[B, q_dim]``."""
    b = q.shape[0]
    adt = torch_dtype(cfg.activation_dtype)
    ck, cv = cache["k"], cache["v"]
    if "ks" in cache:
        ck = _kv_dequant(ck, cache["ks"], adt)
        cv = _kv_dequant(cv, cache["vs"], adt)
    k_pos = _key_positions(pos, ck.shape[1], window)
    g = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, 1, cfg.num_kv_heads, g, cfg.head_dim)
    out = _sdpa(qg, ck, cv, pos[:, None], k_pos, causal=bool(window),
                window=window, scale=cfg.head_dim ** -0.5,
                probs_dtype=_cache_probs_dtype(cv.dtype, adt))
    return out.reshape(b, cfg.q_dim)


# ---------------------------------------------------------------------------
# Paged pools (serving)
# ---------------------------------------------------------------------------

def init_paged_kv_cache(cfg, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, kv_quant: str | None = None,
                        device=None):
    """Page pool for one layer: ``[num_pages, page_size, Hkv, hd]``; int8
    pools add f32 per-(position, head) scale strips ``ks``/``vs``. Page 0
    is the pager's scratch page."""
    kv_quant = cfg.kv_quant if kv_quant is None else kv_quant
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant == "int8":
        sshape = (num_pages, page_size, cfg.num_kv_heads)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(sshape, dtype=torch.float32, device=device),
                "vs": torch.zeros(sshape, dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _chunk_index(page_table, pos, rpos, amask, window: int, page_size: int):
    """The chunk's replicated index math: RoPE positions, the ancestor
    mask with the window's in-span bound folded in, and each token's
    (physical page, offset) write target, padding at scratch page 0."""
    valid = pos >= 0
    logical = pos if rpos is None else rpos
    rope_pos = torch.where(valid, logical, torch.zeros_like(logical))
    if amask is not None and window:
        # a supplied ancestor mask is authoritative for in-span keys (the
        # kernel applies ``window`` only to committed pages), so fold the
        # in-span locality bound in here, once, above both read paths
        amask = (amask.to(torch.bool)
                 & (rope_pos[:, None, :] > rope_pos[:, :, None] - window))
    slot_pos = torch.where(valid, pos, torch.zeros_like(pos)).long()
    phys = torch.gather(page_table.long(), 1, slot_pos // page_size)
    phys = torch.where(valid, phys, torch.zeros_like(phys))  # → scratch page 0
    offset = torch.where(valid, slot_pos % page_size,
                         torch.zeros_like(slot_pos))
    return rope_pos, amask, phys.reshape(-1), offset.reshape(-1)


def _chunk_write(p, pool, x, cfg, rope_pos, fp, fo, window: int):
    """Project the chunk's q / k / v, scatter k and v into the pool (int8
    pools quantize each token, `_kv_quantize`); returns q grouped ``[B,
    C, Hkv, G, hd]``."""
    b, c, _ = x.shape
    q, k1, v1 = _project_qkv(p, x, cfg, rope_pos, window)  # [B, C, H(kv), hd]
    kv_shape = (b * c, cfg.num_kv_heads, cfg.head_dim)
    if "ks" in pool:
        k1, ks1 = _kv_quantize(k1)
        v1, vs1 = _kv_quantize(v1)
        pool["ks"].index_put_((fp, fo), ks1.reshape(b * c, cfg.num_kv_heads))
        pool["vs"].index_put_((fp, fo), vs1.reshape(b * c, cfg.num_kv_heads))
    pool["k"].index_put_((fp, fo), k1.reshape(kv_shape).to(pool["k"].dtype))
    pool["v"].index_put_((fp, fo), v1.reshape(kv_shape).to(pool["v"].dtype))
    g = cfg.num_heads // cfg.num_kv_heads
    return q.reshape(b, c, cfg.num_kv_heads, g, cfg.head_dim)


def _k2_args(page_table, pos, rpos, amask):
    """K2's replicated operands, contiguous and int32."""
    return dict(page_table=page_table.contiguous(),
                pos=pos.to(torch.int32).contiguous(),
                rpos=None if rpos is None
                else rpos.to(torch.int32).contiguous(),
                amask=None if amask is None else amask.contiguous())


def _chunk_read_gather(pool, page_table, qg, cfg, pos, rpos, amask,
                       window: int) -> torch.Tensor:
    """The gather-based read: page table → logical ``[B, S_slot, Hkv,
    hd]`` view (dequantized to the activation dtype for int8 pools), then
    masked attention; returns ``[B, C, q_dim]``."""
    b, c = pos.shape
    page_size = pool["k"].shape[1]
    s_slot = page_table.shape[1] * page_size
    tbl = page_table.long()
    ck = pool["k"][tbl].reshape(b, s_slot, cfg.num_kv_heads, cfg.head_dim)
    cv = pool["v"][tbl].reshape(b, s_slot, cfg.num_kv_heads, cfg.head_dim)
    adt = torch_dtype(cfg.activation_dtype)
    if "ks" in pool:
        ks = pool["ks"][tbl].reshape(b, s_slot, cfg.num_kv_heads)
        vs = pool["vs"][tbl].reshape(b, s_slot, cfg.num_kv_heads)
        ck = _kv_dequant(ck, ks, adt)
        cv = _kv_dequant(cv, vs, adt)
    k_pos = torch.arange(s_slot, device=qg.device)[None, :].expand(b, s_slot)
    probs_dtype = _cache_probs_dtype(cv.dtype, adt)
    if rpos is None and amask is None and not window:
        out = _sdpa(qg, ck, cv, pos, k_pos, causal=True, window=0,
                    scale=cfg.head_dim ** -0.5, probs_dtype=probs_dtype)
    else:
        vis = k2.chunk_visibility_ref(pos, s_slot=s_slot, rpos=rpos,
                                      amask=amask, window=window)
        out = _sdpa(qg, ck, cv, pos, k_pos, causal=True, window=0,
                    scale=cfg.head_dim ** -0.5, vis=vis,
                    probs_dtype=probs_dtype)
    return out.reshape(b, c, cfg.q_dim)


def attention_chunk_paged(p, pool, page_table, x, cfg, *, pos, rpos=None,
                          amask=None, window: int = 0):
    """Token-budget chunk step against a paged KV pool — the unified
    prefill/decode execution path.

    x ``[B, C, D]``; pos ``[B, C]`` int32 absolute KV slot positions
    (``-1`` = padding); page_table ``[B, pages_per_slot]`` int32.
    ``rpos`` (logical positions) and ``amask`` (``[B, C, C]`` in-span
    ancestor mask) default to plain linear-chunk causality. Returns
    (y [B, C, D], pool), the pool updated in place.

    Scatter first: every valid token's K/V goes to
    ``pool[table[b, pos // P], pos % P]``, padding to scratch page 0,
    offset 0 (many padding writes hit that one index, in no defined
    order on CUDA; harmless because page 0 is never visible). Int8 pools
    quantize each written token with `_kv_quantize`, so chunked commits
    are bit-identical to one-shot ones. Then read: int8 pools on CUDA go
    through kernel K2, which dequantizes in f32 and whose output is cast
    to the activation dtype; everything else takes the gather path, which
    dequantizes to the activation dtype before attending (the reference's
    off-TPU semantics, mirrored exactly).
    """
    b, c, _ = x.shape
    rope_pos, amask, fp, fo = _chunk_index(page_table, pos, rpos, amask,
                                           window, pool["k"].shape[1])
    qg = _chunk_write(p, pool, x, cfg, rope_pos, fp, fo, window)
    if "ks" in pool and x.device.type == "cuda":
        out = k2.paged_attention_chunk(
            qg.to(torch.float32).contiguous(), pool["k"], pool["ks"],
            pool["v"], pool["vs"], window=window,
            scale=cfg.head_dim ** -0.5, **_k2_args(page_table, pos, rpos,
                                                    amask))
        adt = torch_dtype(cfg.activation_dtype)
        return linear(p["wo"], out.reshape(b, c, cfg.q_dim).to(adt)), pool
    out = _chunk_read_gather(pool, page_table, qg, cfg, pos, rpos, amask,
                             window)
    return linear(p["wo"], out), pool


def attention_chunk_paged_tp(ps, pools, page_table, x, cfg, *, mesh, pos,
                             rpos=None, amask=None, window: int = 0):
    """`attention_chunk_paged` under a ``model`` mesh (the reference's
    mesh branch): shard s holds heads ``[s·H/n, (s+1)·H/n)`` and kv heads
    ``[s·Hkv/n, …)`` — its column-parallel ``wq / wk / wv``, its
    KV-head stripe of the pool ``pools[s]`` — and runs the chunk with a
    shard-local config: projects its heads, scatters into its own pool,
    reads. Int8 pools on the card read through K2-TP
    (`kernels.paged_attention.paged_attention_chunk_sharded`: K2 on each
    shard's heads); bf16 pools and the CPU take the gather path per
    shard. ``wo`` (row-parallel, or column-parallel where a packed K-shard
    would split quant groups) consumes the head-sharded output
    (`layers.linear_tp`). ``x`` and the index operands are replicated;
    returns (y [B, C, D] on the first shard's device, pools)."""
    devices = model_devices(mesh)
    n = len(devices)
    b, c, _ = x.shape
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               num_kv_heads=cfg.num_kv_heads // n)
    rope_pos, amask, fp, fo = _chunk_index(page_table, pos, rpos, amask,
                                           window, pools[0]["k"].shape[1])
    qs = [_chunk_write(p, pool, x.to(d), lcfg, rope_pos.to(d), fp.to(d),
                       fo.to(d), window)
          for p, pool, d in zip(ps, pools, devices)]
    if "ks" in pools[0] and x.device.type == "cuda":
        outs = k2.paged_attention_chunk_sharded(
            [q.to(torch.float32).contiguous() for q in qs],
            [pl["k"] for pl in pools], [pl["ks"] for pl in pools],
            [pl["v"] for pl in pools], [pl["vs"] for pl in pools],
            mesh=mesh, window=window, scale=cfg.head_dim ** -0.5,
            **_k2_args(page_table, pos, rpos, amask))
        adt = torch_dtype(cfg.activation_dtype)
        outs = [o.reshape(b, c, lcfg.q_dim).to(adt) for o in outs]
    else:
        outs = [_chunk_read_gather(
                    pool, page_table.to(d), q, lcfg, pos.to(d),
                    None if rpos is None else rpos.to(d),
                    None if amask is None else amask.to(d), window)
                for pool, q, d in zip(pools, qs, devices)]
    return layers.linear_tp([p["wo"] for p in ps], outs, devices,
                            cfg.q_dim, cfg.d_model), pools


def attention_decode_paged(p, pool, page_table, x, cfg, *, pos,
                           window: int = 0):
    """Single-token decode against a paged KV pool: the C = 1 form of
    `attention_chunk_paged` (one implementation serves both forms, so
    int8 pools read through K2 on the card and bf16 pools take the
    gather path). x ``[B, D]``, pos ``[B]``, page_table ``[B, pages]``
    → (y [B, D], pool updated in place). At C = 1 the chunk's causal
    mask is the dense decode mask ``k <= pos``.
    """
    y, pool = attention_chunk_paged(p, pool, page_table, x[:, None], cfg,
                                    pos=pos[:, None], window=window)
    return y[:, 0], pool
