"""Mamba-2 (SSD, state-space duality) mixer: chunked train/prefill and
O(1) recurrent decode.

The minimal SSD form of arXiv:2405.21060, as the reference writes it:
scalar decay per head (A = -exp(a_log)), per-head dt through softplus,
grouped B/C (``ssm_ngroups``), a short depthwise causal conv on x / B / C,
a gated RMSNorm on the output. Projections (wz / wx / wb / wc / wdt,
out_proj) are separate linears, so the AWQ pipeline sees one matrix per
role and a quantized model runs them through `layers.linear` (K1 on the
card).

Chunked algorithm (chunk length Q = ``min(ssm_chunk, S)``, one chunk of
S when S is not a multiple of it): within a chunk the token mixing is
the quadratic, decay-masked form; across chunks a loop carries the
``[nh, hd, ds]`` state. Decode is the recurrence h <- h·exp(dA) + dt·B⊗x:
attention-free, constant state. As in the reference, all of it is
tensor code (the reference has no kernel for the SSD). The contractions
run through `numerics`: f64 on the CPU rounded once to f32, f32 on the
card; decode's state read ``h·C`` is f64 on every device, rounded once,
so a slot's row does not depend on how many slots the step holds.
Caches update in place.

Under a ``model`` mesh (`ssm_mixer_tp`, the train-mode forward) the
projections split as the reference's rules split them: ``wz`` / ``wx`` /
``wb`` / ``wc`` / ``wdt`` by columns, ``out_proj`` by rows; the conv
kernels, ``a_log``, ``ssm_d``, ``dt_bias`` and ``out_norm`` stay whole,
and each shard reads its slice of the first shard's copy.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import concat
from repro_torch.models import layers
from repro_torch.models.layers import gathered, linear, linear_tp, striped
from repro_torch.numerics import einsum_f32, einsum_f64


def ssm_init(gen, cfg, dtype=torch.float32, device=None):
    """The reference's distributions: N(0, 1/K) projections, conv kernels
    N(0, 1/dc²) with zero bias, ``a_log = log(linspace(1, 16, nh))``,
    zero ``dt_bias`` and unit ``ssm_d`` (those three in f32)."""
    d = cfg.d_model
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    gdim = cfg.ssm_ngroups * ds
    dc = cfg.ssm_conv
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    def conv(c):
        k = torch.randn((dc, c), generator=gen, device=device) / dc
        return {"k": k.to(dtype), "b": torch.zeros((c,), **kw)}

    return {
        "wz": layers.linear_init(gen, d, di, **kw),
        "wx": layers.linear_init(gen, d, di, **kw),
        "wb": layers.linear_init(gen, d, gdim, **kw),
        "wc": layers.linear_init(gen, d, gdim, **kw),
        "wdt": layers.linear_init(gen, d, nh, **kw),
        "conv_x": conv(di),
        "conv_b": conv(gdim),
        "conv_c": conv(gdim),
        "dt_bias": torch.zeros((nh,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "ssm_d": torch.ones((nh,), **f32),
        "out_norm": layers.norm_init(di, **kw),
        "out_proj": layers.linear_init(gen, di, d, **kw),
    }


def _causal_conv(u: torch.Tensor, kern: dict) -> torch.Tensor:
    """Depthwise causal conv1d + silu. u [B, S, C], kernel [dc, C]; the
    result takes the promoted type of u and the kernel."""
    dc, s = kern["k"].shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, dc - 1, 0))
    out = sum(pad[:, i:i + s] * kern["k"][i] for i in range(dc))
    return F.silu(out + kern["b"])


def _conv_step(u1: torch.Tensor, conv_cache: torch.Tensor, kern: dict):
    """One-token causal conv. u1 [B, C]; cache [B, dc-1, C] (past
    pre-conv inputs, f32). Returns (silu output [B, C], the window's
    last dc-1 inputs). The taps are summed one after another, so a row's
    bits do not depend on the batch."""
    pre, window = _conv_sum(u1, conv_cache, kern)
    return F.silu(pre), window


def _conv_sum(u1: torch.Tensor, conv_cache: torch.Tensor, kern: dict):
    """`_conv_step` before its silu: (the taps' sum plus the bias, the
    window's last dc-1 inputs)."""
    window = torch.cat([conv_cache, u1[:, None].to(conv_cache.dtype)], dim=1)
    out = sum(window[:, i] * kern["k"][i] for i in range(window.shape[1]))
    return out + kern["b"], window[:, 1:]


def _project(p, x_in, nm, keys=("wz", "wx", "wb", "wc")):
    """The mixer's front linears on x_in [..., D] (z, and the pre-conv x /
    B / C inputs, as ``keys`` lists them), then dt [..., nh] f32."""
    outs = [linear(p[k], x_in, nm(k)) for k in keys]
    dt = F.softplus(linear(p["wdt"], x_in, nm("wdt")).to(torch.float32)
                    + p["dt_bias"])
    return (*outs, dt)


def _heads(x: torch.Tensor, n: int, w: int, rep: int = 1) -> torch.Tensor:
    """[..., n·w] -> f32 [..., n·rep, w] (each of the n groups repeated
    over rep heads)."""
    h = x.reshape(*x.shape[:-1], n, w).to(torch.float32)
    return h.repeat_interleave(rep, dim=-2) if rep > 1 else h


def ssd_chunked(xh, bh, ch, dt, a_log, chunk: int) -> torch.Tensor:
    """The chunked SSD scan without the D skip. xh [B, S, nh, hd]; bh / ch
    [B, S, nh, ds]; dt [B, S, nh] (all f32) -> y [B, S, nh, hd] f32.

    Q = ``min(chunk, S)``, a single chunk when S is not a multiple of it.
    The exponent of the intra-chunk decay is masked before ``exp`` (as
    in the reference: exp of an anti-causal entry would overflow). The
    ``[B, nc, Q, Q, nh]`` decay and score tensors are formed one at a
    time, in place (at Q 1,400 and 50 heads each is 392 MB)."""
    b, s, nh, hd = xh.shape
    da = dt * -torch.exp(a_log)
    q = min(chunk, s)
    if s % q:
        q = s                                     # fallback: single chunk
    nc = s // q
    xc, bc, cc, dac, dtc = (t.reshape(b, nc, q, *t.shape[2:])
                            for t in (xh, bh, ch, da, dt))
    seg = torch.cumsum(dac, dim=2)                          # [B, nc, Q, nh]

    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # [B,nc,Qi,Qj,nh]
    decay.masked_fill_(~causal[:, :, None], -1e30).exp_()
    scores = einsum_f32("bnihs,bnjhs->bnijh", cc, bc)
    scores.mul_(decay)
    del decay
    scores.mul_(dtc[:, :, None])
    y = einsum_f32("bnijh,bnjhd->bnihd", scores, xc)
    del scores

    # chunk states, then the inter-chunk recurrence over them
    decay_to_end = torch.exp(seg[:, :, -1:] - seg)          # [B, nc, Q, nh]
    state_c = einsum_f32("bnjhs,bnjhd->bnhds",
                         bc * (dtc * decay_to_end)[..., None], xc)
    chunk_decay = torch.exp(seg[:, :, -1])                  # [B, nc, nh]
    h = torch.zeros_like(state_c[:, 0])
    h_prev = []
    for n in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + state_c[:, n]
    y_inter = einsum_f32("bnihs,bnhds->bnihd", cc * torch.exp(seg)[..., None],
                         torch.stack(h_prev, dim=1))
    return (y + y_inter).reshape(b, s, nh, hd)


def _out(p, y, xh, z, x_dtype, cfg):
    """D skip, then the gated RMSNorm: y / xh [..., nh, hd] f32 ->
    [..., di] in x's type."""
    y = y + xh * p["ssm_d"][:, None]
    y = y.reshape(*y.shape[:-2], cfg.d_inner).to(x_dtype)
    return layers.rmsnorm(p["out_norm"], y * F.silu(z), eps=cfg.norm_eps)


def ssm_mixer(p, x_in: torch.Tensor, cfg, name=None) -> torch.Tensor:
    """Train/prefill SSD. x_in [B, S, D] -> [B, S, D]. ``name`` (local ->
    capture name, or None) labels the six projections for calibration
    (``wz`` … ``out_proj``)."""
    nm = (lambda s: None) if name is None else name
    ds, nh, hd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    ng = cfg.ssm_ngroups
    z, ux, ub, uc, dt = _project(p, x_in, nm)
    xh = _heads(_causal_conv(ux, p["conv_x"]), nh, hd)
    bh = _heads(_causal_conv(ub, p["conv_b"]), ng, ds, nh // ng)
    ch = _heads(_causal_conv(uc, p["conv_c"]), ng, ds, nh // ng)
    y = ssd_chunked(xh, bh, ch, dt, p["a_log"], cfg.ssm_chunk)
    y = _out(p, y, xh, z, x_in.dtype, cfg)
    return linear(p["out_proj"], y, nm("out_proj"))


def _cols(t: torch.Tensor, lo: int, hi: int, device) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a replicated leaf's last dim on ``device``
    (a slice of the first shard's copy: its gradient lands there)."""
    return t[..., lo:hi].to(device)


def ssm_mixer_tp(ps: list, x_in: torch.Tensor, cfg, devices: list
                 ) -> torch.Tensor:
    """`ssm_mixer` over a ``model`` mesh's shards (``ps``: one layer's SSM
    params a shard). x_in [B, S, D] replicated -> [B, S, D] replicated.

    B and C are joined over their group dim (every head reads all of
    them) and run through their convs once. Where the heads divide over
    the shards (then ``wx``'s stripes hold whole heads and ``wdt`` splits
    with them), each shard projects its stripe of z, x and dt, runs the
    conv on its own channels and the chunked scan on its heads; the gated
    RMSNorm over all of ``d_inner`` sums the shards' sums of squares
    (`layers.rmsnorm_split`), and ``out_proj`` takes the normed stripes
    row-parallel (or flipped, `layers.linear_tp`). Where they do not
    (hymba's 50 heads over 4: an 800-column stripe cuts a 64-wide head,
    ``wdt`` stays whole), the stripes of z and x are joined and the heads
    run on the first shard."""
    n = len(devices)
    d, di = cfg.d_model, cfg.d_inner
    ds, nh, hd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    ng = cfg.ssm_ngroups
    p0 = ps[0]

    def proj(key, width):
        return linear_tp([p[key] for p in ps], x_in, devices, d, width)

    ub = gathered(proj("wb", ng * ds), devices)
    uc = gathered(proj("wc", ng * ds), devices)
    bh = _heads(_causal_conv(ub, p0["conv_b"]), ng, ds, nh // ng)
    ch = _heads(_causal_conv(uc, p0["conv_c"]), ng, ds, nh // ng)
    outs = [p["out_proj"] for p in ps]
    if nh % n:
        z = gathered(proj("wz", di), devices)
        ux = gathered(proj("wx", di), devices)
        dt = F.softplus(gathered(proj("wdt", nh), devices).to(torch.float32)
                        + p0["dt_bias"])
        xh = _heads(_causal_conv(ux, p0["conv_x"]), nh, hd)
        y = ssd_chunked(xh, bh, ch, dt, p0["a_log"], cfg.ssm_chunk)
        y = _out(p0, y, xh, z, x_in.dtype, cfg)
        return gathered(linear_tp(outs, y, devices, di, d), devices)
    hs = nh // n
    w = hs * hd
    zs, uxs = striped(proj("wz", di), devices), striped(proj("wx", di), devices)
    dts = striped(proj("wdt", nh), devices)
    gated = []
    for s, dv in enumerate(devices):
        heads, chans = (s * hs, (s + 1) * hs), (s * w, (s + 1) * w)
        kx = {k: _cols(p0["conv_x"][k], *chans, dv) for k in ("k", "b")}
        xh = _heads(_causal_conv(uxs[s], kx), hs, hd)
        dt = F.softplus(dts[s].to(torch.float32)
                        + _cols(p0["dt_bias"], *heads, dv))
        y = ssd_chunked(xh, bh[:, :, heads[0]:heads[1]].to(dv),
                        ch[:, :, heads[0]:heads[1]].to(dv), dt,
                        _cols(p0["a_log"], *heads, dv), cfg.ssm_chunk)
        y = y + xh * _cols(p0["ssm_d"], *heads, dv)[:, None]
        y = y.reshape(*y.shape[:-2], w).to(x_in.dtype)
        gated.append(y * F.silu(zs[s]))
    normed = layers.rmsnorm_split(p0["out_norm"], gated, devices,
                                  eps=cfg.norm_eps)
    return gathered(linear_tp(outs, normed, devices, di, d), devices)


def final_state(p, ux, ub, dt, cfg) -> torch.Tensor:
    """The state after a prefill, from its pre-conv x / B inputs ``ux`` /
    ``ub`` [B, S, *] and dt [B, S, nh]: one decay-to-end over the whole
    sequence, as the reference's prefill computes it -> [B, nh, hd, ds]
    f32."""
    ds, nh, hd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    ng = cfg.ssm_ngroups
    xh = _heads(_causal_conv(ux, p["conv_x"]), nh, hd)
    bh = _heads(_causal_conv(ub, p["conv_b"]), ng, ds, nh // ng)
    return _final_state(xh, bh, dt, p["a_log"])


def _final_state(xh, bh, dt, a_log) -> torch.Tensor:
    """`final_state` of the heads given: xh [B, S, h, hd], bh [B, S, h,
    ds], dt [B, S, h] (f32) and their ``a_log`` [h]."""
    return _state_from(xh, bh, _input_weights(dt, a_log))


def _input_weights(dt, a_log) -> torch.Tensor:
    """Each token's weight in the final state, ``dt · decay to the end``
    [B, S, h] f32."""
    seg = torch.cumsum(dt * -torch.exp(a_log), dim=1)          # [B, S, h]
    return dt * torch.exp(seg[:, -1:] - seg)


def _state_from(xh, bh, wts) -> torch.Tensor:
    """The state ``Σ_j w_j · B_j ⊗ x_j`` -> [B, h, hd, ds] f32."""
    return einsum_f32("bjhs,bjhd->bhds", bh * wts[..., None], xh)


def _conv_tail(u: torch.Tensor, dc: int) -> torch.Tensor | None:
    """A prefill's last dc−1 pre-conv inputs, or None for a prompt shorter
    than that (the conv cache keeps its zeros, as the reference's)."""
    return u[:, u.shape[1] - (dc - 1):] if u.shape[1] >= dc - 1 else None


def fill_ssm_cache_from_prefill_tp(cache, ps: list, h, cfg, devices: list):
    """`fill_ssm_cache_from_prefill` into a placed SSM cache (``ps``: one
    layer's SSM params a shard; h [B, S, D] replicated). The front
    linears run column-parallel as `ssm_mixer_tp`'s; a conv cache split
    over channels takes each shard's stripe of its pre-conv input (cut
    from the joined input where the linear stays whole), a whole one the
    joined input. A state split over heads (``ssm_nheads % n == 0``) is
    each shard's own heads' final state (B's conv run once on the joined
    B, as `ssm_mixer_tp` runs it); else the heads run on the first
    shard."""
    n = len(devices)
    d, di = cfg.d_model, cfg.d_inner
    ds, nh, hd, ng = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, \
        cfg.ssm_ngroups
    p0 = ps[0]

    def proj(key, width):
        return linear_tp([p[key] for p in ps], h, devices, d, width)

    ux, ub, uc = proj("wx", di), proj("wb", ng * ds), proj("wc", ng * ds)
    dtr = proj("wdt", nh)
    for key, u in (("conv_x", ux), ("conv_b", ub), ("conv_c", uc)):
        if isinstance(cache[key], list):
            for t, us in zip(cache[key], striped(u, devices)):
                tail = _conv_tail(us, cfg.ssm_conv)
                if tail is not None:
                    t.copy_(tail)
        else:
            tail = _conv_tail(gathered(u, devices), cfg.ssm_conv)
            if tail is not None:
                cache[key].copy_(tail)
    bh = _heads(_causal_conv(gathered(ub, devices), p0["conv_b"]), ng, ds,
                nh // ng)
    wts = _input_weights(_dt(p0, dtr, devices), p0["a_log"])  # [B, S, nh]
    if not isinstance(cache["state"], list):
        xh = _heads(_causal_conv(gathered(ux, devices), p0["conv_x"]), nh,
                    hd)
        cache["state"].copy_(_state_from(xh, bh, wts))
        return cache
    hs = nh // n
    for s, (ux_s, dv) in enumerate(zip(striped(ux, devices), devices)):
        lo, hi = s * hs, (s + 1) * hs
        kx = {k: _cols(p0["conv_x"][k], lo * hd, hi * hd, dv)
              for k in ("k", "b")}
        cache["state"][s].copy_(_state_from(
            _heads(_causal_conv(ux_s, kx), hs, hd),
            bh[:, :, lo:hi].to(dv), wts[:, :, lo:hi].to(dv)))
    return cache


def _dt(p0, dtr, devices: list) -> torch.Tensor:
    """The step sizes ``softplus(x·wdt + dt_bias)`` [..., nh] f32 on the
    first shard, from ``wdt``'s column stripes joined (``nh`` columns:
    a few bytes a row). Formed on all heads at once, as the unsplit
    mixer forms them: PyTorch's CPU kernels for ``softplus`` and ``exp``
    take another code path for a stripe of one or two heads, which
    rounds some elements differently."""
    return F.softplus(gathered(dtr, devices).to(torch.float32)
                      + p0["dt_bias"])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, device=None):
    """Conv caches (the last dc-1 pre-conv inputs) and the state, all f32
    whatever the cache dtype of the attention beside it."""
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    gdim = cfg.ssm_ngroups * ds
    dc = cfg.ssm_conv
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv_x": torch.zeros((batch, dc - 1, di), **f32),
            "conv_b": torch.zeros((batch, dc - 1, gdim), **f32),
            "conv_c": torch.zeros((batch, dc - 1, gdim), **f32),
            "state": torch.zeros((batch, nh, cfg.ssm_headdim, ds), **f32)}


def fill_ssm_cache_from_prefill(cache, p, h, cfg):
    """A prefill's conv caches and final state into ``cache``, in place,
    from the block's normed input h [B, S, D] (its linears unnamed): the
    conv caches take the last dc-1 pre-conv inputs (a prompt shorter than
    that keeps the zeros, as the reference does)."""
    dc = cfg.ssm_conv
    ux, ub, uc, dt = _project(p, h, lambda s: None, ("wx", "wb", "wc"))
    if h.shape[1] >= dc - 1:
        for key, u in (("conv_x", ux), ("conv_b", ub), ("conv_c", uc)):
            cache[key].copy_(u[:, h.shape[1] - (dc - 1):])
    cache["state"].copy_(final_state(p, ux, ub, dt, cfg))
    return cache


def ssm_decode(p, cache, x_in: torch.Tensor, cfg, name=None):
    """One-token recurrence. x_in [B, D] -> (y [B, D], cache updated in
    place). Every operation is elementwise or per row but the state read,
    ``h·C`` over ds, which runs in f64 (rounded once): a row's bits do not
    depend on the batch, on the card too."""
    nm = (lambda s: None) if name is None else name
    ds, nh, hd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    ng = cfg.ssm_ngroups
    z, ux, ub, uc, dt = _project(p, x_in, nm)
    x, cx = _conv_step(ux, cache["conv_x"], p["conv_x"])
    bb, cb = _conv_step(ub, cache["conv_b"], p["conv_b"])
    cc, ccs = _conv_step(uc, cache["conv_c"], p["conv_c"])
    xh = _heads(x, nh, hd)                                   # [B, nh, hd]
    bh = _heads(bb, ng, ds, nh // ng)                        # [B, nh, ds]
    ch = _heads(cc, ng, ds, nh // ng)
    da = torch.exp(dt * -torch.exp(p["a_log"]))              # [B, nh]
    y, h = _recur(cache["state"], xh, bh, ch, dt, da)
    y = _out(p, y, xh, z, x_in.dtype, cfg)
    out = linear(p["out_proj"], y, nm("out_proj"))
    for key, new in (("conv_x", cx), ("conv_b", cb), ("conv_c", ccs),
                     ("state", h)):
        cache[key].copy_(new)
    return out, cache


def _conv_step_tp(u, conv_cache, kern: dict, devices: list, join: bool):
    """`_conv_step` under a ``model`` mesh: a conv cache split over
    channels (a list of stripes) steps stripe by stripe on its own
    device (the conv is depthwise), with the stripes of the replicated
    kernel and of ``u`` (cut where its linear stays whole). With
    ``join`` the stripes' sums are joined and the silu runs once on all
    channels (on the CPU, PyTorch's silu takes another code path for a
    stripe a few channels wide, which rounds some elements otherwise);
    else each stripe's output stays on its shard. A whole cache steps on
    the first shard. The caches take their new windows in place."""
    if not isinstance(conv_cache, list):
        out, win = _conv_step(gathered(u, devices), conv_cache, kern)
        conv_cache.copy_(win)
        return out
    outs, lo = [], 0
    for t, us, dv in zip(conv_cache, striped(u, devices), devices):
        w = t.shape[-1]
        pre, win = _conv_sum(us, t, {k: _cols(kern[k], lo, lo + w, dv)
                                     for k in ("k", "b")})
        t.copy_(win)
        outs.append(pre)
        lo += w
    if join:
        return F.silu(concat(outs, -1, devices))
    return [F.silu(o) for o in outs]


def ssm_decode_tp(ps: list, cache, x_in: torch.Tensor, cfg, devices: list
                  ) -> torch.Tensor:
    """`ssm_decode` under a ``model`` mesh (``ps``: one layer's SSM params
    a shard; ``cache``: its `place_cache` piece). x_in [B, D] replicated
    -> y [B, D] replicated; the cache is updated in place.

    The front linears run column-parallel. B's and C's conv steps run on
    their caches' channel stripes and are joined (every head reads every
    group). Where the heads divide over the shards (the state is then
    split over heads, the conv_x cache and ``wx`` over their channels),
    each shard steps its own heads: its x conv, the recurrence, the state
    read ``h·C`` in f64 (rounded once), the D skip and the gate; the gated
    RMSNorm over all of ``d_inner`` sums the shards' sums of squares
    (`layers.rmsnorm_split`) and ``out_proj`` runs row-parallel (or
    flipped). Else z, x and dt are joined and the heads step on the first
    shard, as `ssm_decode`."""
    n = len(devices)
    b, d, di = x_in.shape[0], cfg.d_model, cfg.d_inner
    ds, nh, hd, ng = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, \
        cfg.ssm_ngroups
    p0 = ps[0]

    def proj(key, width):
        return linear_tp([p[key] for p in ps], x_in, devices, d, width)

    z, ux = proj("wz", di), proj("wx", di)
    dt = _dt(p0, proj("wdt", nh), devices)                   # [B, nh]
    da = torch.exp(dt * -torch.exp(p0["a_log"]))
    bb = _conv_step_tp(proj("wb", ng * ds), cache["conv_b"], p0["conv_b"],
                       devices, True)
    cc = _conv_step_tp(proj("wc", ng * ds), cache["conv_c"], p0["conv_c"],
                       devices, True)
    bh = _heads(bb, ng, ds, nh // ng)                        # [B, nh, ds]
    ch = _heads(cc, ng, ds, nh // ng)
    outs = [p["out_proj"] for p in ps]
    if not isinstance(cache["state"], list):
        x = _conv_step_tp(ux, cache["conv_x"], p0["conv_x"], devices, True)
        y, h = _recur(cache["state"], _heads(x, nh, hd), bh, ch, dt, da)
        cache["state"].copy_(h)
        y = _out(p0, y, _heads(x, nh, hd), gathered(z, devices),
                 x_in.dtype, cfg)
        return gathered(linear_tp(outs, y, devices, di, d), devices)
    hs = nh // n
    xs = _conv_step_tp(ux, cache["conv_x"], p0["conv_x"], devices, False)
    zs = striped(z, devices)
    gated = []
    for s, dv in enumerate(devices):
        lo, hi = s * hs, (s + 1) * hs
        xh = _heads(xs[s], hs, hd)
        y, h = _recur(cache["state"][s], xh, bh[:, lo:hi].to(dv),
                      ch[:, lo:hi].to(dv), _cols(dt, lo, hi, dv),
                      _cols(da, lo, hi, dv))
        cache["state"][s].copy_(h)
        y = y + xh * _cols(p0["ssm_d"], lo, hi, dv)[:, None]
        y = y.reshape(b, hs * hd).to(x_in.dtype)
        gated.append(y * F.silu(zs[s]))
    normed = layers.rmsnorm_split(p0["out_norm"], gated, devices,
                                  eps=cfg.norm_eps)
    return gathered(linear_tp(outs, normed, devices, di, d), devices)


def _recur(state, xh, bh, ch, dt, da):
    """One step of the recurrence over the heads given (dt and the decay
    ``da = exp(dt·A)`` [B, h]) -> (y [B, h, hd] f32: the state read
    ``h·C`` in f64, rounded once; the new state)."""
    h = (state * da[:, :, None, None]
         + (dt[:, :, None, None] * bh[:, :, None, :]) * xh[..., None])
    return einsum_f64("bhds,bhs->bhd", h, ch).to(torch.float32), h
