"""Primitive modules (plain functions: init → nested dict, apply → tensor).

`linear` is the single matmul entry point: float weights or a
`PackedLinear` (AWQ-quantized), which dispatches through `qlinear_apply`.
Float linears record their input when a `CalibrationCapture` is active
(the AWQ pipeline's hook into every projection).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import calibration
from repro_torch.core.packing import PackedLinear
from repro_torch.core.qlinear import (fusable_gateup, qgateup_apply,
                                      qlinear_apply, qlinear_partial,
                                      qlinear_prescale)
from repro_torch.distributed.sharding import all_sum, concat, split
from repro_torch.numerics import matmul_f32_rows, matmul_wide_rows, wide


# ---------------------------------------------------------------------- init
# Same distributions as the reference: N(0, 1/K) linears with zero bias,
# unit RMSNorm gains, N(0, 0.02²) embeddings. Draws come from an explicit
# torch.Generator on the target device, so they differ from jax.random.

def linear_init(gen: torch.Generator, k: int, n: int, *, bias: bool = False,
                dtype=torch.float32, scale: float | None = None,
                device=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(k)
    w = torch.randn((k, n), generator=gen, device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def norm_init(d: int, *, norm_type: str = "rmsnorm", dtype=torch.float32,
              plus_one: bool = False, device=None):
    gamma = (torch.zeros if plus_one else torch.ones)((d,), dtype=dtype,
                                                      device=device)
    p = {"gamma": gamma}
    if norm_type == "layernorm":
        p["beta"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None):
    t = torch.randn((vocab, d), generator=gen, device=device) * 0.02
    return {"table": t.to(dtype)}


# --------------------------------------------------------------------- apply

def linear(p, x: torch.Tensor, name: str | None = None) -> torch.Tensor:
    """``y = x @ w (+ b)``: float weights in x's dtype with f32
    accumulation (recording x under ``name`` during calibration), or the
    quantized dispatch for a `PackedLinear`. A row's bits do not depend
    on how many rows share the call (`numerics.matmul_f32_rows`; one call
    inside a full-sequence forward, `numerics.free_rows`)."""
    if isinstance(p, PackedLinear):
        return qlinear_apply(p, x)
    calibration.record_linear_input(name, x)
    w = p["w"]
    y = matmul_f32_rows(x, w.to(x.dtype)).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ------------------------------------------------------- tensor parallelism
# Under a ``model`` mesh a linear's weight is one piece a shard (lists in
# shard order), and an activation is either replicated (one tensor, on
# the first shard's device) or split over its last dim (a list of the
# shards' pieces). `linear_tp` maps one to the other by the weight's
# split, which it reads off the shard's shape against the unsharded
# ``(k, n)``.

def _kn(p) -> tuple[int, int]:
    if isinstance(p, PackedLinear):
        return p.k, p.n
    return p["w"].shape[-2], p["w"].shape[-1]


def linear_partial(p, x: torch.Tensor) -> torch.Tensor:
    """One shard's unrounded partial product of a row-parallel linear,
    without its bias (`numerics.matmul_wide_rows`; a `PackedLinear`'s:
    `qlinear_partial`)."""
    if isinstance(p, PackedLinear):
        return qlinear_partial(p, x)
    return matmul_wide_rows(x, p["w"].to(x.dtype))


def linear_tp(ps: list, x, devices: list, k: int, n: int):
    """``linear`` over the shards of a ``[k, n]`` linear.

      * column-parallel (N split): replicated ``x`` in, one output piece
        a shard out (a list; each shard adds its bias slice);
      * row-parallel (K split): the input's pieces (a replicated ``x`` is
        cut), partial products summed in shard order, rounded once to
        ``x``'s dtype, the bias added once: a replicated output;
      * a packed row-parallel linear flipped to N (a K-shard would split
        quant groups): its input scale stays split over K, so each shard
        scales its own slice of the input (`qlinear_prescale`; a
        replicated input is cut first), the slices are joined,
        every shard computes its N columns of the whole input, and the
        columns are joined: a replicated output; where the rule cuts
        neither K nor N of its words but still its input scale (K
        divides, K / 8 does not), the scaled slices are joined and the
        first shard runs the whole product;
      * replicated: one call on the whole input.
    """
    pk, pn = _kn(ps[0])
    split_in = isinstance(x, list)
    flipped = isinstance(ps[0], PackedLinear) and pk == k \
        and ps[0].input_scale is not None and ps[0].input_scale.shape[-1] < k
    if flipped and not split_in:
        x, split_in = split(x, -1, devices), True
    if flipped or (pn < n and split_in):
        dt = x[0].dtype
        scaled = concat([qlinear_prescale(p, xi) for p, xi in zip(ps, x)],
                        -1, devices)
        outs = [qlinear_apply(dataclasses.replace(p, input_scale=None),
                              scaled.to(d), out_dtype=dt)
                for p, d in zip(ps, devices)]
        return concat(outs, -1, devices) if pn < n else outs[0]
    if pn < n and isinstance(ps[0], PackedLinear):
        return [linear(p, x.to(d)) for p, d in zip(ps, devices)]
    if pn < n:
        # x widened once for every shard's columns: on the CPU the
        # shards' gradients of x then add in float64 and round once, as
        # the unsharded product's do (the forward's bits are `linear`'s)
        xw, dt = wide(x), x.dtype
        outs = []
        for p, d in zip(ps, devices):
            y = matmul_wide_rows(xw.to(d), p["w"].to(dt)).to(
                torch.float32).to(dt)
            outs.append(y + p["b"].to(dt) if "b" in p else y)
        return outs
    if pk < k:
        if not split_in:
            x = split(x, -1, devices)
        dt = x[0].dtype
        y = all_sum([linear_partial(p, xi) for p, xi in zip(ps, x)],
                    devices).to(torch.float32).to(dt)
        bias = ps[0].bias if isinstance(ps[0], PackedLinear) \
            else ps[0].get("b")
        return y if bias is None else y + bias.to(dt)
    if split_in:
        x = concat(x, -1, devices)
    return linear(ps[0], x)


def gathered(y, devices: list) -> torch.Tensor:
    """A `linear_tp` output made replicated: column pieces joined in shard
    order on the first shard's device."""
    return concat(y, -1, devices) if isinstance(y, list) else y


def striped(y, devices: list) -> list:
    """A `linear_tp` output as one piece a shard over its last dim (a
    replicated output is cut)."""
    return y if isinstance(y, list) else split(y, -1, devices)


def mlp_tp(mps: list, x, act: str, devices: list, d: int, f: int,
           glu: bool = True):
    """A dense MLP (a block's, or a MoE layer's shared experts) over the
    shards: ``gate`` / ``up`` column-parallel (each shard its d_ff slice:
    K3 on the local N where the pair is fusable), the activation per
    shard, ``down`` row-parallel (or flipped, `linear_tp`). Replicated x
    in and out."""
    fused = glu and fusable_gateup(mps[0]["gate"], mps[0]["up"], act)
    if fused and mps[0]["gate"].n < f:
        h = [qgateup_apply(mp["gate"], mp["up"], x.to(dv))
             for mp, dv in zip(mps, devices)]
    elif fused:
        h = qgateup_apply(mps[0]["gate"], mps[0]["up"], x)
    else:
        up = linear_tp([mp["up"] for mp in mps], x, devices, d, f)
        if glu:
            gate = linear_tp([mp["gate"] for mp in mps], x, devices, d, f)
            h = ([activation(act, g) * u for g, u in zip(gate, up)]
                 if isinstance(up, list) else activation(act, gate) * up)
        else:
            h = ([activation(act, u) for u in up]
                 if isinstance(up, list) else activation(act, up))
    return gathered(linear_tp([mp["down"] for mp in mps], h, devices, f, d),
                    devices)


def embed_lookup_tp(tables: list, tokens: torch.Tensor, devices: list,
                    vocab: int, d_model: int, *, scale: bool = False
                    ) -> torch.Tensor:
    """`embed_lookup` over a sharded table: vocab-parallel (each shard
    looks up the tokens in its rows, zeros elsewhere, and the pieces are
    summed: exact, one term is non-zero), split over d (the pieces are
    joined), or replicated. Returns the replicated ``[..., D]``."""
    t0 = tables[0]
    if t0.shape[0] < vocab:
        rows = t0.shape[0]
        parts = []
        for s, (t, d) in enumerate(zip(tables, devices)):
            local = tokens.to(d).long() - s * rows
            hit = (local >= 0) & (local < rows)
            x = t[local.clamp(0, rows - 1)]
            parts.append(torch.where(hit[..., None], x, torch.zeros_like(x)))
        x = all_sum(parts, devices)
    elif t0.shape[1] < d_model:
        x = concat([t[tokens.to(d).long()] for t, d in zip(tables, devices)],
                   -1, devices)
    else:
        x = t0[tokens.long()]
    if scale:
        x = x * math.sqrt(d_model)
    return x


def _staged_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (keepdim), with a row's bits the same
    whatever the number of rows beside it.

    PyTorch's CUDA reduction sizes its lanes per output from the number of
    outputs once an output reduces more than 32 terms (`Reduce.cuh`,
    ``set_block_dimension``), so one reduction over d_model would give a
    row other bits in a chunk step of width 1 than of width 16. On CUDA
    the mean is taken in stages of at most 32 terms per output, each with
    a fixed lane layout (d_model 896 = 28 × 32: two stages). A width that
    a stage cannot split is padded with zeros and the mean scaled back.
    Other devices take one reduction."""
    if t.device.type != "cuda":
        return t.mean(dim=-1, keepdim=True)
    d, div = t.shape[-1], 1
    while t.shape[-1] > 32:
        if t.shape[-1] % 32:
            t = F.pad(t, (0, 32 - t.shape[-1] % 32))
        t = t.unflatten(-1, (-1, 32)).mean(-1)
        div *= 32
    div *= t.shape[-1]
    m = t.mean(-1, keepdim=True)
    return m if div == d else m * (div / d)


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in f32 (the paper's PS-side non-linear op)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(_staged_mean(xf * xf) + eps)
    g = p["gamma"].to(torch.float32)
    if plus_one:
        g = 1.0 + g
    return (xf * g).to(dt)


def rmsnorm_split(p, parts: list, devices: list, *, eps: float = 1e-6
                  ) -> list:
    """`rmsnorm` of an activation split over its last dim (``parts``: one
    stripe a shard, in shard order): each shard's sum of squares (its
    staged mean times its width, `_staged_mean`'s rule, so a row's bits do
    not depend on the row count), summed in shard order on the first
    shard, one rsqrt; each stripe scaled by it and by its slice of the
    gain (``p``: the replicated gain, the first shard's copy, so only it
    takes a gradient). Returns the normed stripes on their devices."""
    d = sum(t.shape[-1] for t in parts)
    sq = all_sum([_staged_mean(t.to(torch.float32) ** 2) * t.shape[-1]
                  for t in parts], devices)
    r = torch.rsqrt(sq / d + eps)
    g = p["gamma"].to(torch.float32)
    out, lo = [], 0
    for t, dv in zip(parts, devices):
        w = t.shape[-1]
        out.append((t.to(torch.float32) * r.to(dv)
                    * g[lo:lo + w].to(dv)).to(t.dtype))
        lo += w
    return out


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32; mean and variance staged as `rmsnorm`'s mean
    square (`_staged_mean`), so a row's bits do not depend on the row
    count on CUDA."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = _staged_mean(xf)
    var = _staged_mean((xf - mu) ** 2)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["gamma"].to(torch.float32)
            + p["beta"].to(torch.float32)).to(dt)


def norm(p, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(p, x, eps=cfg.norm_eps)
    return rmsnorm(p, x, eps=cfg.norm_eps, plus_one=cfg.rms_plus_one)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def embed_lookup(p, tokens: torch.Tensor, *, scale: bool = False
                 ) -> torch.Tensor:
    table = p["table"]
    x = table[tokens.long()]
    if scale:
        x = x * math.sqrt(table.shape[-1])
    return x


# ---------------------------------------------------------------------- RoPE

def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[..., rot_dim/2]`` for integer positions."""
    half = rot_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs   # [..., half]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` channels of ``x [..., H, hd]``; cos/sin
    ``[..., rot_dim/2]`` broadcast over the head axis."""
    half = rot_dim // 2
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., :half], xr[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if rot_dim < x.shape[-1]:
        out = torch.cat([out, xp], dim=-1)
    return out
