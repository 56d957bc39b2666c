"""AdamW with warmup, cosine decay and global-norm clipping (the
reference's `training/optim.py`, in plain PyTorch tensor ops).

The reference's formulas, term for term: ``lr_at`` warms up linearly and
decays on a cosine to ``min_lr_ratio``; gradients are clipped by their
global norm, summed over the leaves in the reference's order
(`utils.tree.layer_parts`: sorted keys, a list of layers as one stacked
leaf); moments live in f32 whatever the param's dtype; the bias
corrections divide m and v before the square root (``bc2`` inside it),
weight decay enters the step as ``wd · p``, and params come back in their
own dtype. `torch.optim.AdamW` is not used: its eps placement and update
order differ. Updates are functional (new tensors), as the reference's.

On a mesh (`adamw_update_zero1`, ZeRO-1): each data replica updates its
`zero1_pspec` slice of ``m``, ``v`` and the params from the reduced
gradient, and the updated slices are then joined back into every
replica's params, each replica getting tensors of its own; `global_norm`
counts each logical element once however the shards store it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import (join_pieces, narrow_piece,
                                              record_collective)
from repro_torch.utils.tree import layer_parts, map_tree  # noqa: F401


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay → floor (an f32 scalar tensor)."""
    step = _f32(step)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def _sq(parts, leaf, device=None) -> torch.Tensor:
    ts = parts if parts is not None else [leaf]
    return sum(torch.sum(torch.square(t.to(torch.float32))).to(device)
               for t in ts)


@torch.no_grad()
def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every logical element, in f32, leaves
    added in the reference's order (a stacked path's layers summed
    first). With ``specs`` (`TrainSharding.specs`), ``tree`` is one tree
    a ``model`` shard: a split leaf adds every shard's stripe, a
    replicated one its first shard's copy only."""
    if specs is None:
        total = 0
        for _, parts, leaf in layer_parts(tree):
            total = total + _sq(parts, leaf)
        return torch.sqrt(total)
    walks = [list(layer_parts(t)) for t in tree]
    dev = walks[0][0][2].device if walks[0][0][1] is None \
        else walks[0][0][1][0].device
    total = 0
    for i, (_, sparts, sleaf) in enumerate(layer_parts(specs)):
        split = (sparts[0] if sparts is not None else sleaf)[0] is not None
        for w in (walks if split else walks[:1]):
            total = total + _sq(w[i][1], w[i][2], dev)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return map_tree(lambda g: g.to(torch.float32) * scale, grads), gnorm


def _schedule(cfg: AdamWConfig, step):
    """(lr, bc1, bc2) at ``step``: the rate and both bias corrections."""
    t = _f32(step) + 1
    return lr_at(cfg, step), 1.0 - torch.pow(cfg.b1, t), \
        1.0 - torch.pow(cfg.b2, t)


def _adam(cfg: AdamWConfig, lr, bc1, bc2, p, g, m, v):
    """AdamW on matching elements (g clipped, f32) → (new p, m, v)."""
    dev = p.device
    pf = p.to(torch.float32)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m / bc1.to(dev)) / (torch.sqrt(v / bc2.to(dev)) + cfg.eps) \
        + cfg.weight_decay * pf
    return (pf - lr.to(dev) * delta).to(p.dtype), m, v


def _unzip(tree, n: int = 3) -> list:
    return [map_tree(lambda t, _i=i: t[_i], tree) for i in range(n)]


@torch.no_grad()
def adamw_update(params, grads, opt, step, cfg: AdamWConfig):
    """One AdamW step → (new params, {"m", "v"}, {"grad_norm", "lr"}).
    grads may be bf16; params stay in their master dtype."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr, bc1, bc2 = _schedule(cfg, step)
    new_p, new_m, new_v = _unzip(map_tree(
        lambda p, g, m, v: _adam(cfg, lr, bc1, bc2, p, g, m, v),
        params, grads, opt["m"], opt["v"]))
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_zero1(params: list, grads: list, opt: dict, step,
                       cfg: AdamWConfig, specs, data_size: int):
    """One AdamW step over ZeRO-1 slices → (new params, {"m", "v"},
    {"grad_norm", "lr"}).

    ``params``: one list of ``model``-shard trees a data replica;
    ``grads``: the reduced gradient, one tree a ``model`` shard;
    ``opt``: ``m`` / ``v`` in ``params``' layout, replica r holding slice
    ``r mod data_size`` along each leaf's ZeRO-1 dim (``specs``: ``(model
    dim, data dim)`` a leaf), a leaf the ``model`` shards replicate on the
    first shard only (None on the others). Replica r updates its slice of
    the params, m and v (`adamw_update`'s formula, element by element);
    each replica's params are then the slices joined in order (a leaf
    without a ZeRO-1 dim: the replica's own update), a replicated leaf's
    one update copied to every shard. Clipping reads the logical norm."""
    gnorm = global_norm(grads, specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr, bc1, bc2 = _schedule(cfg, step)
    dn = data_size
    pieces, new_m, new_v = [], [], []
    for r, shards in enumerate(params):
        i = r % dn

        def piece(sp, p, g, m, v):
            if m is None:                # a replicated leaf off shard 0
                return None, None, None
            g = narrow_piece(g.to(p.device), sp[1], i, dn) \
                .to(torch.float32) * scale.to(p.device)
            return _adam(cfg, lr, bc1, bc2, narrow_piece(p, sp[1], i, dn),
                         g, m, v)
        done = [_unzip(map_tree(piece, specs, p, g, m, v))
                for p, g, m, v in zip(shards, grads, opt["m"][r],
                                      opt["v"][r])]
        pieces.append([d[0] for d in done])
        new_m.append([d[1] for d in done])
        new_v.append([d[2] for d in done])
    new_p = []
    for r, shards in enumerate(params):
        base = r - r % dn
        row = []
        for mi, shard in enumerate(shards):
            def leaf(sp, old, *sl, _mi=mi, _r=r - base):
                src = sl[dn:] if sp[0] is None else sl[:dn]
                if sp[1] is not None:
                    if dn > 1 and r == 0 and _mi == 0:   # the first
                        record_collective("zero1_gather", src[0])  # device's
                    return join_pieces(list(src), sp[1], old.device)
                # a replicated leaf's one update, made on the first shard:
                # every other shard takes a copy of its own
                if sp[0] is None and _mi > 0:
                    return src[_r].to(old.device, copy=True)
                return src[_r]
            row.append(map_tree(
                leaf, specs, shard,
                *[pieces[base + j][mi] for j in range(dn)],
                *[pieces[base + j][0] for j in range(dn)]))
        new_p.append(row)
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
