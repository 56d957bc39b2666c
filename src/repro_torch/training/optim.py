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
order differ. Updates are functional (new tensors), as the reference's;
the ZeRO-1 moment sharding is not ported (no meshes yet).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.tree import layer_parts


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


def map_tree(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over a port tree (dicts and lists of
    tensors), keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


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


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves added in
    the reference's order (a stacked path's layers summed first)."""
    total = 0
    for _, parts, leaf in layer_parts(tree):
        if parts is None:
            sq = torch.sum(torch.square(leaf.to(torch.float32)))
        else:
            sq = sum(torch.sum(torch.square(t.to(torch.float32)))
                     for t in parts)
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return map_tree(lambda g: g.to(torch.float32) * scale, grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, opt, step, cfg: AdamWConfig):
    """One AdamW step → (new params, {"m", "v"}, {"grad_norm", "lr"}).
    grads may be bf16; params stay in their master dtype."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = lr_at(cfg, step)
    t = _f32(step) + 1
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    new_m = map_tree(lambda g, m: cfg.b1 * m + (1 - cfg.b1) * g, grads,
                     opt["m"])
    new_v = map_tree(lambda g, v: cfg.b2 * v + (1 - cfg.b2) * g * g, grads,
                     opt["v"])

    def upd(p, m, v):
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype)
    new_p = map_tree(upd, params, new_m, new_v)
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
