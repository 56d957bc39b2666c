"""Gradient compression: int8 all-reduce with error feedback (the
reference's `distributed/compression.py`).

Each data shard quantizes its local gradient plus its residual (``ef``)
against one scale a tensor shared by all shards, and keeps what the
codes dropped as the next step's residual, so the accumulated update
stays unbiased (EF-SGD). The reduction (`int8_psum_mean`) is explicit
and runs in shard order 0 … n−1: the scale is the max over shards of
``|g + ef|``, divided by 127 (1 where it is 0); the int8 codes are summed
in int32; the mean is taken in f32. On the wire: one f32 scalar (the
scale agreement) and one int8 code an element a shard.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import map_tree


def quantize_ef(g: torch.Tensor, ef: torch.Tensor, scale: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``g + ef`` to int8 at ``scale`` → (codes, new ef)."""
    x = g.to(torch.float32) + ef
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, x - q.to(torch.float32) * scale


def int8_psum_mean(gs: list, efs: list, devices: list):
    """Mean over the shards of one tensor's gradient through int8 codes
    and error feedback. ``gs[s]`` / ``efs[s]``: shard s's gradient and
    residual as a list of pieces (a stacked reference leaf's layers, or
    one tensor), on ``devices[s]``; one scale covers every piece, as one
    reference leaf has one. → (the mean's pieces on the first shard's
    device, each shard's new residual pieces, the scale, the bytes the
    shards put on the wire)."""
    dev = devices[0]
    amax = None
    for g, e in zip(gs, efs):
        for gp, ep in zip(g, e):
            m = torch.max(torch.abs(gp.to(torch.float32) + ep)).to(dev)
            amax = m if amax is None else torch.maximum(amax, m)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    totals, new_efs, wire = None, [], 0
    for g, e, d in zip(gs, efs, devices):
        sd = scale.to(d)
        coded = [quantize_ef(gp, ep, sd) for gp, ep in zip(g, e)]
        new_efs.append([ne for _, ne in coded])
        wire += sum(q.numel() * q.element_size() for q, _ in coded) + 4
        qs = [q.to(dev).to(torch.int32) for q, _ in coded]
        totals = qs if totals is None else [t + q for t, q in
                                            zip(totals, qs)]
    means = [t.to(torch.float32) * scale / len(gs) for t in totals]
    return means, new_efs, scale, wire


def init_ef(grads_like):
    """Zero residuals in f32, in ``grads_like``'s structure."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
