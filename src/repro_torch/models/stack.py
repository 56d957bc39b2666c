"""Layer stack: a plain per-layer loop over segments of identical kinds.

The reference scans each segment over scan-stacked params; the port keeps
one parameter dict per layer (``params[seg_i]`` is a list) and one cache
entry per layer, and loops. While a `CalibrationCapture` is active the
loop names every linear ``segments/seg_{si}/<path>@<i>``, the reference's
capture names letter for letter, which `core.pipeline` reads back.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import numerics
from repro_torch.core import calibration
from repro_torch.models import blocks


def seg_name(si: int) -> str:
    return f"seg_{si}"


def stack_init(gen, cfg, dtype=torch.float32, device=None):
    """Params: {"seg_0": [layer params, ...], ...}."""
    return {seg_name(si): [blocks.block_init(gen, cfg, kind, dtype, device)
                           for _ in range(n)]
            for si, (kind, n) in enumerate(cfg.segments())}


def stack_init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                     device=None):
    return {seg_name(si): [blocks.init_block_cache(cfg, kind, batch, max_seq,
                                                   dtype, device)
                           for _ in range(n)]
            for si, (kind, n) in enumerate(cfg.segments())}


def stack_init_paged_cache(cfg, num_pages: int, page_size: int,
                           dtype=torch.bfloat16, kv_quant: str | None = None,
                           device=None, *, num_slots: int | None = None,
                           slot_seq: int | None = None):
    return {seg_name(si): [blocks.init_block_cache_paged(
                cfg, kind, num_pages, page_size, dtype, kv_quant, device,
                num_slots=num_slots, slot_seq=slot_seq)
                           for _ in range(n)]
            for si, (kind, n) in enumerate(cfg.segments())}


def _remat_block(p, x, cfg, kind, positions):
    """One train-mode block, as `torch.utils.checkpoint` recomputes it in
    the backward: inside `numerics.free_rows` itself, since the backward
    runs after `stack_apply`'s own context has closed, and the recompute
    must repeat the forward's bits. Returns (x, aux loss)."""
    with numerics.free_rows():
        x, _, aux = blocks.block_apply(p, x, cfg, kind, mode="train",
                                       positions=positions)
    return x, aux


def stack_apply(params, x, cfg, *, mode: str, positions, cache=None,
                page_table=None, rpos=None, amask=None):
    """Run all layers. Returns (x, cache, the sum of the MoE layers' aux
    losses, None without one); caches update in place. A
    full-sequence forward (train, prefill) runs its linears as one call
    each (`numerics.free_rows`); serving steps keep a row's bits
    independent of the step's row count. With ``cfg.remat``, a train
    forward under grad checkpoints each block (the reference's
    `jax.checkpoint`): the backward recomputes it, K4 included."""
    capture = calibration.capture_active()
    auxes = []                  # the MoE layers' aux losses, in order
    remat = (cfg.remat and mode == "train" and torch.is_grad_enabled()
             and not capture)
    with numerics.free_rows(mode in ("train", "prefill")):
        for si, (kind, n) in enumerate(cfg.segments()):
            p_seg = params[seg_name(si)]
            c_seg = cache[seg_name(si)] if cache is not None else None
            for i in range(n):
                if remat:
                    x, aux = checkpoint(_remat_block, p_seg[i], x, cfg, kind,
                                        positions, use_reentrant=False)
                    auxes += [] if aux is None else [aux]
                    continue
                nm = ((lambda local, _si=si, _i=i:
                       f"segments/{seg_name(_si)}/{local}@{_i}")
                      if capture else None)
                x, c_new, aux = blocks.block_apply(
                    p_seg[i], x, cfg, kind, mode=mode, positions=positions,
                    cache=None if c_seg is None else c_seg[i], name=nm,
                    page_table=page_table, rpos=rpos, amask=amask)
                auxes += [] if aux is None else [aux]
                if c_seg is not None:
                    c_seg[i] = c_new
    return x, cache, sum(auxes) if auxes else None
