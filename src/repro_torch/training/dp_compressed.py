"""Data-parallel train step with an explicit int8 + error-feedback
gradient reduction (the reference's `training/dp_compressed.py`).

The main train path (`training.train_step`, over a mesh) reduces the
gradient in ``grad_comm_dtype``; this variant sends int8 codes below it,
the pattern meant for the cross-pod hop. Its semantics are the
reference's, which differ from the main path's:

  * each data shard runs its own ``model.loss`` on its slice of the batch
    (`distributed.sharding.split_batch`) at the replicated params, in f32;
  * the reported loss is the mean of the shard losses (the reference's
    ``pmean``), and a MoE layer's aux loss stays each shard's own;
  * gradients cross the wire as int8 codes plus one f32 scale a tensor
    (`distributed.compression.int8_psum_mean`, shards in order; a tensor
    is a reference leaf: a stacked path's layers share one scale), or as
    f32 with ``compress=False`` (their mean in shard order);
  * AdamW applies the reduced gradient once to the replicated params;
  * the error-feedback residual is per-shard state: one leading dim of
    size `dp_degree` a leaf (each layer's leaf ``[n_dp, ...]``; the
    reference stacks a path's layers after that dim, `bridge.
    ef_to_arrays` / `ef_to_torch` carry it across).

One controller drives the shards, as everywhere in the port.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.compression import int8_psum_mean
from repro_torch.distributed.sharding import (dp_size, record_collective,
                                              replica_meshes, split_batch)
from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                        adamw_update, map_tree)
from repro_torch.training.train_step import loss_and_grads
from repro_torch.utils.tree import from_parts, layer_parts


def dp_degree(mesh) -> int:
    """The number of data shards: the product of the ``pod`` and
    ``data`` axes."""
    return dp_size(mesh)


def init_dp_state(model, gen: torch.Generator | None, mesh, device=None
                  ) -> tuple[dict, dict]:
    """→ (train state on ``device``, per-shard EF residuals ``[n_dp,
    ...]`` of zeros, f32)."""
    device = resolve_device(device)
    params = model.init(gen, device=device)
    n = dp_degree(mesh)
    ef = map_tree(lambda p: torch.zeros((n,) + tuple(p.shape),
                                        dtype=torch.float32,
                                        device=p.device), params)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, ef


def make_dp_train_step(model, mesh, opt_cfg: AdamWConfig,
                       compress: bool = True):
    """``step(state, ef, batch) -> (state, ef, metrics)``; metrics add
    ``wire_bytes`` (what the shards sent) and, with ``compress``,
    ``ef_over_scale`` (the largest residual over its tensor's scale:
    at most 1/2)."""
    devices = [rm.devices[0] for rm in replica_meshes(mesh)]
    n = len(devices)

    def step(state: dict, ef: dict, batch: dict):
        params = state["params"]
        losses, grads = [], []
        for b, d in zip(split_batch(batch, mesh), devices):
            loss, _, g = loss_and_grads(model, map_tree(
                lambda p: p.to(d), params), b, "float32")
            losses.append(loss.to(devices[0]))
            grads.append(g)
        loss = sum(losses[1:], losses[0]) / n
        wire = 0
        if compress:
            red, new_ef, ratio = {}, {}, torch.zeros((), device=devices[0])
            flat = [dict((p, parts or [leaf])
                         for p, parts, leaf in layer_parts(t))
                    for t in grads]
            for path, parts, leaf in layer_parts(ef):
                es = parts or [leaf]
                means, efs, scale, sent = int8_psum_mean(
                    [f[path] for f in flat],
                    [[e[i].to(d) for e in es]
                     for i, d in enumerate(devices)], devices)
                wire += sent
                record_collective("int8_reduce", sent / n)
                red[path] = means
                new_ef[path] = [torch.stack([efs[i][k].to(e.device)
                                             for i in range(n)])
                                for k, e in enumerate(es)]
                ratio = torch.maximum(ratio, torch.stack(
                    [x.abs().max().to(devices[0]) for x in new_ef[path]]
                ).max() / scale)
            red = from_parts(params, red)
            ef = from_parts(ef, new_ef)
        else:
            def mean(*gs):
                nonlocal wire
                wire += sum(g.numel() * 4 for g in gs)
                record_collective("grad_reduce", gs[0].numel() * 4)
                acc = gs[0].to(torch.float32)
                for g in gs[1:]:
                    acc = acc + g.to(devices[0]).to(torch.float32)
                return acc / n
            red = map_tree(mean, *grads)
        del grads
        params, opt, opt_metrics = adamw_update(
            params, red, state["opt"], state["step"], opt_cfg)
        metrics = {"loss": loss, **opt_metrics, "wire_bytes": wire}
        if compress:
            metrics["ef_over_scale"] = ratio
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                ef, metrics)

    return step
