"""The train step: mixed-precision backward, optional bf16 gradient
communication, AdamW, metrics (the reference's `training/train_step.py`).

``grad_comm_dtype="bfloat16"`` casts every f32 param with ndim ≥ 2 to
bf16 before the loss, as the reference does (its bf16 gradient
all-reduce; here one card, so only the numerics carry over): the
backward runs through the casts onto the f32 masters, whose gradients
are f32 holding bf16-rounded values. Every layer's attention runs K4
forward and K4b backward on the card (`kernels.flash_attention`), and
with ``cfg.remat`` each block is recomputed in the backward
(`models.stack`). The leaves a batch never reads (`Model.unread_leaves`:
an audio encoder's token table, a vision model's ``patch_proj`` without
images) get zero gradients, as `jax.grad` gives them, so AdamW's weight
decay still moves them as the reference's does; any other parameter
that receives no gradient raises: a cut graph.

Over a ``(data, model)`` mesh (``make_train_step(..., mesh=)``, a
`distributed.sharding.MeshTrainState`): each data replica holds its
params (its ``model`` stripes) and runs its slice of the batch; the loss
is the reference's over the whole batch (`Model.loss(mesh=)`), one
backward reaches every replica's leaves; each replica's gradient is
reduced over ``data`` in replica order (`reduce_grads`: the wire carries
``grad_comm_dtype``, the sum runs in f32 and rounds once to it); a leaf
the ``model`` shards replicate is read on the first shard only, so it
has one gradient, and that one update reaches every copy; AdamW runs
over ZeRO-1 slices (`optim.adamw_update_zero1`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import (MeshTrainState,
                                              record_collective,
                                              replica_share)
from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                        adamw_update, adamw_update_zero1,
                                        map_tree)
from repro_torch.utils.tree import layer_parts, map_with_path


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_comm_dtype: str = "bfloat16"   # "float32" to disable compression


def init_train_state(model, gen: torch.Generator | None = None,
                     device=None) -> dict:
    """``{"params", "opt": {"m", "v"}, "step"}`` on ``device`` (cuda unless
    the caller asks for another); ``gen`` lives on that device."""
    device = resolve_device(device)
    params = model.init(gen, device=device)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train_state_shapes(model) -> dict:
    """The train state's structure, shapes and dtypes as ``meta`` tensors
    (checkpoint templates): nothing is allocated."""
    return init_train_state(model, torch.Generator().manual_seed(0),
                            device="meta")


def loss_and_grads(model, params, batch: dict,
                   comm_dtype: str = "bfloat16", mesh=None):
    """(loss, metrics, grads): ``model.loss`` at ``params`` (f32 leaves of
    ndim ≥ 2 cast to ``comm_dtype`` first) and its gradient with respect
    to the uncast params, in their structure: zeros for the leaves
    `Model.unread_leaves` names, None for any other leaf no gradient
    reached. Under a ``mesh``, ``params`` is a list a data replica of
    its ``model`` shards' trees, and so are the gradients (a replicated
    leaf's on the first shard only)."""
    dt = torch_dtype(comm_dtype)
    masters = map_tree(lambda p: p.detach().requires_grad_(True), params)

    def cast(a):
        if dt != torch.float32 and a.dtype == torch.float32 and a.ndim >= 2:
            return a.to(dt)
        return a
    with torch.enable_grad():
        if mesh is None:
            loss, metrics = model.loss(map_tree(cast, masters), batch)
        else:
            loss, metrics = model.loss(map_tree(cast, masters), batch,
                                       mesh=mesh)
        loss.backward()
    one = params if mesh is None else params[0][0]
    unread = set(model.unread_leaves(one, batch))

    def grad(node, path):
        if isinstance(node, dict):
            return {k: grad(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [grad(v, path) for v in node]
        if node.grad is None and path in unread:
            return torch.zeros_like(node)
        return node.grad
    grads = grad(masters, "")
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def missing_grads(grads) -> list[str]:
    """Paths (the reference's) of the leaves that received no gradient."""
    flags = map_tree(lambda g: torch.tensor(g is None), grads)
    return [path for path, parts, leaf in layer_parts(flags)
            if any(bool(t) for t in (parts if parts is not None else [leaf]))]


def reduce_grads(grads: list, specs, comm_dtype: str, devices: list
                 ) -> tuple[list, int]:
    """The replicas' gradients (``grads``: a list a data replica of its
    ``model`` shards' trees; ``devices[r][m]`` holds replica r's shard m)
    reduced over the replicas, one tree a ``model`` shard → (trees, the
    bytes the replicas put on the wire). Each replica sends its gradient
    in ``comm_dtype``; the sum runs in f32 in replica order 0 … n−1 and
    is rounded once to ``comm_dtype``. A leaf the shards replicate
    (``specs``: model dim None) has its gradient on the first shard
    only: that one reduced gradient stands for every shard. A leaf that
    no gradient reached raises."""
    dt = torch_dtype(comm_dtype)
    paths = map_with_path(lambda path, _: path, specs)
    n_rep, n_model = len(grads), len(grads[0])
    wire = 0

    def red(m):
        def one(sp, path, *gs):
            nonlocal wire
            if sp[0] is None and m > 0:
                return None
            if any(g is None for g in gs):
                raise RuntimeError(f"no gradient reached {path} on model "
                                   f"shard {m}")
            sent = [g.to(dt) for g in gs]
            if n_rep > 1:
                wire += sum(t.numel() * t.element_size() for t in sent)
                if m == 0:            # the first device's operand
                    record_collective("grad_reduce", sent[0])
            acc = sent[0].to(torch.float32)
            for t in sent[1:]:
                acc = acc + t.to(devices[0][m]).to(torch.float32)
            return acc.to(dt).to(torch.float32) if dt != torch.float32 \
                else acc
        return map_tree(one, specs, paths, *[grads[r][m]
                                             for r in range(n_rep)])
    out = [red(m) for m in range(n_model)]
    out = [out[0]] + [map_tree(
        lambda sp, g, g0, _d=devices[0][m]: g0.to(_d) if sp[0] is None
        else g, specs, out[m], out[0]) for m in range(1, n_model)]
    return out, wire


def _mesh_train_step(model, tcfg: TrainConfig, mesh):
    def train_step(state: MeshTrainState, batch: dict):
        sh, specs = state.sharding, state.specs
        with replica_share(len(sh.replicas)):
            loss, metrics, grads = loss_and_grads(
                model, state["params"], batch, tcfg.grad_comm_dtype,
                mesh=mesh)
        devices = [list(rm.devices) for rm in sh.replicas]
        reduced, wire = reduce_grads(grads, specs, tcfg.grad_comm_dtype,
                                     devices)
        del grads
        new_params, new_opt, opt_metrics = adamw_update_zero1(
            state["params"], reduced, state["opt"], state["step"],
            tcfg.optimizer, specs, sh.data_size)
        metrics = {**metrics, **opt_metrics, "loss": loss,
                   "wire_bytes": wire}
        return MeshTrainState({"params": new_params, "opt": new_opt,
                               "step": state["step"] + 1}, sh,
                              specs), metrics
    return train_step


def make_train_step(model, tcfg: TrainConfig, mesh=None
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``step(state, batch) -> (state, metrics)``; under a ``mesh`` the
    state is a `MeshTrainState` (`TrainSharding(mesh, cfg).place`)."""
    if mesh is not None:
        return _mesh_train_step(model, tcfg, mesh)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        device = state["step"].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        loss, metrics, grads = loss_and_grads(model, params, batch,
                                              tcfg.grad_comm_dtype)
        missing = missing_grads(grads)
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, state["opt"], state["step"], tcfg.optimizer)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step
