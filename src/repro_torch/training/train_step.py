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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.training.optim import (AdamWConfig, adamw_init,
                                        adamw_update, map_tree)
from repro_torch.utils.tree import layer_parts


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
                   comm_dtype: str = "bfloat16"):
    """(loss, metrics, grads): ``model.loss`` at ``params`` (f32 leaves of
    ndim ≥ 2 cast to ``comm_dtype`` first) and its gradient with respect
    to the uncast params, in their structure: zeros for the leaves
    `Model.unread_leaves` names, None for any other leaf no gradient
    reached."""
    dt = torch_dtype(comm_dtype)
    masters = map_tree(lambda p: p.detach().requires_grad_(True), params)

    def cast(a):
        if dt != torch.float32 and a.dtype == torch.float32 and a.ndim >= 2:
            return a.to(dt)
        return a
    with torch.enable_grad():
        loss, metrics = model.loss(map_tree(cast, masters), batch)
        loss.backward()
    unread = set(model.unread_leaves(params, batch))

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


def make_train_step(model, tcfg: TrainConfig) -> Callable[[dict, dict],
                                                          tuple[dict, dict]]:
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
