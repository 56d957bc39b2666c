"""Every dry-run cell's inputs as shapes, and the serving fleet specs.

The shape builders are the reference's (`launch/specs.py`): `batch_specs`,
`param_specs`, `train_state_specs`, `cache_specs` and `decode_token_specs`
give each input leaf of one (arch × shape cell × mesh) as a `LeafSpec`,
a ``meta`` tensor (shape and dtype, no storage: nothing allocates, a
9B-param model included) paired with its `NamedSharding` from the
reference's rules (`param_pspec`, `zero1_pspec`, `cache_pspec`,
`_resolve`). They are keyed by the reference's leaf paths in its order,
a list of layers stacked into one leaf with a leading layer dim, so
shapes, dtypes and specs read as the reference's ``jax.eval_shape``
structs with their shardings; `LeafSpec.shard_shape` / `shard_bytes`
give one device's piece and `shard_bytes` a whole input's bytes a
device.

`ReplicaSpec` and `FleetSpec` are a copy of the reference's: a replica
is one `GenerationEngine` or, with ``disagg=True``, a `DisaggController`
prefill/decode pair. A width above 1 (``mesh_axis``,
``prefill_mesh_axis``, ``decode_mesh_axis``) serves that engine over a
`distributed.serving_mesh` of that many shards.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs import ShapeCell
from repro_torch.configs.base import ModelConfig
from repro_torch.core.awq import AWQConfig
from repro_torch.core.pipeline import quantize_params
from repro_torch.core.quantize import QuantConfig
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              _resolve, cache_pspec,
                                              param_pspec, serving_mesh,
                                              zero1_pspec)
from repro_torch.models.model import Model
from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.router import Router
from repro_torch.training.train_step import train_state_shapes
from repro_torch.utils.tree import layer_parts


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One input leaf: a ``meta`` tensor and where it lives on a mesh."""
    meta: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    def shard_shape(self) -> tuple:
        """One device's piece of the leaf."""
        return self.sharding.shard_shape(self.shape)

    def shard_bytes(self) -> int:
        """One device's bytes of the leaf."""
        return math.prod(self.shard_shape()) * self.meta.element_size()


def shard_bytes(*specs: dict) -> int:
    """Bytes a device of every leaf of the given `LeafSpec` maps. The
    rules split a dim only where the mesh axes divide it, so every device
    holds the same bytes: this is the largest device's."""
    return sum(leaf.shard_bytes() for tree in specs for leaf in tree.values())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def leaf_specs(tree: Any, mesh: Mesh, rule, cfg=None,
               prefix: str = "") -> dict[str, LeafSpec]:
    """``{path: LeafSpec}`` of a port tree in the reference's leaf order,
    each list of layers one leaf with a leading layer dim, its spec
    ``rule(path, leaf, mesh, cfg)`` read on that stacked leaf (as the
    reference reads its rules)."""
    out = {}
    for path, parts, leaf in layer_parts(tree):
        t = (_meta((len(parts), *parts[0].shape), parts[0].dtype)
             if parts is not None else _meta(leaf.shape, leaf.dtype))
        out[prefix + path] = LeafSpec(t, NamedSharding(
            mesh, rule(path, t, mesh, cfg)))
    return out


def _batch_leaf(mesh: Mesh, shape, dtype) -> LeafSpec:
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return LeafSpec(_meta(shape, dtype),
                    NamedSharding(mesh, _resolve(mesh, logical, shape)))


def batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Mesh) -> dict:
    """The global batch of one shape cell: ``tokens`` (a vision model's
    text after its image span, ``images`` beside it), an encoder's
    ``features``, and ``labels`` for a train cell; the batch dim over
    ``(pod, data)``."""
    b, s = cell.global_batch, cell.seq_len
    out: dict = {}
    s_text = s
    if cfg.frontend == "audio":
        out["features"] = _batch_leaf(mesh, (b, s, cfg.frontend_dim),
                                      torch.float32)
    else:
        if cfg.frontend == "vision":
            s_text = s - cfg.num_patches    # image span + text = seq_len
            out["images"] = _batch_leaf(
                mesh, (b, cfg.num_patches, cfg.frontend_dim), torch.float32)
        out["tokens"] = _batch_leaf(mesh, (b, s_text), torch.int32)
    if cell.step == "train":
        out["labels"] = _batch_leaf(mesh, (b, s_text), torch.int32)
    return dict(sorted(out.items()))     # the reference's leaf order


def _param_tree(cfg: ModelConfig, quant: bool) -> dict:
    """The model's params on ``meta``; with ``quant`` every quantizable
    linear AWQ-packed at GS 64 (the shapes RTN and AWQ share)."""
    params = Model(cfg).init(torch.Generator().manual_seed(0),
                             device="meta")
    if quant:
        params = quantize_params(
            params, None, AWQConfig(quant=QuantConfig(group_size=64)))[0]
    return params


def param_specs(cfg: ModelConfig, mesh: Mesh, quant: bool) -> dict:
    """The params (AWQ-packed at GS 64 with ``quant``) under
    `param_pspec`."""
    return leaf_specs(_param_tree(cfg, quant), mesh, param_pspec, cfg)


def train_state_specs(cfg: ModelConfig, mesh: Mesh) -> dict:
    """The train state: ``params/...`` under `param_pspec`, the moments
    ``opt/m/...`` and ``opt/v/...`` cut once more over ``data`` by
    `zero1_pspec` (ZeRO-1), ``step`` replicated."""
    st = train_state_shapes(Model(cfg))
    params = leaf_specs(st["params"], mesh, param_pspec, cfg, "params/")
    out = {}                             # the reference's order: opt, params
    for key in ("m", "v"):
        for path, leaf in params.items():
            moment = path.replace("params/", f"opt/{key}/", 1)
            out[moment] = LeafSpec(_meta(leaf.shape, torch.float32),
                                   NamedSharding(mesh, zero1_pspec(
                                       leaf.spec, leaf.shape, mesh)))
    out.update(params)
    out["step"] = LeafSpec(_meta((), torch.int32), NamedSharding(mesh, ()))
    return out


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int,
                max_seq: int) -> dict:
    """The one-shot decode cache (`Model.init_cache`) under
    `cache_pspec` (SP-decode's sequence stripes where S divides)."""
    cache = Model(cfg).init_cache(batch, max_seq, device="meta")
    return leaf_specs(cache, mesh, cache_pspec, cfg)


def decode_token_specs(mesh: Mesh, batch: int) -> tuple:
    """A decode step's token and position ``[B]``, int32, the batch over
    ``(pod, data)``."""
    return (_batch_leaf(mesh, (batch,), torch.int32),
            _batch_leaf(mesh, (batch,), torch.int32))


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One serving replica, declaratively.

    ``mesh_axis`` is the replica's tensor-parallel width (1 = unsharded;
    the machine must hold ``mesh_axis`` cards, or, for params on the CPU,
    the shards share it); ``disagg=True`` serves the replica as a `DisaggController`
    prefill/decode pair with per-side widths instead of one
    `GenerationEngine`. ``engine_kwargs`` forward verbatim to the engine
    constructor(s) — shape, KV quant, preemption knobs.
    """
    mesh_axis: int = 1
    disagg: bool = False
    prefill_mesh_axis: int = 1
    decode_mesh_axis: int = 1
    engine_kwargs: dict = dataclasses.field(default_factory=dict)

    def build(self, model, params, **overrides):
        """Construct the replica this spec describes."""
        kw = {**self.engine_kwargs, **overrides}
        device = params["embed"]["table"].device

        def mesh(width: int):
            if width <= 1:
                return None
            # CUDA: the first `width` cards (too few raise); the CPU is
            # one device, which the shards share
            return serving_mesh(width, devices=[device] * width
                                if device.type == "cpu" else None)

        if self.disagg:
            return DisaggController(
                model, params, prefill_mesh=mesh(self.prefill_mesh_axis),
                decode_mesh=mesh(self.decode_mesh_axis), **kw)
        return GenerationEngine(model, params, mesh=mesh(self.mesh_axis),
                                **kw)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A whole serving fleet: N replicas of a `ReplicaSpec` behind a
    `serving.router.Router`. ``drain_timeout_s`` bounds how long
    `drain_replica` may step the fleet when scaling down; the placement
    knobs configure the router's scoring. `build` materializes it."""
    replicas: int = 1
    replica: ReplicaSpec = dataclasses.field(default_factory=ReplicaSpec)
    drain_timeout_s: float = 30.0
    placement: str = "affinity"
    affinity_threshold: int = 1
    warmup: bool = False

    def build(self, model, params, **overrides):
        """Build every replica (all sharing ``params``), wrap the router,
        optionally warm each replica's dispatch widths."""
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        fleet = [self.replica.build(model, params, **overrides)
                 for _ in range(self.replicas)]
        router = Router(fleet, placement=self.placement,
                        affinity_threshold=self.affinity_threshold)
        if self.warmup:
            router.warmup()
        return router
