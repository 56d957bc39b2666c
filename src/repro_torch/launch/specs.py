"""Serving fleet specs: a declarative description of a deployment.

A copy of the reference package's `ReplicaSpec` and `FleetSpec`
(`launch/specs.py`); the ShapeDtypeStruct helpers beside them there
belong to the JAX dry run and have no counterpart here. A replica is one
`GenerationEngine` or, with ``disagg=True``, a `DisaggController`
prefill/decode pair. A width above 1 (``mesh_axis``,
``prefill_mesh_axis``, ``decode_mesh_axis``) serves that engine over a
`distributed.serving_mesh` of that many shards.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed.sharding import serving_mesh
from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.router import Router


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
