"""Serving fleet specs: a declarative description of a deployment.

A copy of the reference package's `ReplicaSpec` and `FleetSpec`
(`launch/specs.py`); the ShapeDtypeStruct helpers beside them there
belong to the JAX dry run and have no counterpart here. A replica is one
`GenerationEngine` or, with ``disagg=True``, a `DisaggController`
prefill/decode pair. Tensor-parallel widths (``mesh_axis``,
``prefill_mesh_axis``, ``decode_mesh_axis`` > 1) are not ported and raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.disagg import DisaggController
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.router import Router


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One serving replica, declaratively.

    ``mesh_axis`` is the replica's tensor-parallel width (1 = unsharded);
    ``disagg=True`` serves the replica as a `DisaggController`
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
        widths = ((self.prefill_mesh_axis, self.decode_mesh_axis)
                  if self.disagg else (self.mesh_axis,))
        if max(widths) > 1:
            raise NotImplementedError(
                f"tensor-parallel replicas (mesh axes {widths}) are not "
                f"ported to repro_torch yet")
        if self.disagg:
            return DisaggController(model, params, **kw)
        return GenerationEngine(model, params, **kw)


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
