"""Meshes, sharding rules, collectives: tensor-parallel serving and
training over (data, model), with int8 error-feedback reduction
(`compression`). One controller drives every shard; a multi-rank run
(``torch.distributed``) needs more than one card and is not ported."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES, Mesh, MeshTrainState, NamedSharding, TrainSharding,
    all_sum, batch_axes, cache_pspec, concat, dp_size, join_cache,
    make_sharding, model_devices, paged_cache_pspec, param_pspec,
    place_cache, pspec_tree, replica_meshes, replica_params, serving_mesh,
    shard_cache, shard_params, shard_tree, split, split_batch, split_dim,
    strip_gather, strip_scatter, zero1_pspec)
