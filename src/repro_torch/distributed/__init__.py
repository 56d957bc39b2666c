"""Tensor-parallel serving: meshes, sharding rules, collectives."""
from repro_torch.distributed.sharding import (  # noqa: F401
    Mesh, all_sum, concat, model_devices, paged_cache_pspec, param_pspec,
    serving_mesh, shard_params, shard_tree, split, split_dim, strip_gather,
    strip_scatter)
