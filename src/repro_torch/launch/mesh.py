"""Small meshes over local devices (tests, examples).

The counterpart of the reference's `launch/mesh.py` as far as serving
goes: `make_host_mesh`. Its `make_production_mesh` builds a TPU pod's
(data, model) mesh and is not ported (ROADMAP, Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``('data', 'model')`` mesh over the first ``data * model``
    devices: this machine's CUDA cards unless ``devices`` is given (a
    list, which may repeat a device to co-locate shards). Too few devices
    raise."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = data * model
    if n < 1 or n > len(devices):
        raise ValueError(f"make_host_mesh(data={data}, model={model}): "
                         f"have {len(devices)} devices")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // model, i % model] = torch.device(d)
    return Mesh(grid, ("data", "model"))
