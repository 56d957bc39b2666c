"""Meshes over local devices: the production mesh and small host meshes
(the reference's `launch/mesh.py`).

`make_production_mesh` builds the reference's ``(data, model)`` mesh of
16 × 16, or ``(pod, data, model)`` of 2 × 16 × 16, over a list of
devices; `make_host_mesh` a small ``(data, model)`` mesh for tests,
examples and the launchers. Both take this machine's CUDA cards unless
given a device list, which may repeat a device to co-locate shards.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh


def _cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: ``(data, model)`` of 16 × 16, or
    ``(pod, data, model)`` of 2 × 16 × 16 with ``multi_pod``, over the
    first devices of ``devices`` (this machine's cards by default). Too
    few devices raise; more take a prefix."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = _cards() if devices is None else list(devices)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, found "
                           f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(shape), axes)


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``('data', 'model')`` mesh over the first ``data * model``
    devices: this machine's CUDA cards unless ``devices`` is given (a
    list, which may repeat a device to co-locate shards). Too few devices
    raise."""
    if devices is None:
        devices = _cards()
    n = data * model
    if n < 1 or n > len(devices):
        raise ValueError(f"make_host_mesh(data={data}, model={model}): "
                         f"have {len(devices)} devices")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i // model, i % model] = torch.device(d)
    return Mesh(grid, ("data", "model"))
