"""Fault-tolerant checkpointing: atomic saves, async writer, restore (the
reference's `checkpoint/checkpointer.py`, in its file format).

Format: one ``step_<k>.npz`` per step holding every leaf keyed by the
reference's tree path (`utils.tree`: sorted keys, a list of layers stacked
into one array per path), plus a LATEST pointer written *after* the npz
rename, so a crash mid-save never corrupts the restore point (tmp +
rename + pointer). A checkpoint written by either package restores in the
other leaf for leaf (`bridge.state_to_arrays` / `arrays_to_state`).

A state on a mesh (`distributed.sharding.MeshTrainState`) is saved as its
logical arrays (`MeshTrainState.logical`: replica 0's params, the ZeRO-1
moment slices joined), under the same paths: the file does not depend
on the mesh. The elastic restore (``shardings=``, a
`distributed.sharding.TrainSharding`) splits every leaf onto the target
mesh's shards, whatever mesh wrote the file (the reference's device_put
onto a target NamedSharding). The data pipeline being a pure function of
(seed, step) makes the resume exact end to end.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Any

import numpy as np

from repro_torch.bridge import arrays_to_state, state_to_arrays
from repro_torch.distributed.sharding import MeshTrainState

_LATEST = "LATEST"


def _write(ckpt_dir: str, step: int, leaves: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **leaves)
    os.replace(tmp, path)                      # atomic on POSIX
    ptr_tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, _LATEST))
    return path


def _arrays(state: Any) -> dict:
    if isinstance(state, MeshTrainState):
        state = state.logical()
    return state_to_arrays(state)


def save(ckpt_dir: str, step: int, state: Any) -> str:
    """Atomic synchronous save (a mesh state as its logical arrays).
    Returns the checkpoint file path."""
    return _write(ckpt_dir, step, _arrays(state))


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, _LATEST)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, template: Any, step: int | None = None,
            device=None, shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure and dtypes of ``template`` (``meta``
    tensors, e.g. `train_state_shapes`, are enough) on ``device`` (cuda
    unless the caller asks for another). With ``shardings`` (a
    `TrainSharding`; ``template`` a logical train state) the state is
    split onto its mesh (a `MeshTrainState`; ``device`` is then the
    mesh's first)."""
    if shardings is not None:
        device = shardings.mesh.devices.flat[0]
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as blob:
        state = arrays_to_state(blob, template, device)
    if shardings is not None:
        state = shardings.place(state)
    return state, step


class AsyncCheckpointer:
    """Background-thread writer: the train loop never blocks on disk.

    `save` snapshots to host memory (a device-to-host copy: the only sync
    point), enqueues, and returns; a worker drains the queue with the
    atomic protocol above and keeps the newest ``keep`` checkpoints.
    `wait()` flushes and raises the first error the worker met."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves = item
            try:
                _write(self.ckpt_dir, step, leaves)
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        ckpts = sorted(f for f in os.listdir(self.ckpt_dir)
                       if f.startswith("step_") and f.endswith(".npz"))
        for f in ckpts[:-self.keep]:
            os.remove(os.path.join(self.ckpt_dir, f))

    def save(self, step: int, state: Any) -> None:
        self._q.put((int(step), _arrays(state)))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
