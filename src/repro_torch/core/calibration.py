"""Calibration capture for AWQ — records per-linear input activations.

AWQ needs, per quantized linear, the mean |x| per input channel plus a
small sample of activation rows (to evaluate the reconstruction loss of
each candidate scale). The capture is a context manager that
`layers.linear` consults on every float linear:

    with CalibrationCapture() as cap:
        model.loss(params, calib_batch)
    stats = cap.stats                          # {linear_name: LinearStats}

Statistics live on the host as numpy (copied off the device once per
linear call), exactly as the reference keeps them, so the same capture
names — ``segments/seg_{si}/<path>@<layer>`` — key both packages' stats.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ACTIVE: "CalibrationCapture | None" = None


@dataclasses.dataclass
class LinearStats:
    """Running activation statistics for one linear layer."""

    sum_abs: np.ndarray   # [K] running sum of |x|
    count: int            # rows accumulated
    rows: np.ndarray      # [<=max_rows, K] sampled activation rows

    @property
    def act_mean(self) -> np.ndarray:
        return self.sum_abs / max(self.count, 1)


class CalibrationCapture:
    def __init__(self, max_rows: int = 512):
        self.max_rows = max_rows
        self.stats: dict[str, LinearStats] = {}

    def record(self, name: str, x: torch.Tensor) -> None:
        x = x.detach().to(torch.float32).cpu().numpy().reshape(
            -1, x.shape[-1])
        st = self.stats.get(name)
        if st is None:
            st = LinearStats(sum_abs=np.zeros(x.shape[-1], np.float32),
                             count=0, rows=x[: self.max_rows].copy())
            self.stats[name] = st
        else:
            room = self.max_rows - st.rows.shape[0]
            if room > 0:
                st.rows = np.concatenate([st.rows, x[:room]], axis=0)
        st.sum_abs += np.abs(x).sum(axis=0)
        st.count += x.shape[0]

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("nested CalibrationCapture not supported")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False


def capture_active() -> bool:
    return _ACTIVE is not None


def record_linear_input(name: str | None, x: torch.Tensor) -> None:
    """Called by ``layers.linear`` on every application (no-op when idle)."""
    if _ACTIVE is not None and name is not None:
        _ACTIVE.record(name, x)
