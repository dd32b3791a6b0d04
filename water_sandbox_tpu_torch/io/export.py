"""Trajectory export, a copy of ``water_sandbox_tpu/io/export.py`` (that
module imports no JAX, but its package does): the same file format, so a
trajectory written by either package loads in the other.

Format: .npz with positions (T, n, dim) float32, times (T,), and a JSON
metadata string (scene params snapshot).
"""

from __future__ import annotations

import json

import numpy as np


class TrajectoryWriter:
    """Accumulates frames host-side; write() dumps one npz. Frames are host
    arrays (``Simulation.positions()``), not device tensors."""

    def __init__(self, path: str, metadata: dict | None = None):
        self.path = path
        self.metadata = metadata or {}
        self._frames: list[np.ndarray] = []
        self._times: list[float] = []

    def add_frame(self, positions, time: float):
        self._frames.append(np.asarray(positions, np.float32))
        self._times.append(float(time))

    def write(self):
        np.savez_compressed(
            self.path,
            positions=np.stack(self._frames) if self._frames else
            np.zeros((0, 0, 0), np.float32),
            times=np.asarray(self._times, np.float32),
            metadata=np.asarray(json.dumps(self.metadata)),
        )
        return self.path


def load_trajectory(path: str):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["metadata"]))
    return data["positions"], data["times"], meta
