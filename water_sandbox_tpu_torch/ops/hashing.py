"""Cell coordinates for the bounded bucket grid — the part of
``water_sandbox_tpu/ops/hashing.py`` the fused-kernel pipeline uses. The
reference-hash scheme belongs to ``hash_grid`` mode, not ported yet
(ROADMAP Queue 1 item 7)."""

from __future__ import annotations

import math

import torch


def get_cell(pos: torch.Tensor, h) -> torch.Tensor:
    """floor(p / h) as int32."""
    return torch.floor(pos / h).to(torch.int32)


def grid_origin(predicted: torch.Tensor, h) -> torch.Tensor:
    """Dynamic grid anchor: one cell below the current minimum position."""
    return predicted.amin(dim=0) - h


def key_coords(predicted: torch.Tensor, params, cfg,
               time: torch.Tensor | None) -> torch.Tensor:
    """Coordinates the cell keys are computed from: ``predicted`` itself
    for ``grid_frame == "world"``; for ``"container"`` the positions mapped
    into the box's body frame at ``time`` (an isometry, so the pair set is
    unchanged while the static grid spans only the box interior)."""
    if cfg.grid_frame == "world":
        return predicted
    if time is None:
        raise ValueError(
            "grid_frame='container' needs the sim time for the box pose; "
            "this neighbor pipeline does not thread it")
    from . import integrate as integrate_mod
    center, angle = integrate_mod.container_at(params.container, time)
    return integrate_mod._rotate_yaw(predicted - center, angle, inverse=True)


def default_grid_dims(container_size, smoothing_radius: float,
                      margin: int = 4):
    """Static grid dims covering the container plus a safety margin."""
    return tuple(int(math.ceil(s / smoothing_radius)) + margin
                 for s in container_size)
