"""Scene definitions and the scene registry — the counterpart of
``water_sandbox_tpu/models/scenes.py``: the same 7 scenes with the same
configurations, built with numpy on the host. ``build(name, device=...)``
returns (SimConfig, SimParams, FluidState) with tensors on ``device``
(default CUDA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..core import device as device_mod
from ..core.params import (DEFAULT_PARTICLE_RADIUS, DEFAULT_SMOOTHING_RADIUS,
                           Container, InteractionField, KernelCoeffs,
                           SimConfig, SimParams)
from ..core.state import init_state
from ..ops import hashing


def cube_fluid(ni: int, nj: int, nk: int | None = None,
               particle_radius: float = DEFAULT_PARTICLE_RADIUS,
               center=None) -> np.ndarray:
    """Axis-aligned lattice of ni·nj(·nk) points at 2r spacing, centered at
    the origin (or ``center``); nk=None gives the 2-D variant. float32."""
    dims = [ni, nj] if nk is None else [ni, nj, nk]
    r = particle_radius
    half = np.array(dims, np.float32) * r
    offset = r - half
    axes = [np.arange(d, dtype=np.float32) * (2 * r) for d in dims]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=-1) + offset
    if center is not None:
        pts = pts + np.asarray(center, np.float32)
    return pts.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    description: str
    build: Callable  # (device) -> (SimConfig, SimParams, FluidState)


_REGISTRY: dict[str, Scene] = {}


def register(name: str, description: str):
    def deco(fn):
        _REGISTRY[name] = Scene(name, description, fn)
        return fn
    return deco


def get(name: str) -> Scene:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scene {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def _grid_dims_for(container_size, h=DEFAULT_SMOOTHING_RADIUS):
    return hashing.default_grid_dims(container_size, h)


def build(name: str, device=device_mod.DEFAULT, **overrides):
    """Build a scene on ``device`` (CUDA unless the caller names the CPU;
    raises without a CUDA device); overrides replace SimConfig fields."""
    cfg, params, state = get(name).build(device_mod.resolve(device))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, params, state


def lattice_rest_density(spacing: float, h: float, dim: int) -> float:
    """Rest density of an infinite lattice at ``spacing`` under the density
    kernel."""
    reach = int(math.ceil(h / spacing))
    axes = [np.arange(-reach, reach + 1) * spacing] * dim
    grids = np.meshgrid(*axes, indexing="ij")
    d = np.sqrt(sum(g * g for g in grids)).reshape(-1)
    d = d[d <= h]
    k = KernelCoeffs.from_radius(torch.tensor(h, dtype=torch.float32), dim)
    v = h - d
    return float(np.sum(v * v) * float(k.pow2))


@register("reference-cube",
          "the reference scene: 64x32x32 = 65,536 particle cube in a "
          "16x9x9 box")
def _reference_cube(device):
    pts = cube_fluid(64, 32, 32)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=24, rescue_capacity=2048,
                    sorted_state=True)
    return cfg, SimParams.create(dim=3, device=device), init_state(
        pts, device=device)


@register("dam-break-2d-4k",
          "2-D dam break, ~4k particles, gravity + pressure (viscosity off)")
def _dam_break_2d_4k(device):
    size = (16.0, 9.0)
    r = 0.05
    ni, nj = 50, 80
    pts = cube_fluid(ni, nj, None, particle_radius=r,
                     center=(-8.0 + ni * r + 0.1, -4.5 + nj * r + 0.1))
    cfg = SimConfig(n=pts.shape[0], dim=2, grid_dims=_grid_dims_for(size),
                    cell_capacity=24, rescue_capacity=1024)
    params = SimParams.create(
        dim=2, container=Container.create((0.0, 0.0), size, device=device),
        particle_radius=r, viscosity_strength=0.0,
        target_density=lattice_rest_density(2 * r, DEFAULT_SMOOTHING_RADIUS,
                                            2),
        device=device)
    return cfg, params, init_state(pts, device=device)


@register("interactive-2d-16k",
          "2-D, ~16k particles, viscosity + interaction force field")
def _interactive_2d_16k(device):
    size = (24.0, 12.0)
    r = 0.05
    pts = cube_fluid(200, 80, None, particle_radius=r,
                     center=(0.0, -6.0 + 80 * r + 0.1))
    cfg = SimConfig(n=pts.shape[0], dim=2, grid_dims=_grid_dims_for(size),
                    cell_capacity=32, rescue_capacity=2048)
    params = SimParams.create(
        dim=2, container=Container.create((0.0, 0.0), size, device=device),
        particle_radius=r, pressure_scalar=100.0, dt=1.0 / 120.0,
        target_density=lattice_rest_density(2 * r, DEFAULT_SMOOTHING_RADIUS,
                                            2),
        field=InteractionField.create((0.0, 0.0), strength=15.0, radius=2.0,
                                      device=device),
        device=device)
    return cfg, params, init_state(pts, device=device)


@register("sort-stress-64k",
          "64k particles, neighbor-pipeline stress (the reference's own "
          "particle count)")
def _sort_stress_64k(device):
    pts = cube_fluid(64, 32, 32)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=24, chunk=4096, rescue_capacity=2048)
    return cfg, SimParams.create(dim=3, device=device), init_state(
        pts, device=device)


@register("moving-container-256k",
          "266,112 particles in a translating+yawing container, "
          "container-frame grid")
def _moving_container_256k(device):
    """The JAX package's flagship scene: a shallow wide pool at 4x the
    reference's particle count with a translating, slowly yawing box; cell
    keys in the box's body frame (grid (162, 32, 58)) and 1024-lane tiles.
    See the JAX scene's docstring for how each value was chosen."""
    size = (40.0, 10.0, 14.0)
    pts = cube_fluid(198, 24, 56, center=(0.0, -2.0, 0.0))
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(162, 32, 58),
                    grid_frame="container", tile_override=1024,
                    cell_capacity=16, chunk=8192, rescue_capacity=16384,
                    sorted_state=True)
    params = SimParams.create(
        dim=3, pressure_scalar=100.0, dt=1.0 / 120.0,
        container=Container.create((0.0, 0.0, 0.0), size,
                                   velocity=(0.3, 0.0, 0.0),
                                   angular_velocity=0.02, device=device),
        device=device)
    return cfg, params, init_state(pts, device=device)


@register("sharded-1m",
          "~1M particles (the JAX package's multi-device scene)")
def _sharded_1m(device):
    size = (100.0, 10.0, 18.0)
    pts = cube_fluid(498, 24, 85, center=(0.0, -2.0, 0.0))
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(408, 44, 76),
                    cell_capacity=32, chunk=8192, rescue_capacity=16384)
    params = SimParams.create(
        dim=3, pressure_scalar=100.0, dt=1.0 / 120.0,
        container=Container.create((0.0, 0.0, 0.0), size, device=device),
        device=device)
    return cfg, params, init_state(pts, device=device)


@register("mini-3d", "tiny 3-D cube for tests and smoke runs (512 particles)")
def _mini_3d(device):
    pts = cube_fluid(8, 8, 8)
    cfg = SimConfig(n=pts.shape[0], dim=3,
                    grid_dims=_grid_dims_for((16.0, 9.0, 9.0)),
                    cell_capacity=16, chunk=256)
    return cfg, SimParams.create(dim=3, device=device), init_state(
        pts, device=device)
