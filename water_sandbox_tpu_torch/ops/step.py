"""The simulation step — the counterpart of ``water_sandbox_tpu/ops/step.py``.

``step`` dispatches on ``cfg.neighbor_mode``. ``"auto"`` and ``"pallas"``
run the fused bucket-kernel pipeline:

    bucket build → density kernel → exact rescue → force kernel → gather
    → integrate

``"dense"`` runs the all-pairs oracle (``ops/dense.py``), ``"bucket_grid"``
and ``"hash_grid"`` the plain PyTorch pipelines of ``ops/grid.py``.
``rollout`` and ``trajectory`` are Python loops over ``step`` (PyTorch runs
eagerly).
"""

from __future__ import annotations

import torch

from ..core.params import KernelCoeffs, SimConfig, SimParams
from ..core.state import FluidState
from . import dense, grid as grid_mod, integrate as integrate_mod
from .cuda import sph_bucket


def step(state: FluidState, params: SimParams, cfg: SimConfig) -> FluidState:
    """Advance one dt. ``cfg.sorted_state`` returns rows in this step's
    bucket order (identity on ``state.ids``); otherwise rows keep the
    caller's order."""
    cfg = cfg.resolved()
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    if cfg.sorted_state:
        return _sorted_pallas_step(state, params, coeffs, cfg)

    predicted = state.predicted
    if cfg.neighbor_mode == "dense":
        density, near_density, pressure, near_pressure = dense.density_pass(
            predicted, params, coeffs)
        acc = dense.force_pass(predicted, state.vel, density, near_density,
                               pressure, near_pressure, params, coeffs)
        overflow = torch.zeros((), dtype=torch.int32, device=predicted.device)
    elif cfg.neighbor_mode == "pallas":
        density, near_density, pressure, near_pressure, acc, overflow = (
            sph_bucket.bucket_sph(predicted, state.vel, params, coeffs, cfg,
                                  time=state.time))
    elif cfg.neighbor_mode == "bucket_grid":
        density, near_density, pressure, near_pressure, acc, overflow = (
            grid_mod.bucket_sph(predicted, state.vel, params, coeffs, cfg,
                                time=state.time))
    elif cfg.neighbor_mode == "hash_grid":
        density, near_density, pressure, near_pressure, acc, overflow = (
            grid_mod.hash_sph(predicted, state.vel, params, coeffs, cfg))
    else:
        raise ValueError(f"unknown neighbor_mode {cfg.neighbor_mode!r}")
    t_new = state.time + params.dt
    pos, vel, predicted = integrate_mod.integrate(
        state.pos, state.vel, acc, params, t_new)
    return _next_state(state, pos, vel, predicted, acc, density,
                       near_density, pressure, near_pressure, overflow,
                       t_new, state.ids)


def _sorted_pallas_step(state: FluidState, params: SimParams,
                        coeffs: KernelCoeffs, cfg: SimConfig) -> FluidState:
    """Sorted-state step: the new state's rows are in this step's bucket
    order; identity rides ``ids``. Cell keys use the box pose at
    ``state.time``; collision uses the post-step time."""
    (density, near_density, pressure, near_pressure, acc, overflow,
     s_pos, s_vel, s_ids) = sph_bucket.bucket_sph_sorted(
        state.pos, state.vel, state.predicted, state.ids, params, coeffs,
        cfg, time=state.time)
    t_new = state.time + params.dt
    pos, vel, predicted = integrate_mod.integrate(s_pos, s_vel, acc, params,
                                                  t_new)
    return _next_state(state, pos, vel, predicted, acc, density,
                       near_density, pressure, near_pressure, overflow,
                       t_new, s_ids)


def _next_state(state, pos, vel, predicted, acc, density, near_density,
                pressure, near_pressure, overflow, t_new, ids) -> FluidState:
    return FluidState(
        pos=pos, vel=vel, predicted=predicted, acc=acc, density=density,
        near_density=near_density, pressure=pressure,
        near_pressure=near_pressure, step_count=state.step_count + 1,
        time=t_new, overflow=overflow,
        overflow_total=state.overflow_total + overflow.to(torch.float32),
        ids=ids)


def rollout(state: FluidState, params: SimParams, cfg: SimConfig,
            num_steps: int) -> FluidState:
    """``num_steps`` of ``step``."""
    for _ in range(num_steps):
        state = step(state, params, cfg)
    return state


def trajectory(state: FluidState, params: SimParams, cfg: SimConfig,
               num_steps: int, record_every: int = 1):
    """Rollout that also stacks recorded positions: returns (final_state,
    positions (num_steps // record_every, n, dim)).

    Under ``cfg.sorted_state`` the recorded rows are in each step's bucket
    order (row identity varies frame to frame); for id-stable frames use
    ``Simulation.positions()`` per frame."""
    if num_steps % record_every:
        raise ValueError(
            f"num_steps={num_steps} not divisible by record_every="
            f"{record_every}; the remainder steps would be silently dropped")
    frames = []
    for _ in range(num_steps // record_every):
        state = rollout(state, params, cfg, record_every)
        frames.append(state.pos)
    if not frames:
        return state, state.pos.new_zeros((0, *state.pos.shape))
    return state, torch.stack(frames)
