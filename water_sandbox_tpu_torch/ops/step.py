"""The simulation step — the counterpart of ``water_sandbox_tpu/ops/step.py``.

``step`` dispatches on ``cfg.neighbor_mode``. ``"auto"`` and ``"pallas"``
run the fused bucket-kernel pipeline:

    bucket build → density kernel → exact rescue → force kernel → gather
    → integrate

``"dense"`` runs the all-pairs oracle (``ops/dense.py``), ``"bucket_grid"``
and ``"hash_grid"`` the plain PyTorch pipelines of ``ops/grid.py``.

The step reads nothing on the host in any mode (the rescue gates itself
on the device), so on a CUDA device ``rollout`` and ``trajectory`` run it
as a captured CUDA graph replayed once a step (``ops/cuda/graph.py::
StepGraph``), as the JAX package runs ``lax.scan`` in one compiled program
for every mode; on the CPU the same buffers step eagerly. A step that
cannot be captured raises: nothing falls back to a Python loop. In the
kernel pipeline with ``incremental_rebuild > 0``, ``rollout`` runs the
plane-resident steps of ``ops/cuda/incremental.py``: on a CUDA device
replays of one captured step whose branches are decided on the device
(``graph.IncrementalGraph``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.params import KernelCoeffs, SimConfig, SimParams, _map_tensors
from ..core.state import FluidState
from ..runtime import profiling
from . import dense, grid as grid_mod, integrate as integrate_mod
from .cuda import graph as graph_mod, incremental, sph_bucket


def step(state: FluidState, params: SimParams, cfg: SimConfig) -> FluidState:
    """Advance one dt. ``cfg.sorted_state`` returns rows in this step's
    bucket order (identity on ``state.ids``); otherwise rows keep the
    caller's order. The kernel pipeline's step marks its phases
    (``runtime/profiling.py::phase``): build, density, rescue, force,
    rescue, integrate."""
    cfg = cfg.resolved()
    with profiling.phases(marked(cfg)):
        return _step(state, params, cfg)


def marked(cfg: SimConfig) -> bool:
    """Whether ``step`` marks its phases under ``cfg``: in the kernel
    pipeline."""
    return cfg.resolved().neighbor_mode == "pallas"


def _step(state: FluidState, params: SimParams,
          cfg: SimConfig) -> FluidState:
    profiling.phase("build")
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
    profiling.phase("integrate")
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
    profiling.phase("integrate")
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
    """``num_steps`` of ``step``. With ``cfg.incremental_rebuild > 0`` in
    the kernel pipeline the particles stay resident in the bucket planes
    across the steps and only cell-crossing movers are re-inserted
    (``ops/cuda/incremental.py``); the full build runs on entry and then
    every ``incremental_rebuild`` steps."""
    cfg = cfg.resolved()
    if cfg.neighbor_mode == "pallas" and cfg.incremental_rebuild > 0:
        return incremental.rollout_inc(state, params, cfg, num_steps)
    g = _own_graph(state, params, cfg)
    g.run(num_steps)
    return g.state


def _own_graph(state, params, cfg) -> graph_mod.StepGraph:
    """A StepGraph on copies of the caller's state and params (the caller's
    tensors stay as they were)."""
    return graph_mod.StepGraph(state.clone(),
                               _map_tensors(params, torch.clone), cfg)


def trajectory(state: FluidState, params: SimParams, cfg: SimConfig,
               num_steps: int, record_every: int = 1):
    """Steps that also stack recorded positions: returns (final_state,
    positions (num_steps // record_every, n, dim)). Always the rebuild
    step, as in the JAX package, whatever ``incremental_rebuild`` says.

    Under ``cfg.sorted_state`` the recorded rows are in each step's bucket
    order (row identity varies frame to frame); for id-stable frames use
    ``Simulation.positions()`` per frame."""
    if num_steps % record_every:
        raise ValueError(
            f"num_steps={num_steps} not divisible by record_every="
            f"{record_every}; the remainder steps would be silently dropped")
    g = _own_graph(state, params,
                   dataclasses.replace(cfg.resolved(), incremental_rebuild=0))
    state = g.state                      # stepped in place by g.run
    frames = []
    for _ in range(num_steps // record_every):
        g.run(record_every)
        frames.append(state.pos.clone())
    if not frames:
        return state, state.pos.new_zeros((0, *state.pos.shape))
    return state, torch.stack(frames)
