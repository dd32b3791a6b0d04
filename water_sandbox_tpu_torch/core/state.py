"""Particle state as structure-of-arrays tensors — the counterpart of
``water_sandbox_tpu/core/state.py`` (same 13 fields, same dtypes)."""

from __future__ import annotations

import dataclasses

import torch

from . import device as device_mod


@dataclasses.dataclass(frozen=True)
class FluidState:
    """SoA particle state on one device.

    Row i of every per-particle tensor belongs to particle ``ids[i]``; the
    sorted-state step (``SimConfig.sorted_state``) re-permutes rows into
    bucket order every step, so identity is explicit."""

    pos: torch.Tensor            # (n, dim) f32
    vel: torch.Tensor            # (n, dim) f32
    predicted: torch.Tensor      # (n, dim) f32
    acc: torch.Tensor            # (n, dim) f32
    density: torch.Tensor        # (n,) f32
    near_density: torch.Tensor   # (n,) f32
    pressure: torch.Tensor       # (n,) f32
    near_pressure: torch.Tensor  # (n,) f32
    step_count: torch.Tensor     # () int32
    time: torch.Tensor           # () f32
    overflow: torch.Tensor       # () int32 — particles not computed last step
    overflow_total: torch.Tensor  # () f32 — cumulative dropped-particle steps
    ids: torch.Tensor            # (n,) int32 — persistent particle identity

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "FluidState":
        return FluidState(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})

    def clone(self) -> "FluidState":
        return FluidState(**{f.name: getattr(self, f.name).clone()
                             for f in dataclasses.fields(self)})


def init_state(positions, velocities=None,
               device=device_mod.DEFAULT) -> FluidState:
    """Fresh state from initial positions: predicted = position, everything
    else zero, ids the identity map. On the card unless ``device`` says
    otherwise (``device="cpu"`` for the CPU)."""
    device = device_mod.resolve(device)
    pos = torch.as_tensor(positions, dtype=torch.float32, device=device)
    n, dim = pos.shape
    vel = (torch.zeros((n, dim), device=device) if velocities is None
           else torch.as_tensor(velocities, dtype=torch.float32,
                                device=device))
    zeros = lambda: torch.zeros((n,), device=device)  # noqa: E731
    return FluidState(
        pos=pos, vel=vel, predicted=pos.clone(),
        acc=torch.zeros((n, dim), device=device),
        density=zeros(), near_density=zeros(), pressure=zeros(),
        near_pressure=zeros(),
        step_count=torch.zeros((), dtype=torch.int32, device=device),
        time=torch.zeros((), device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        overflow_total=torch.zeros((), device=device),
        ids=torch.arange(n, dtype=torch.int32, device=device))
