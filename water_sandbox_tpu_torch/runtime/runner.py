"""The interactive runtime — the counterpart of
``water_sandbox_tpu/runtime/runner.py``: a stateful wrapper holding the
current state and params on one device, with the reference's FSM
(run/pause/reset), live tuning, and id-ordered observation."""

from __future__ import annotations

import dataclasses
import enum
import time as _time
from typing import Any

import numpy as np
import torch

from ..core import convert
from ..core import device as device_mod
from ..core.params import Container, InteractionField, SimConfig, SimParams
from ..core.state import FluidState
from ..models import scenes as scene_registry
from ..ops import step as step_mod
from . import metrics as metrics_mod


class SimPhase(enum.Enum):
    READY = "ready"
    RUNNING = "running"
    PAUSED = "paused"


class Simulation:
    """Holds the current state and params on ``device`` and steps them
    eagerly. The first ``run`` of a Simulation is recorded as warm-up (it
    builds the CUDA kernels on first use and fills the allocator)."""

    def __init__(self, cfg: SimConfig, params: SimParams, state: FluidState,
                 name: str = "custom", device=None):
        device = torch.device(device) if device is not None else state.device
        self.cfg = cfg.resolved()
        self.params = params.to(device)
        self.state = state.to(device)
        self.device = device
        self.name = name
        self.phase = SimPhase.READY
        self._initial_state = self.state.clone()
        self.metrics = metrics_mod.MetricsRecorder()
        self._warm = False

    @classmethod
    def from_scene(cls, name: str, device=device_mod.DEFAULT,
                   **cfg_overrides) -> "Simulation":
        """Scene ``name`` on ``device``: CUDA unless the caller names the
        CPU; raises without a CUDA device."""
        cfg, params, state = scene_registry.build(name, device=device,
                                                  **cfg_overrides)
        return cls(cfg, params, state, name=name, device=device)

    # -- stepping ----------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int = 1, block: bool = True) -> "Simulation":
        """Advance num_steps. Respects PAUSED."""
        if self.phase is SimPhase.PAUSED:
            return self
        self.phase = SimPhase.RUNNING
        t0 = _time.perf_counter()
        self.state = step_mod.rollout(self.state, self.params, self.cfg,
                                      num_steps)
        if block:
            self._sync()
            self.metrics.record_steps(num_steps, self.cfg.n,
                                      _time.perf_counter() - t0,
                                      compiled=not self._warm)
            self._warm = True
        return self

    def step(self) -> "Simulation":
        return self.run(1)

    # -- FSM ---------------------------------------------------------------

    def pause(self) -> "Simulation":
        """Esc-toggle."""
        if self.phase is SimPhase.RUNNING:
            self.phase = SimPhase.PAUSED
        elif self.phase is SimPhase.PAUSED:
            self.phase = SimPhase.RUNNING
        return self

    def reset(self) -> "Simulation":
        """Restore the initial particle state, keep the live-tuned params."""
        self.state = self._initial_state.clone()
        self.phase = SimPhase.READY
        return self

    # -- live tuning -------------------------------------------------------

    def tune(self, **kw) -> "Simulation":
        """Set any SimParams field by name; container/field accept dicts,
        e.g. ``sim.tune(viscosity_strength=0.2)`` or
        ``sim.tune(field={'strength': -20, 'radius': 3})``."""
        p = self.params
        as_t = lambda v: torch.as_tensor(  # noqa: E731
            v, dtype=torch.float32, device=self.device)
        updates: dict[str, Any] = {}
        for k, v in kw.items():
            if k in ("container", "field") and isinstance(v, dict):
                updates[k] = dataclasses.replace(
                    getattr(p, k), **{kk: as_t(vv) for kk, vv in v.items()})
            elif isinstance(v, (Container, InteractionField)):
                updates[k] = v
            else:
                updates[k] = as_t(v)
        self.params = dataclasses.replace(p, **updates)
        return self

    def gravity_off(self):
        return self.tune(gravity=[0.0] * self.cfg.dim)

    def gravity_on(self):
        g = [0.0] * self.cfg.dim
        g[1] = -9.8
        return self.tune(gravity=g)

    # -- observation -------------------------------------------------------

    def _by_id(self, arr: np.ndarray) -> np.ndarray:
        """Rows in particle-id order (the sorted-state step keeps device rows
        in bucket order; the reorder happens here, on the host)."""
        ids = self.state.ids.cpu().numpy()
        out = np.empty_like(arr)
        out[ids] = arr
        return out

    def positions(self) -> np.ndarray:
        return self._by_id(self.state.pos.cpu().numpy())

    def velocities(self) -> np.ndarray:
        return self._by_id(self.state.vel.cpu().numpy())

    def snapshot(self) -> dict:
        """Full host-side state dict (also the checkpoint payload)."""
        return convert.state_to_numpy(self.state)

    def stats(self) -> dict:
        s = self.state
        speed2 = (s.vel ** 2).sum(dim=1)
        out = {
            "step": int(s.step_count),
            "time": float(s.time),
            "kinetic_energy": float(0.5 * speed2.sum()),
            "max_speed": float(speed2.max().sqrt()),
            "mean_density": float(s.density.mean()),
            "max_density": float(s.density.max()),
            "mean_pressure": float(s.pressure.mean()),
        }
        out.update(self.metrics.summary())
        return out
