"""The interactive runtime — the counterpart of
``water_sandbox_tpu/runtime/runner.py``: a stateful wrapper holding the
current state and params on one device, with the reference's FSM
(run/pause/reset), live tuning, and id-ordered observation."""

from __future__ import annotations

import dataclasses
import enum
import threading
import time as _time

import numpy as np
import torch

from ..core import convert
from ..core import device as device_mod
from ..core.params import SimConfig, SimParams, _map_tensors
from ..core.state import FluidState
from ..models import scenes as scene_registry
from ..ops.cuda import graph as graph_mod
from . import metrics as metrics_mod, profiling


class SimPhase(enum.Enum):
    READY = "ready"
    RUNNING = "running"
    PAUSED = "paused"


class Simulation:
    """Holds the current state and params on ``device`` in buffers of its
    own. It owns a graph (``ops/cuda/graph.py``): a ``StepGraph`` of the
    rebuild step in every neighbour mode, or (kernel pipeline) with
    ``incremental_rebuild > 0`` an ``IncrementalGraph``, whose
    ``run(n)`` builds the bucket cache on entry, as JAX's ``rollout`` does
    on every call, and gathers the per-particle state on its last step. On
    a CUDA device the first ``run`` captures the step as a CUDA graph (the
    incremental step's branches as conditional nodes) and every step after
    it is one replay, with no recapture on later runs; on the CPU the same
    buffers step eagerly.
    ``tune`` copies into the parameter buffers, so a change
    takes effect on the next step with no recapture, as the JAX package's
    traced parameters do; ``reset`` copies the initial state back. The
    first ``run`` of a Simulation is recorded as warm-up (it builds the
    CUDA kernels on first use and captures the graph).

    ``run``, ``tune`` and ``reset`` hold ``lock`` (reentrant), so a caller
    on another thread (the viewer's request handlers) never lands a copy
    between two steps of one ``run``, or inside a capture: a reset is
    whole or not yet begun. Hold ``lock`` around a read-then-tune, or
    around reads that must see one state.

    While a profiler records, ``run``, ``reset``, ``tune``, ``stats`` and
    the reads put host spans on its trace (``runtime/profiling.py``:
    ``wst.run``, ``wst.sync``, ``wst.reset``, ``wst.tune``, ``wst.stats``,
    ``wst.read.copy`` then ``wst.read.reorder``), and the replays carry
    the step's phase markers."""

    def __init__(self, cfg: SimConfig, params: SimParams, state: FluidState,
                 name: str = "custom", device=None):
        device = torch.device(device) if device is not None else state.device
        self.cfg = cfg.resolved()
        self.params = _map_tensors(params, lambda t: t.to(device).clone())
        self.state = state.to(device).clone()
        self.device = device
        self.name = name
        self.phase = SimPhase.READY
        self._initial_state = self.state.clone()
        self.metrics = metrics_mod.MetricsRecorder()
        self._warm = False
        self.lock = threading.RLock()
        graph = (graph_mod.IncrementalGraph
                 if self.cfg.neighbor_mode == "pallas"
                 and self.cfg.incremental_rebuild > 0
                 else graph_mod.StepGraph)
        self.graph = graph(self.state, self.params, self.cfg)

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
            with profiling.span("wst.sync"):
                torch.cuda.synchronize(self.device)

    def run(self, num_steps: int = 1, block: bool = True) -> "Simulation":
        """Advance num_steps (on CUDA: num_steps replays of the captured
        step, in every neighbour mode). Respects PAUSED."""
        with self.lock, profiling.span("wst.run"):
            if self.phase is SimPhase.PAUSED:
                return self
            self.phase = SimPhase.RUNNING
            t0 = _time.perf_counter()
            self.graph.run(num_steps)
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
        """Restore the initial particle state, keep the live-tuned params;
        the count of rescued rows starts again from 0."""
        with self.lock, profiling.span("wst.reset"):
            graph_mod.copy_state(self.state, self._initial_state)
            self.graph.rescued.zero_()
            self.phase = SimPhase.READY
        return self

    # -- live tuning -------------------------------------------------------

    def tune(self, **kw) -> "Simulation":
        """Set any SimParams field by name; container/field accept dicts,
        e.g. ``sim.tune(viscosity_strength=0.2)`` or
        ``sim.tune(field={'strength': -20, 'radius': 3})``. The values are
        copied into the parameter buffers the step reads."""
        with self.lock, profiling.span("wst.tune"):
            tune_buffers(self.params, kw)
        return self

    def gravity_off(self):
        return self.tune(gravity=[0.0] * self.cfg.dim)

    def gravity_on(self):
        g = [0.0] * self.cfg.dim
        g[1] = -9.8
        return self.tune(gravity=g)

    # -- observation -------------------------------------------------------

    def _by_id(self, rows: torch.Tensor) -> np.ndarray:
        """``rows`` on the host in particle-id order (the sorted-state step
        keeps device rows in bucket order; the reorder happens here, on the
        host, after the copy)."""
        with profiling.span("wst.read.copy"):
            arr = rows.cpu().numpy()
            ids = self.state.ids.cpu().numpy()
        with profiling.span("wst.read.reorder"):
            out = np.empty_like(arr)
            out[ids] = arr
        return out

    def positions(self) -> np.ndarray:
        return self._by_id(self.state.pos)

    def velocities(self) -> np.ndarray:
        return self._by_id(self.state.vel)

    def snapshot(self) -> dict:
        """Full host-side state dict (also the checkpoint payload)."""
        return convert.state_to_numpy(self.state)

    def stats(self) -> dict:
        """The JAX package's keys, and ``rescued_rows``: the rows the
        rescue took in since the start or the last ``reset``, summed over
        the steps (the graph's device counter; more than 0 means cells
        overflowed their capacity)."""
        with profiling.span("wst.stats"):
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
                "rescued_rows": int(self.graph.rescued),
            }
            out.update(self.metrics.summary())
        return out


def tune_buffers(params: SimParams, kw: dict) -> None:
    """Copy each ``name=value`` of ``kw`` into the parameter buffer of that
    SimParams field (container/field take a dict or a dataclass)."""
    for k, v in kw.items():
        target = _field(params, k)
        if dataclasses.is_dataclass(target):
            items = (v.items() if isinstance(v, dict) else
                     ((f.name, getattr(v, f.name))
                      for f in dataclasses.fields(v)))
            for kk, vv in items:
                _set(_field(target, kk), vv, f"{k}.{kk}")
        else:
            _set(target, v, k)


def _field(obj, name: str):
    if name not in {f.name for f in dataclasses.fields(obj)}:
        raise TypeError(f"{type(obj).__name__} has no field {name!r}")
    return getattr(obj, name)


def _set(buf: torch.Tensor, value, name: str) -> None:
    """Copy ``value`` into the parameter buffer ``buf`` in place."""
    src = torch.as_tensor(value, dtype=torch.float32).to("cpu")
    if src.shape != buf.shape:
        raise ValueError(f"{name}: expected shape {tuple(buf.shape)}, got "
                         f"{tuple(src.shape)}")
    buf.copy_(src)
