"""The multi-shard runtime — the counterpart of
``water_sandbox_tpu/runtime/distributed.py``: a Simulation-like wrapper
driving the domain-decomposed step (``parallel/domain.py``) over a shard
mesh in one process.

    sim = DistributedSimulation.from_scene("sharded-1m", n_shards=4,
                                           device="cuda")
    sim.run(100)
    pos, vel = sim.particles()
"""

from __future__ import annotations

import time as _time

import torch

from ..core import device as device_mod
from ..core.params import SimConfig, SimParams
from ..core.state import FluidState
from ..models import scenes as scene_registry
from ..parallel import domain, mesh as mesh_mod
from . import metrics as metrics_mod


class DistributedSimulation:
    """Fixed-capacity per-shard particle slots, halo exchange and migration
    between the shards of ``mesh`` (default: ``n_shards`` shards on
    ``device``, CUDA unless the caller names the CPU; raises without a CUDA
    device). The first ``run`` is recorded as warm-up, as in
    ``Simulation``."""

    def __init__(self, cfg: SimConfig, params: SimParams, state: FluidState,
                 mesh: mesh_mod.Mesh | None = None, n_shards: int = 1,
                 slack: float = 2.0, mig_cap: int = 1024,
                 name: str = "custom", device=device_mod.DEFAULT):
        self.mesh = mesh or mesh_mod.make_mesh(n_shards, device)
        self.cfg = cfg.resolved()
        self.params = params.to(self.mesh.devices[0])
        self.name = name
        self.states, self.active = domain.shard_state(
            state, self.mesh, self.cfg, self.params, slack=slack)
        self._rollout = domain.make_domain_rollout(self.mesh, self.cfg,
                                                   mig_cap=mig_cap)
        self.lost_total = 0.0
        self._lost_acc = torch.zeros((), device=self.mesh.devices[0])
        self.metrics = metrics_mod.MetricsRecorder()
        self._warm = False

    @classmethod
    def from_scene(cls, name: str, n_shards: int = 1, slack: float = 2.0,
                   device=device_mod.DEFAULT, **cfg_overrides):
        mesh = mesh_mod.make_mesh(n_shards, device)
        cfg, params, state = scene_registry.build(
            name, device=mesh.devices[0], **cfg_overrides)
        return cls(cfg, params, state, mesh=mesh, slack=slack, name=name)

    def _sync(self):
        for dev in set(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(self, num_steps: int = 1, block: bool = True):
        """Advance num_steps. Every step's migration losses go into a
        device-side sum, read back when ``block`` (and by ``stats``)."""
        if num_steps <= 0:
            return self
        t0 = _time.perf_counter()
        self.states, self.active, lost = self._rollout(
            self.states, self.active, self.params, num_steps)
        self._lost_acc = self._lost_acc + lost
        if block:
            self._sync()
            self.lost_total = float(self._lost_acc)
            self.metrics.record_steps(num_steps, self.cfg.n,
                                      _time.perf_counter() - t0,
                                      compiled=not self._warm)
            self._warm = True
        return self

    def tune(self, **kw):
        """Set scalar or vector SimParams fields by name."""
        self.params = self.params.replace(**kw)
        return self

    def particles(self):
        """(positions, velocities) of all active particles on the host, in
        shard order (not particle-id order)."""
        return domain.gather_dense(self.states, self.active)

    def to_dense_state(self) -> FluidState:
        """The active particles as one dense FluidState on the CPU (rows in
        shard order, ``ids`` carried) — feeds ``runtime.checkpoint.save``."""
        act = torch.cat([a.cpu() for a in self.active]) > 0
        s0 = self.states[0]
        fields = {}
        for name in FluidState.__dataclass_fields__:
            if getattr(s0, name).dim() == 0:
                fields[name] = getattr(s0, name).cpu()
            else:
                fields[name] = torch.cat(
                    [getattr(s, name).cpu() for s in self.states])[act]
        return FluidState(**fields)

    def stats(self) -> dict:
        pos, vel = self.particles()
        self.lost_total = float(self._lost_acc)
        s0 = self.states[0]
        out = {
            "step": int(s0.step_count),
            "active_particles": int(pos.shape[0]),
            "lost_particles": self.lost_total,
            "overflow_total": float(s0.overflow_total),
            "kinetic_energy": float(0.5 * (vel ** 2).sum()),
            "per_shard_counts": [int(a.sum()) for a in self.active],
        }
        out.update(self.metrics.summary())
        return out
