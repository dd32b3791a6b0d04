"""The multi-shard runtime — the counterpart of
``water_sandbox_tpu/runtime/distributed.py``: a Simulation-like wrapper
driving the domain-decomposed step (``parallel/domain.py``) over a shard
mesh in one process.

    sim = DistributedSimulation.from_scene("sharded-1m", n_shards=4,
                                           device="cuda")
    sim.run(100)
    pos, vel = sim.particles()

It owns a ``DomainGraph`` (``ops/cuda/graph.py``): with every shard on one
CUDA device the first ``run`` warms the step up and captures it, and every
step after is one replay of that graph, whose shards run concurrently on
their own streams (``parallel/mesh.py``); a mesh over several devices (or
the CPU) steps eagerly into the same buffers.
"""

from __future__ import annotations

import threading
import time as _time

import torch

from ..core import device as device_mod
from ..core.params import SimConfig, SimParams, _map_tensors
from ..core.state import FluidState
from ..models import scenes as scene_registry
from ..ops.cuda import graph as graph_mod
from ..parallel import domain, mesh as mesh_mod
from . import metrics as metrics_mod, profiling
from .runner import tune_buffers


def _shard_count(n_shards: int | None, n_devices: int | None) -> int:
    """The shard count from the port's ``n_shards`` or the JAX package's
    ``n_devices`` (default 1); both given must agree."""
    if n_shards is not None and n_devices is not None \
            and n_shards != n_devices:
        raise ValueError(f"n_shards={n_shards} and n_devices={n_devices} "
                         "name different shard counts")
    n = n_shards if n_shards is not None else n_devices
    return 1 if n is None else n


class DistributedSimulation:
    """Fixed-capacity per-shard particle slots, halo exchange and migration
    between the shards of ``mesh`` (default: ``n_shards`` shards on
    ``device``, CUDA unless the caller names the CPU; raises without a CUDA
    device). ``n_devices``, the JAX package's name for the shard count, is
    taken as ``n_shards``.

    The state and parameters live in buffers of its own, stepped by its
    ``DomainGraph``: ``states``, ``active`` and ``params`` are those
    buffers (clone them to keep a snapshot). ``tune`` copies into the
    parameter buffers, so a change takes effect on the next step with no
    recapture. The first ``run`` is recorded as warm-up, as in
    ``Simulation`` (it builds the kernels and captures the graph). ``run``
    and ``tune`` hold ``lock`` (reentrant), as ``Simulation``'s do."""

    def __init__(self, cfg: SimConfig, params: SimParams, state: FluidState,
                 mesh: mesh_mod.Mesh | None = None,
                 n_shards: int | None = None,
                 slack: float = 2.0, mig_cap: int = 1024,
                 name: str = "custom", device=device_mod.DEFAULT,
                 n_devices: int | None = None):
        n_shards = _shard_count(n_shards, n_devices)
        self.mesh = mesh or mesh_mod.make_mesh(n_shards, device)
        self.cfg = cfg.resolved()
        dev = self.mesh.devices[0]
        self.params = _map_tensors(params, lambda t: t.to(dev).clone())
        self.name = name
        states, active = domain.shard_state(
            state, self.mesh, self.cfg, self.params, slack=slack)
        self.graph = graph_mod.DomainGraph(
            domain.make_domain_step(self.mesh, self.cfg, mig_cap=mig_cap),
            states, active, self.params, self.mesh)
        self.lost_total = 0.0
        self.metrics = metrics_mod.MetricsRecorder()
        self._warm = False
        self.lock = threading.RLock()

    @classmethod
    def from_scene(cls, name: str, n_shards: int | None = None,
                   slack: float = 2.0,
                   device=device_mod.DEFAULT, n_devices: int | None = None,
                   **cfg_overrides):
        mesh = mesh_mod.make_mesh(_shard_count(n_shards, n_devices), device)
        cfg, params, state = scene_registry.build(
            name, device=mesh.devices[0], **cfg_overrides)
        return cls(cfg, params, state, mesh=mesh, slack=slack, name=name)

    @property
    def states(self) -> list[FluidState]:
        return self.graph.states

    @property
    def active(self) -> list[torch.Tensor]:
        return self.graph.active

    @property
    def execution(self) -> str:
        """How ``run`` steps: "captured" (a replay of one CUDA graph a
        step) or "eager"."""
        return "captured" if self.graph.captures else "eager"

    def _sync(self):
        with profiling.span("wst.sync"):
            for dev in set(self.mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def run(self, num_steps: int = 1, block: bool = True):
        """Advance num_steps. Every step's migration losses go into a
        device-side sum, read back when ``block`` (and by ``stats``)."""
        if num_steps <= 0:
            return self
        with self.lock, profiling.span("wst.run"):
            t0 = _time.perf_counter()
            self.graph.run(num_steps)
            if block:
                self._sync()
                self.lost_total = float(self.graph.lost)
                self.metrics.record_steps(num_steps, self.cfg.n,
                                          _time.perf_counter() - t0,
                                          compiled=not self._warm)
                self._warm = True
        return self

    def tune(self, **kw):
        """Set any SimParams field by name (``Simulation.tune``): the values
        are copied into the parameter buffers the step reads."""
        with self.lock:
            tune_buffers(self.params, kw)
        return self

    def particles(self):
        """(positions, velocities) of all active particles on the host, in
        shard order (not particle-id order)."""
        return domain.gather_dense(self.states, self.active)

    def to_dense_state(self) -> FluidState:
        """The active particles as one dense FluidState on the CPU, rows in
        id order — feeds ``runtime.checkpoint.save``."""
        return domain.dense_by_id(self.states, self.active)[0].to("cpu")

    def stats(self) -> dict:
        pos, vel = self.particles()
        self.lost_total = float(self.graph.lost)
        s0 = self.states[0]
        counts = [int(a.sum()) for a in self.active]
        out = {
            "step": int(s0.step_count),
            "active_particles": int(pos.shape[0]),
            "lost_particles": self.lost_total,
            # particles that changed shards, summed over every step run
            "migrated_particles": int(self.graph.migrated),
            "overflow_total": float(s0.overflow_total),
            "kinetic_energy": float(0.5 * (vel ** 2).sum()),
            "per_shard_counts": counts,
            # the JAX package's key: a shard is a mesh position here
            "per_device_counts": list(counts),
            "execution": self.execution,
        }
        out.update(self.metrics.summary())
        return out
