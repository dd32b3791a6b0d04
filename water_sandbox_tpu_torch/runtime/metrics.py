"""Step-throughput metrics — a copy of ``water_sandbox_tpu/runtime/metrics.py``
(that module imports no JAX, but its package does)."""

from __future__ import annotations


class MetricsRecorder:
    """Accumulates wall-clock stepping stats.

    Warm-up windows (the first run of a Simulation, which builds the CUDA
    kernels and fills the allocator's caches) are accumulated separately:
    throughput rates come from warm windows only."""

    def __init__(self):
        self.total_steps = 0
        self.total_wall_s = 0.0
        self.warmup_steps = 0
        self.warmup_wall_s = 0.0
        self.compiles_seen = 0
        self.last_rate = 0.0
        self.n = 0

    def record_steps(self, num_steps: int, n_particles: int, wall_s: float,
                     compiled: bool = False):
        self.n = n_particles
        if compiled:
            self.compiles_seen += 1
            self.warmup_steps += num_steps
            self.warmup_wall_s += wall_s
            return
        self.total_steps += num_steps
        self.total_wall_s += wall_s
        if wall_s > 0:
            self.last_rate = num_steps * n_particles / wall_s

    def summary(self) -> dict:
        out = {
            "wall_time_s": round(self.total_wall_s + self.warmup_wall_s, 6),
            "steps_timed": self.total_steps,
        }
        if self.compiles_seen:
            out["compiles_seen"] = self.compiles_seen
            out["warmup_wall_s"] = round(self.warmup_wall_s, 6)
        if self.total_wall_s > 0 and self.total_steps:
            out["particle_steps_per_s"] = (
                self.total_steps * self.n / self.total_wall_s)
            out["ms_per_step"] = 1000.0 * self.total_wall_s / self.total_steps
        return out
