"""Step-throughput benchmark of the port: ONE JSON line — the counterpart
of the repo-root ``bench.py``, with its protocol, defaults and fields.

    python -m water_sandbox_tpu_torch.bench

Primary metric: particle-steps/s on one card at 266,112 particles (the
flagship ``moving-container-256k``: a translating, yawing container), with
``vs_baseline`` against the reference's implied throughput (65,536
particles x 60 Hz = 3.93M particle-steps/s, if it holds 60 FPS; it
publishes no measured numbers). The line also carries the same
measurement on ``reference-cube`` itself (``reference_scene_*`` fields),
the workload that 60 FPS figure is about.

PINNED PROTOCOL (``settle600+best3x50``, the JAX bench's
``settle600+best3x50+ssync`` less the suffix that named its scalar-fetch
sync): windows of 50 steps of ``Simulation.run`` (on the card, 50 replays
of the captured step, ``ops/cuda/graph.py``, captured in the first
window); the state is
settled to step 600 first (the first two windows included, the second
timed as the transient rate), then the best of 3 timed windows gives the
rate. Every window ends in ``torch.cuda.synchronize``. The JSON carries ``ms_per_step`` and a
config fingerprint. Environment overrides (``WST_BENCH_SCENE``,
``WST_BENCH_STEPS``, ``WST_BENCH_SETTLE``, ``WST_BENCH_MODE``,
``WST_BENCH_NO_REF``) are for experiments only.

The JAX bench's ``vpu_mfu_est`` (pair FLOP/s over a TPU v5e VPU peak) is
not reported: that peak is no property of this card, and the pair FLOP
count is an estimate of the JAX kernels' arithmetic, not a count of what
the port's kernels execute, so no share of a card peak is put in its place.
``pair_gflops_per_s`` stays as the same estimate of useful pair work.
"""

from __future__ import annotations

import json
import os
import time

import torch

from .core import device as device_mod

PROTOCOL = "settle600+best3x50"

# reference implied particle-steps/s: 65,536 particles at 60 Hz
BASELINE = 65536 * 60.0

# f32 ops per directed pair within h across the density and force passes
# (the JAX bench's count of the kernel math)
PAIR_FLOPS = 61.0


def measure(scene: str, mode: str = "auto", chunk: int = 50,
            settle: int = 600, device=device_mod.DEFAULT):
    """(sim, rate, transient, done): the settled rate (particle-steps/s,
    best of 3 windows of ``chunk`` steps), the rate of the second window
    from the fresh lattice, and the steps run before the timed windows."""
    from .runtime.runner import Simulation

    sim = Simulation.from_scene(scene, device=device, neighbor_mode=mode)
    sync = sim._sync  # torch.cuda.synchronize on the card

    # first window: kernel build, warm-up and capture; second: transient
    sim.run(chunk)
    t0 = time.perf_counter()
    sim.run(chunk)
    transient = chunk * sim.cfg.n / (time.perf_counter() - t0)

    done = 2 * chunk
    while done < settle:
        sim.run(chunk, block=False)
        done += chunk
    sync()

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sim.run(chunk)
        walls.append(time.perf_counter() - t0)
    rate = chunk * sim.cfg.n / min(walls)
    return sim, rate, transient, done


def true_pairs(pos: torch.Tensor, h: torch.Tensor,
               temp_bytes: int = 1 << 30) -> int:
    """Directed pairs (i, j) with |p_i - p_j|² <= h², self pairs included:
    an exact O(n²) count over row chunks, each (rows, n) f32 temporary
    near ``temp_bytes``. The squared distance is summed axis by axis from
    the coordinate differences (no |a|² + |b|² - 2ab expansion), so the
    count is the JAX bench's ``true_pairs`` on the same positions."""
    n = pos.shape[0]
    rows = max(1, min(n, temp_bytes // (4 * n)))
    h2 = h * h
    total = 0
    for start in range(0, n, rows):
        chunk = pos[start:start + rows]
        d2 = (chunk[:, None, 0] - pos[None, :, 0]) ** 2
        for k in range(1, pos.shape[1]):
            d2 += (chunk[:, None, k] - pos[None, :, k]) ** 2
        total += int((d2 <= h2).sum())
    return total


def fingerprint(sim) -> dict:
    """What the port runs for ``sim``: the scene's config, how a step runs
    (``"captured"``: one replay of a CUDA graph a step; ``"eager"``), and,
    on the kernel pipeline ("pallas"), each hand kernel's source file, the
    threads a row ``G`` that ``ops/cuda/sph_bucket.py::_row_group`` picks
    for the scene's rows on this card (None off the card), and the
    lane-tile width of the bucket layout (the JAX bench's ``tile``: the
    same pick)."""
    from .ops.cuda import sph_bucket as sb
    cfg = sim.cfg
    out = {
        "scene": sim.name, "n": cfg.n,
        "neighbor_mode": cfg.neighbor_mode,  # resolved by Simulation
        "grid_dims": list(cfg.grid_dims) if cfg.grid_dims else None,
        "grid_frame": cfg.grid_frame,
        "cell_capacity": cfg.cell_capacity,
        "sorted_state": cfg.sorted_state,
        "step": "captured" if sim.graph.captures else "eager",
        "kernels": None, "row_group": None, "tile": None,
        "build_scatter": cfg.build_scatter,
        "dt": float(sim.params.dt),
        "pressure_scalar": float(sim.params.pressure_scalar),
        "device": (torch.cuda.get_device_name(sim.device)
                   if sim.device.type == "cuda" else "cpu"),
    }
    if cfg.neighbor_mode == "pallas":
        out["kernels"] = {
            "sph_density": "water_sandbox_tpu_torch/csrc/sph_density.cu",
            "sph_force": "water_sandbox_tpu_torch/csrc/sph_force.cu",
            "sph_rescue": "water_sandbox_tpu_torch/csrc/sph_rescue.cu"}
        out["tile"] = sb._geometry(cfg).T
        if sim.device.type == "cuda":
            out["row_group"] = sb._row_group(
                cfg.n, sb._sm_count(sim.device.index or 0))
    return out


def main():
    scene = os.environ.get("WST_BENCH_SCENE", "moving-container-256k")
    chunk = int(os.environ.get("WST_BENCH_STEPS", "50"))
    settle = int(os.environ.get("WST_BENCH_SETTLE", "600"))
    mode = os.environ.get("WST_BENCH_MODE", "auto")

    sim, rate, transient, done = measure(scene, mode, chunk, settle)

    # useful pair work in the settled state: true interacting pairs, at
    # PAIR_FLOPS ops a pair
    pairs = true_pairs(sim.state.predicted, sim.params.smoothing_radius)
    flops_per_s = pairs * PAIR_FLOPS * rate / sim.cfg.n

    out = {
        "metric": (f"particle-steps/sec/chip ({scene}, n={sim.cfg.n}, "
                   f"settled@{done}; transient={transient:.3g})"),
        "value": round(rate, 1),
        "unit": "particle-steps/s",
        "vs_baseline": round(rate / BASELINE, 3),
        "ms_per_step": round(1e3 * sim.cfg.n / rate, 4),
        "protocol": PROTOCOL,
        "true_pairs_per_particle": round(pairs / sim.cfg.n, 1),
        "pair_gflops_per_s": round(flops_per_s / 1e9, 1),
        "config": fingerprint(sim),
    }

    # head-to-head on the reference's own scene (skip if it was primary)
    if scene != "reference-cube" and not os.environ.get("WST_BENCH_NO_REF"):
        del sim
        sim_r, rate_r, _, _ = measure("reference-cube", mode, chunk, settle)
        out["reference_scene_ps_per_s"] = round(rate_r, 1)
        out["reference_scene_vs_baseline"] = round(rate_r / BASELINE, 3)
        out["reference_scene_fps_at_dt60"] = round(rate_r / 65536, 1)
        out["reference_scene_ms_per_step"] = round(1e3 * 65536 / rate_r, 4)
        out["reference_scene_config"] = fingerprint(sim_r)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
