"""Frozen copies of two helpers of the port's bench, so that the yardstick
does not move when the program does.

``true_pairs`` is copied from ``water_sandbox_tpu_torch/bench.py::
true_pairs``; ``fingerprint`` from ``water_sandbox_tpu_torch/bench.py::
fingerprint`` (it reads what the program runs; it takes the program's
``Simulation``, or the harness's ``sharded.Sharded`` around its
``DistributedSimulation``, and imports the program's ``sph_bucket`` for
its picks).
"""

from __future__ import annotations

import torch


def true_pairs(pos: torch.Tensor, h: torch.Tensor,
               temp_bytes: int = 1 << 30) -> int:
    """Directed pairs (i, j) with |p_i - p_j|² <= h², self pairs included:
    an exact O(n²) count over row chunks, each (rows, n) f32 temporary
    near ``temp_bytes``. The squared distance is summed axis by axis from
    the coordinate differences (no |a|² + |b|² - 2ab expansion)."""
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
    lane-tile width of the bucket layout. Of a ``DistributedSimulation``
    also the shard count and the particles each shard holds; its rescue is
    the cross-shard one, and its bucket layout and rows are a shard's, not
    the scene's, so ``tile`` and ``row_group`` stay None."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    cfg = sim.cfg
    shards = getattr(sim, "n_shards", None)
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
    if shards is not None:
        out["n_shards"] = shards
        out["shard_counts"] = sim.shard_counts()
    if cfg.neighbor_mode == "pallas":
        rescue = "sph_rescue" if shards is None else "sph_domain_rescue"
        out["kernels"] = {
            "sph_density": "water_sandbox_tpu_torch/csrc/sph_density.cu",
            "sph_force": "water_sandbox_tpu_torch/csrc/sph_force.cu",
            rescue: f"water_sandbox_tpu_torch/csrc/{rescue}.cu"}
        if shards is not None:
            return out
        out["tile"] = sb._geometry(cfg).T
        if sim.device.type == "cuda":
            out["row_group"] = sb._row_group(
                cfg.n, sb._sm_count(sim.device.index or 0))
    return out
