"""Offline rendering of simulations and exported trajectories — the
counterpart of ``water_sandbox_tpu/viz/render.py``: any state or exported
trajectory (io/export.py) to PNGs / an animated GIF with matplotlib (and
Pillow for the GIF), particles colored by speed. matplotlib is imported
only when a render is asked for.
"""

from __future__ import annotations

import numpy as np


def _axes_for(params):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = params.container
    lo = (c.center - c.half_size).cpu().numpy().astype(np.float32)
    hi = (c.center + c.half_size).cpu().numpy().astype(np.float32)
    fig, ax = plt.subplots(figsize=(8, 8 * (hi[1] - lo[1]) / (hi[0] - lo[0])))
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_aspect("equal")
    ax.set_facecolor("#0b0e14")
    fig.patch.set_facecolor("#0b0e14")
    ax.tick_params(colors="#888888", labelsize=7)
    for s in ax.spines.values():
        s.set_color("#444444")
    return fig, ax


def render_frame(positions, velocities, params, path: str,
                 point_size: float = 2.0) -> str:
    """One state (host arrays, e.g. ``sim.positions()``) → one PNG (x-y
    plane; 3-D scenes are projected)."""
    import matplotlib.pyplot as plt

    pos = np.asarray(positions)
    speed = np.linalg.norm(np.asarray(velocities), axis=1)
    fig, ax = _axes_for(params)
    ax.scatter(pos[:, 0], pos[:, 1], c=speed, s=point_size, cmap="cool",
               linewidths=0, rasterized=True)
    fig.savefig(path, dpi=120, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return path


def render_trajectory_gif(traj_path: str, out_path: str, params,
                          fps: int = 20, point_size: float = 2.0,
                          max_frames: int = 200) -> str:
    """Exported trajectory (.npz from io/export.py) → animated GIF."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import PillowWriter

    from ..io.export import load_trajectory

    positions, times, _ = load_trajectory(traj_path)
    stride = max(1, len(positions) // max_frames)
    frames = positions[::stride]

    fig, ax = _axes_for(params)
    scat = ax.scatter(frames[0][:, 0], frames[0][:, 1], s=point_size,
                      c="#5ad1e6", linewidths=0)
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, out_path, dpi=80):
        for f in frames:
            scat.set_offsets(f[:, :2])
            writer.grab_frame()
    plt.close(fig)
    return out_path
