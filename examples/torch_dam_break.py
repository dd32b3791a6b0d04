"""Dam break end-to-end on the PyTorch/CUDA port: run, tune mid-flight,
export, render — the counterpart of ``examples/dam_break.py``.

    python examples/torch_dam_break.py                      # the card
    python examples/torch_dam_break.py --device cpu --frames 2 --steps 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import water_sandbox_tpu_torch as wst
from water_sandbox_tpu_torch.io.export import TrajectoryWriter
from water_sandbox_tpu_torch.viz import raster, render


def main(device: str = "cuda", frames: int = 20, steps: int = 16,
         out_dir: str = ".") -> dict:
    sim = wst.Simulation.from_scene("dam-break-2d-4k", device=device)
    writer = TrajectoryWriter(os.path.join(out_dir, "dam_break_traj.npz"),
                              {"scene": sim.name})

    for frame in range(frames):
        sim.run(steps)
        writer.add_frame(sim.positions(), float(sim.state.time))
        if frame == frames // 2 - 1:
            # mid-run tuning — the HUD keymap analogue, no recapture
            sim.tune(viscosity_strength=0.2)
            sim.tune(field={"position": (4.0, -3.0), "strength": 30.0,
                            "radius": 2.5})

    stats = sim.stats()
    print(stats)
    print(raster.ascii_preview(
        raster.density_image(sim.state, sim.params, 96, 28)))

    traj = writer.write()
    gif = render.render_trajectory_gif(
        traj, os.path.join(out_dir, "dam_break.gif"), sim.params)
    print(f"wrote {traj} and {gif}")
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--steps", type=int, default=16,
                    help="steps a frame")
    ap.add_argument("--out-dir", default=".")
    a = ap.parse_args()
    main(a.device, a.frames, a.steps, a.out_dir)
