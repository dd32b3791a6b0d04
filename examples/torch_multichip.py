"""Domain-decomposed run over a shard mesh on the PyTorch/CUDA port — the
counterpart of ``examples/multichip.py``. The shards share one device (the
card, or the CPU); on the card the step is one captured CUDA graph.

    python examples/torch_multichip.py                      # 4 shards
    python examples/torch_multichip.py --device cpu --shards 2 --rounds 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import water_sandbox_tpu_torch as wst


def main(device: str = "cuda", n_shards: int = 4, rounds: int = 5,
         steps: int = 4) -> dict:
    pts = wst.cube_fluid(12, 8, 8)
    params = wst.SimParams.create(
        dim=3, container=wst.Container.create((0, 0, 0), (6.0, 4.0, 4.0),
                                              device=device),
        device=device)
    cfg = wst.SimConfig(n=pts.shape[0], dim=3,
                        grid_dims=(8 * n_shards, 20, 20), cell_capacity=16)
    sim = wst.DistributedSimulation(cfg, params,
                                    wst.init_state(pts, device=device),
                                    n_shards=n_shards, slack=float(n_shards),
                                    device=device)
    for _ in range(rounds):
        sim.run(steps)
        st = sim.stats()
        print(f"step {st['step']:3d} per-device {st['per_device_counts']} "
              f"lost={st['lost_particles']}")
    return st


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=4)
    a = ap.parse_args()
    main(a.device, a.shards, a.rounds, a.steps)
