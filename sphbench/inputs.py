"""Inputs made from a configuration file and ``--seed``: the start state,
and the port's objects built from it through its public constructors.

The start state is the configuration's lattice (``lattice`` points a side
at twice the particle radius, centred on ``lattice_center``), each point
moved by a uniform offset of at most ``jitter`` of the spacing on each
axis, drawn on the device by a ``torch.Generator`` from the seed. Every
seed gives the same sizes; only the offsets differ.
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_NAMES = ("dt", "collision_damping", "smoothing_radius",
               "target_density", "pressure_scalar", "near_pressure_scalar",
               "viscosity_strength", "lookahead", "particle_radius",
               "max_speed")


def f32(x):
    """A value, or each value of a list, rounded to float32 as the
    program's buffers keep it."""
    if isinstance(x, (list, tuple)):
        return [float(np.float32(v)) for v in x]
    return float(np.float32(x))


def params(conf: dict) -> dict:
    """The configuration's physical parameters as float32 values."""
    return {k: f32(v) for k, v in conf["params"].items()}


def box(conf: dict) -> dict:
    return {k: f32(v) for k, v in conf["container"].items()}


def start_positions(conf: dict, seed: int, device) -> torch.Tensor:
    """(n, dim) float32 start positions on ``device`` for ``seed``."""
    dims = conf["lattice"]
    r = np.float32(conf["params"]["particle_radius"])
    half = torch.tensor(dims, dtype=torch.float32) * r
    offset = (r - half).to(device)
    axes = [torch.arange(d, dtype=torch.float32, device=device) * (2 * r)
            for d in dims]
    grids = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([g.reshape(-1) for g in grids], dim=-1) + offset
    pts = pts + torch.tensor(conf["lattice_center"], dtype=torch.float32,
                             device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    u = torch.rand(pts.shape, generator=gen, device=device,
                   dtype=torch.float32)
    amp = np.float32(conf["jitter"]) * (2 * r)
    if pts.shape[0] != conf["n"]:
        raise ValueError(f"lattice {dims} holds {pts.shape[0]} points, the "
                         f"configuration says n = {conf['n']}")
    return pts + (2 * u - 1) * amp


def simulation(conf: dict, pos: torch.Tensor, name: str):
    """The port's ``Simulation`` over start positions ``pos``, built from
    the configuration through ``SimConfig``, ``SimParams.create`` and
    ``init_state``; where the configuration names its ``runtime``
    (``{"kind": "distributed", "n_shards", "slack", "mig_cap"}``), the
    port's ``DistributedSimulation`` built from the same objects."""
    from water_sandbox_tpu_torch.core.params import (Container, SimConfig,
                                                     SimParams)
    from water_sandbox_tpu_torch.core.state import init_state
    from water_sandbox_tpu_torch.runtime.runner import Simulation

    device = pos.device
    sc = dict(conf["sim_config"])
    sc["grid_dims"] = tuple(sc["grid_dims"])
    cfg = SimConfig(n=conf["n"], dim=conf["dim"], **sc)
    c = conf["container"]
    container = Container.create(c["center"], c["size"],
                                 velocity=c["velocity"],
                                 angular_velocity=c["angular_velocity"],
                                 angle=c["angle"], device=device)
    p = conf["params"]
    prm = SimParams.create(dim=conf["dim"], gravity=p["gravity"],
                           container=container, device=device,
                           **{k: p[k] for k in PARAM_NAMES})
    if "runtime" in conf:
        return _distributed(conf["runtime"], cfg, prm,
                            init_state(pos, device=device), name, device)
    return Simulation(cfg, prm, init_state(pos, device=device), name=name,
                      device=device)


def _distributed(rt: dict, cfg, prm, state, name: str, device):
    from water_sandbox_tpu_torch.runtime.distributed import (
        DistributedSimulation)
    if rt.get("kind") != "distributed":
        raise ValueError(f"unknown runtime {rt!r}: the benchmark builds a "
                         "'distributed' runtime or, without the key, a "
                         "Simulation")
    return DistributedSimulation(cfg, prm, state, n_shards=rt["n_shards"],
                                 slack=rt["slack"], mig_cap=rt["mig_cap"],
                                 name=name, device=device)
