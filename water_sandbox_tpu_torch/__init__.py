"""water_sandbox_tpu_torch — the PyTorch/CUDA port of water_sandbox_tpu.

Double-density SPH with the same scenes, parameters, state and physics as
the JAX package, on one NVIDIA Hopper GPU: the bucket-grid density and
force passes are hand-written CUDA kernels (``csrc/``), built with nvcc on
first use from a CUDA tensor; on the CPU the same pipeline runs their plain
PyTorch versions.

Quick start::

    import water_sandbox_tpu_torch as wst
    sim = wst.Simulation.from_scene("reference-cube", device="cuda")
    sim.run(200)
    positions = sim.positions()
"""

from .core.params import (Container, InteractionField, KernelCoeffs,
                          SimConfig, SimParams)
from .core.state import FluidState, init_state
from .models import scenes
from .models.scenes import cube_fluid
from .ops.step import rollout, step, trajectory
from .runtime.distributed import DistributedSimulation
from .runtime.runner import Simulation

__version__ = "0.1.0"

__all__ = [
    "Container", "InteractionField", "KernelCoeffs", "SimConfig", "SimParams",
    "FluidState", "init_state", "scenes", "cube_fluid", "step", "rollout",
    "trajectory", "Simulation", "DistributedSimulation", "__version__",
]
