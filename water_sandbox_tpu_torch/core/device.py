"""The device an entry point of the port runs on.

The port is written for the GPU: ``Simulation.from_scene``,
``scenes.build``, ``DistributedSimulation``, ``make_mesh``, the constructors
(``init_state``, ``SimParams.create``, ``Container.create``,
``InteractionField.inactive``/``.create``), ``checkpoint.load`` and
``convert.params_from_numpy``/``state_from_numpy`` run on CUDA unless the
caller names the CPU (``device="cpu"``). Asking for CUDA where
none is present raises; nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda:0"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} needs a CUDA device and none is present; "
            "pass device='cpu' to run on the CPU")
    return dev
