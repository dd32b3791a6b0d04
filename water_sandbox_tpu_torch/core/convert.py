"""Carry-across between the JAX package's numpy forms and the port's
tensors.

``params_from_numpy`` takes the ``SimParams`` leaves in the order the JAX
package's ``jax.tree.flatten`` yields them (and its checkpoints store
them): the dataclass field order, with ``container`` and ``field`` nested
in place. ``state_from_numpy`` takes a dict of the ``FluidState`` fields. Both put the
tensors on the card unless ``device`` says otherwise (``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import device as device_mod
from .params import Container, InteractionField, SimParams
from .state import FluidState

_STATE_DTYPES = {"step_count": torch.int32, "overflow": torch.int32,
                 "ids": torch.int32}


def _nested(obj):
    """Leaves of a params dataclass in flatten order."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from _nested(v)


def params_to_numpy(params: SimParams) -> list[np.ndarray]:
    return [t.detach().cpu().numpy() for t in _nested(params)]


def params_from_numpy(leaves, device=device_mod.DEFAULT) -> SimParams:
    device = device_mod.resolve(device)
    it = iter(leaves)

    def take(cls):
        kw = {}
        for name in (f.name for f in dataclasses.fields(cls)):
            if cls is SimParams and name == "container":
                kw[name] = take(Container)
            elif cls is SimParams and name == "field":
                kw[name] = take(InteractionField)
            else:
                kw[name] = torch.tensor(np.asarray(next(it)),
                                        dtype=torch.float32, device=device)
        return cls(**kw)

    params = take(SimParams)
    if next(it, None) is not None:
        raise ValueError("more SimParams leaves than fields")
    return params


def state_to_numpy(state: FluidState) -> dict[str, np.ndarray]:
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def state_from_numpy(fields: dict,
                     device=device_mod.DEFAULT) -> FluidState:
    device = device_mod.resolve(device)
    kw = {}
    for f in dataclasses.fields(FluidState):
        if f.name == "ids" and "ids" not in fields:
            # checkpoints from before ids existed: rows are in id order
            n = np.asarray(fields["pos"]).shape[0]
            kw["ids"] = torch.arange(n, dtype=torch.int32, device=device)
            continue
        kw[f.name] = torch.tensor(
            np.asarray(fields[f.name]),
            dtype=_STATE_DTYPES.get(f.name, torch.float32), device=device)
    return FluidState(**kw)
