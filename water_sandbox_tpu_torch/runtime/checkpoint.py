"""Checkpoint save/restore in the JAX package's npz format, both ways: one
.npz holding every FluidState field (``state.<name>``), the SimParams leaves
in flatten order (``param.<i>``), ``num_param_leaves`` and the SimConfig as
``config_json``."""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..core import convert, device as device_mod
from ..core.params import SimConfig, SimParams
from ..core.state import FluidState

_STATE_PREFIX = "state."
_PARAM_PREFIX = "param."


def save(path: str, state: FluidState, params: SimParams,
         cfg: SimConfig) -> None:
    payload = {_STATE_PREFIX + k: v
               for k, v in convert.state_to_numpy(state).items()}
    leaves = convert.params_to_numpy(params)
    for i, leaf in enumerate(leaves):
        payload[f"{_PARAM_PREFIX}{i}"] = leaf
    payload["config_json"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
    payload["num_param_leaves"] = np.asarray(len(leaves))
    np.savez_compressed(path, **payload)


def load(path: str, device=device_mod.DEFAULT):
    """Returns (state, params, cfg) with tensors on ``device``: the card
    unless the caller names another (``device="cpu"`` for the CPU)."""
    device = device_mod.resolve(device)
    with np.load(path, allow_pickle=False) as data:
        cfg = SimConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in json.loads(str(data["config_json"])).items()})
        state = convert.state_from_numpy(
            {k[len(_STATE_PREFIX):]: data[k] for k in data.files
             if k.startswith(_STATE_PREFIX)}, device)
        leaves = [data[f"{_PARAM_PREFIX}{i}"]
                  for i in range(int(data["num_param_leaves"]))]
    return state, convert.params_from_numpy(leaves, device), cfg
