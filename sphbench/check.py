"""The comparison that decides ``correct``.

SPH is chaotic: two correct programs part ways within a few hundred
steps, so no reference can follow a run over its window. The reference
(``sphbench/reference/sph.py``, float64) follows the program step by step
instead: from the positions and velocities of the program's state before
each sampled step, it works out the step again (the predicted positions,
its own clock, the parameters from its own copy of the HUD's keys, the
box's pose, every pair within h) and judges the program's state after the
step, and in the frames cell the frame's reads. A sample right after a
reset starts from the reference's own start state (the inputs made from
the seed), which checks the reset. The start itself is checked apart, by
the gap between the program's start state and the inputs.

Each number is the worst over the samples of a gap, taken particle by
particle (``_gaps``), over a scale that makes it a share:

    density   densities and pressures, relative to the reference's
    acc       acceleration, over the rms of the reference's
    pos       position and predicted position, over h
    vel       velocity, over |g| dt (one step's fall)

(velocities and predicted positions against the nearer of the reference's
two outcomes where a particle ends within float32 rounding of a wall, as
``reference/sph.py::_collide`` sets out)
    clock     step count, and time over dt
    readback_pos, readback_vel
              the frame's id-ordered positions over h, velocities over
              |g| dt
    hud       the HUD's stats, relative (pressure over k times density)
    params    the parameters after the HUD's keys, over the key step 0.1
    start     the program's start state against the inputs, absolute

A number that is not finite reads as infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import inputs
from .reference import sph

STATE_FIELDS = ("density", "near_density", "pressure", "near_pressure",
                "acc", "pos", "vel", "predicted")


def by_id(state) -> dict:
    """The state's per-particle fields as float64 numpy arrays in id order,
    and its scalars; None if ``ids`` is no permutation."""
    ids = state.ids.long().cpu().numpy()
    n = ids.shape[0]
    if not np.array_equal(np.sort(ids), np.arange(n)):
        return None
    out = {}
    for name in STATE_FIELDS:
        a = getattr(state, name).double().cpu().numpy()
        o = np.empty_like(a)
        o[ids] = a
        out[name] = o
    out["step"] = float(state.step_count)
    out["time"] = float(state.time)
    return out


def _worst(x) -> float:
    x = np.asarray(x, dtype=np.float64)
    if x.size == 0:
        return 0.0
    if not np.all(np.isfinite(x)):
        return math.inf
    return float(x.max())


def _norm(a):
    return np.sqrt((np.asarray(a) ** 2).sum(axis=-1))


def _either(got, want, alt):
    """Each particle's gap to the nearer of the reference's two outcomes
    (they differ only where a wall decision lies within rounding)."""
    return np.minimum(_norm(got - want), _norm(got - alt))


def _gaps(prog: dict, ref: dict, prm: dict, steps: int) -> dict:
    h = prm["smoothing_radius"]
    dt = prm["dt"]
    fall = max(float(np.linalg.norm(prm["gravity"])), 1.0) * dt
    k, kn = prm["pressure_scalar"], prm["near_pressure_scalar"]
    rho, rhon = ref["density"], ref["near_density"]
    acc_scale = math.sqrt(float((ref["acc"] ** 2).sum(1).mean())) or 1.0
    return {
        "density": max(
            _worst(np.abs(prog["density"] - rho) / rho),
            _worst(np.abs(prog["near_density"] - rhon) / rhon),
            _worst(np.abs(prog["pressure"] - ref["pressure"])
                   / (abs(k) * rho + 1e-30)),
            _worst(np.abs(prog["near_pressure"] - ref["near_pressure"])
                   / (abs(kn) * rhon + 1e-30))),
        "acc": _worst(_norm(prog["acc"] - ref["acc"]) / acc_scale),
        "pos": max(_worst(_norm(prog["pos"] - ref["pos"]) / h),
                   _worst(_either(prog["predicted"], ref["predicted"],
                                  ref["predicted_alt"]) / h)),
        "vel": _worst(_either(prog["vel"], ref["vel"], ref["vel_alt"])
                      / fall),
        "clock": max(abs(prog["step"] - steps),
                     _worst([abs(prog["time"] - float(ref["time"])) / dt])),
    }


def _reads_gaps(reads: dict, ref: dict, prm: dict, prog_hud: dict,
                steps: int) -> dict:
    h = prm["smoothing_radius"]
    fall = max(float(np.linalg.norm(prm["gravity"])), 1.0) * prm["dt"]
    out = {}
    if "positions" in reads:
        out["readback_pos"] = _worst(_norm(
            np.asarray(reads["positions"], np.float64) - ref["pos"]) / h)
    if "velocities" in reads:
        out["readback_vel"] = _worst(_either(
            np.asarray(reads["velocities"], np.float64), ref["vel"],
            ref["vel_alt"]) / fall)
    if prog_hud is not None:
        want = sph.hud({k: torch.as_tensor(v) for k, v in ref.items()},
                       steps)
        k = abs(prm["pressure_scalar"])
        gaps = [abs(prog_hud["step"] - want["step"]),
                abs(prog_hud["time"] - want["time"]) / prm["dt"],
                abs(prog_hud["mean_pressure"] - want["mean_pressure"])
                / (k * want["mean_density"])]
        for key in ("kinetic_energy", "max_speed", "mean_density",
                    "max_density"):
            gaps.append(abs(prog_hud[key] - want[key]) / abs(want[key]))
        out["hud"] = _worst(gaps)
    return out


def _params_gap(got: dict, want: dict) -> float:
    gaps = []
    for k in inputs.PARAM_NAMES:
        gaps.append(abs(got[k] - want[k]) / sph.KEY_STEP)
    gaps += [abs(a - b) / sph.KEY_STEP
             for a, b in zip(got["gravity"], want["gravity"])]
    return _worst(gaps)


def _np(out: dict) -> dict:
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def sample_numbers(sm, conf: dict, seed: int, device, control: bool) -> dict:
    """The numbers of one sample: the program's (or, with ``control``, the
    bfloat16 reference's put in its place) against the float64
    reference."""
    prm = sph.tuned(inputs.params(conf), sm.keys)
    box = inputs.box(conf)
    if sm.steps_done == 0:
        pos = inputs.start_positions(conf, seed, device)
        vel = torch.zeros_like(pos)
    else:
        pre = by_id(sm.pre)
        if pre is None:
            return {"density": math.inf}
        pos, vel = pre["pos"].astype(np.float32), pre["vel"].astype(np.float32)
    ref = _np(sph.step(pos, vel, prm, box, sm.steps_done, torch.float64,
                       device))
    if control:
        low = _np(sph.step(pos, vel, prm, box, sm.steps_done, torch.bfloat16,
                           device))
        prog = dict(low, step=float(sm.steps_done + 1),
                    time=float(low["time"]))
        reads = {}
        if "positions" in sm.reads:
            reads["positions"] = low["pos"]
        if "velocities" in sm.reads:
            reads["velocities"] = low["vel"]
        hud = (sph.hud({k: torch.as_tensor(v) for k, v in low.items()},
                       sm.steps_done + 1) if "stats" in sm.reads else None)
        got_params = {k: float(torch.tensor(v, dtype=torch.bfloat16))
                      if not isinstance(v, list) else
                      [float(torch.tensor(x, dtype=torch.bfloat16))
                       for x in v] for k, v in prm.items()}
    else:
        prog = by_id(sm.post)
        if prog is None:
            return {"density": math.inf}
        reads = sm.reads
        hud = sm.reads.get("stats")
        got_params = sm.params
    out = _gaps(prog, ref, prm, sm.steps_done + 1)
    out.update(_reads_gaps(reads, ref, prm, hud, sm.steps_done + 1))
    if got_params:
        out["params"] = _params_gap(got_params, prm)
    return out


def numbers(samples, conf: dict, seed: int, device, start_gap,
            control: bool = False) -> dict:
    """The worst of each number over ``samples``, and the start's gap (the
    control's: its start positions rounded to bfloat16)."""
    if control:
        pos = inputs.start_positions(conf, seed, device)
        start_gap = float((pos.bfloat16().float() - pos).abs().max())
    worst: dict = {"start": start_gap}
    for sm in samples:
        for k, v in sample_numbers(sm, conf, seed, device, control).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def judge(got: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; a number
    without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": got.get(k), "limit": limits.get(k)}
              for k in sorted(set(got) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def rescued_rows(state, conf: dict, steps_done: int) -> int:
    """Particles beyond the cell capacity in the program's bucket grid at
    the state's predicted positions (the rows its rescue computes): the
    grid worked out again from the configuration, for the record only."""
    sc = conf["sim_config"]
    prm = inputs.params(conf)
    box = inputs.box(conf)
    h = prm["smoothing_radius"]
    p = state.predicted.double()
    if steps_done == 0:
        p = state.pos.double()
    if sc.get("grid_frame") == "container":
        t = sph.clock(steps_done, prm["dt"], torch.float32)
        c = [box["center"][a] + box["velocity"][a] * t for a in range(3)]
        ang = box["angle"] + box["angular_velocity"] * t
        rel = p - torch.tensor(c, dtype=p.dtype, device=p.device)
        co, si = math.cos(ang), math.sin(ang)
        p = torch.stack([co * rel[:, 0] - si * rel[:, 2], rel[:, 1],
                         si * rel[:, 0] + co * rel[:, 2]], 1)
    dims = sc["grid_dims"]
    cell = torch.floor((p - (p.amin(0) - h)) / h).long()
    key = torch.zeros_like(cell[:, 0])
    for a, d in enumerate(dims):
        key = key * d + cell[:, a].clamp(0, d - 1)
    counts = torch.bincount(key)
    return int((counts - sc["cell_capacity"]).clamp(min=0).sum())
