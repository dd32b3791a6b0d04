"""The plain reference of one step of double-density SPH, in plain PyTorch.

It follows the physics as the upstream sandbox states it
(`qts8n/water-sandbox`, `src/fluid_compute.rs` and its WGSL passes) and
owes nothing to the program under test: its own cell list over all pairs
within h, its own kernel coefficients, equation of state, forces,
integrator, box pose and wall collision, its own clock and its own copy of
the HUD keymap. It imports nothing of the program.

Every function takes the dtype it computes in: float64 for the reference,
bfloat16 for the lower-precision control (``sphbench/calibrate.py``). Inputs
are the positions and velocities of one state in particle-id order, as
float32 values.

One step, per particle i, over the neighbours j with d = |p_j - p_i| <= h
(p the predicted positions, p = x + v * lookahead of the state):

    rho_i   = sum_j (h - d)^2 * pow2   + 1e-5     (self pair included)
    rhon_i  = sum_j (h - d)^3 * pow3   + 1e-5
    P_i     = k (rho_i - rho0),  Pn_i = kn * rhon_i
    F_p     = sum_{j != i} dir * ((P_i + P_j)/2 * (d - h) pow2_der / rho_j
                      + (Pn_i + Pn_j)/2 * (d - h)^2 pow3_der / rhon_j)
    F_v     = sum_{j != i} (v_j - v_i) * (h^2 - d^2)^3 * spikey
    a_i     = F_p / rho_i + mu * F_v          (dir = +y where d == 0)
    v      += (g + a + field) dt;  x += v dt;  wall clamp with the velocity
              flipped by -damping in the frame of the moving, yawing box
              posed at the new time;  p = x + v * lookahead
"""

from __future__ import annotations

import itertools
import math

import torch

DENSITY_PADDING = 1e-5

# The HUD's keys that set one scalar (hud.rs:130-165): key -> (parameter,
# sign of FLUID_PROPS_CHANGE_STEP = 0.1).
KEY_STEP = 0.1
SCALAR_KEYS = {"q": ("pressure_scalar", -1), "w": ("pressure_scalar", 1),
               "a": ("near_pressure_scalar", -1),
               "s": ("near_pressure_scalar", 1),
               "z": ("target_density", -1), "x": ("target_density", 1),
               "e": ("viscosity_strength", -1),
               "r": ("viscosity_strength", 1)}


def coefficients(h: float, dim: int) -> dict:
    """The kernels' normalisations for radius h, in float64."""
    pi = math.pi
    if dim == 3:
        return {"pow2": 15.0 / (2.0 * pi * h**5),
                "pow2_der": 15.0 / (pi * h**5),
                "pow3": 15.0 / (pi * h**6), "pow3_der": 45.0 / (pi * h**6),
                "spikey": 315.0 / (64.0 * pi * h**9)}
    return {"pow2": 6.0 / (pi * h**4), "pow2_der": 12.0 / (pi * h**4),
            "pow3": 10.0 / (pi * h**5), "pow3_der": 30.0 / (pi * h**5),
            "spikey": 4.0 / (pi * h**8)}


def clock(steps: int, dt: float, dtype) -> float:
    """The state's time after ``steps`` steps: dt added ``steps`` times in
    ``dtype``, as the state keeps it (a float32 accumulator)."""
    t = torch.zeros((), dtype=dtype)
    d = torch.tensor(dt, dtype=dtype)
    for _ in range(steps):
        t = t + d
    return float(t)


def tuned(params: dict, keys) -> dict:
    """``params`` after the HUD keys ``keys`` in turn: each key adds its
    step to its parameter as a Python float and the buffer keeps float32
    (the HUD reads the parameter, adds 0.1, writes it back)."""
    import numpy as np
    out = dict(params)
    for k in keys:
        name, sign = SCALAR_KEYS[k]
        out[name] = float(np.float32(out[name] + sign * KEY_STEP))
    return out


def _linear(c: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    key = c[:, 0]
    for a in range(1, c.shape[1]):
        key = key * dims[a] + c[:, a]
    return key


def neighbour_pairs(p: torch.Tensor, h: float, dtype):
    """Directed pairs (i, j) with |p_j - p_i| <= h in ``dtype``, self pairs
    included: a cell list of cells a little wider than h (so that every
    such pair lies in adjacent cells), walked offset by offset. Returns
    (i, j) as int64 tensors."""
    n, dim = p.shape
    p64 = p.to(torch.float64)
    cell_w = h * (1.0 + 1e-6)
    c = torch.floor((p64 - p64.amin(0)) / cell_w).long() + 1
    dims = c.amax(0) + 2
    key = _linear(c, dims)
    skey, order = torch.sort(key)
    pd = p.to(dtype)
    h2 = torch.tensor(h, dtype=dtype, device=p.device) ** 2
    rows = torch.arange(n, device=p.device)
    out_i, out_j = [], []
    for off in itertools.product((-1, 0, 1), repeat=dim):
        nk = _linear(c + torch.tensor(off, device=p.device), dims)
        start = torch.searchsorted(skey, nk)
        cnt = torch.searchsorted(skey, nk, right=True) - start
        total = int(cnt.sum())
        if total == 0:
            continue
        i = torch.repeat_interleave(rows, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        pos = torch.repeat_interleave(start - first, cnt) + torch.arange(
            total, device=p.device)
        j = order[pos]
        d = pd[j] - pd[i]
        keep = (d * d).sum(1) <= h2
        out_i.append(i[keep])
        out_j.append(j[keep])
    return torch.cat(out_i), torch.cat(out_j)


def _rotate(x: list, c, s, inverse: bool = False) -> list:
    """Yaw about +y (3-D) or +z (2-D) by the angle whose cos, sin are c, s."""
    if inverse:
        s = -s
    if len(x) == 2:
        return [c * x[0] - s * x[1], s * x[0] + c * x[1]]
    return [c * x[0] + s * x[2], x[1], -s * x[0] + c * x[2]]


def _collide(pos: list, vel: list, box: dict, radius, damping, t, tol):
    """Clamp into the box posed at time t and flip the wall-relative
    velocity of every axis that hit, in the box's frame. Also returns the
    velocity with the other decision on every axis whose moved position
    lies within ``tol`` of a wall: there the float32 state's rounding
    decides whether the particle hit, and either outcome is the physics."""
    dim = len(pos)
    like = pos[0]

    def cst(v):
        return torch.tensor(v, dtype=like.dtype, device=like.device)
    w = cst(box["angular_velocity"])
    center = [cst(box["center"][a]) + cst(box["velocity"][a]) * t
              for a in range(dim)]
    angle = cst(box["angle"]) + w * t
    c, s = torch.cos(angle), torch.sin(angle)
    rel = [pos[a] - center[a] for a in range(dim)]
    if dim == 2:
        spin = [-w * rel[1], w * rel[0]]
    else:
        spin = [w * rel[2], torch.zeros_like(rel[0]), -w * rel[0]]
    wall = [cst(box["velocity"][a]) + spin[a] for a in range(dim)]
    lp = _rotate(rel, c, s, inverse=True)
    lv = _rotate([vel[a] - wall[a] for a in range(dim)], c, s, inverse=True)
    lv_alt = list(lv)
    for a in range(dim):
        half = cst(box["size"][a]) / 2
        lo, hi = -half + radius, half - radius
        hit = (lp[a] < lo) | (lp[a] > hi)
        near = ((lp[a] - lo).abs() <= tol) | ((lp[a] - hi).abs() <= tol)
        lp[a] = torch.minimum(torch.maximum(lp[a], lo), hi)
        lv_alt[a] = torch.where(hit ^ near, -damping * lv[a], lv[a])
        lv[a] = torch.where(hit, -damping * lv[a], lv[a])
    bp = _rotate(lp, c, s)
    bv = _rotate(lv, c, s)
    bv_alt = _rotate(lv_alt, c, s)
    return ([bp[a] + center[a] for a in range(dim)],
            [bv[a] + wall[a] for a in range(dim)],
            [bv_alt[a] + wall[a] for a in range(dim)])


def step(pos, vel, params: dict, box: dict, steps_done: int,
         dtype=torch.float64, device="cpu") -> dict:
    """One step from the state with positions ``pos`` and velocities ``vel``
    ((n, dim) float32, id order) after ``steps_done`` steps of the run (0:
    the start state, whose predicted positions are its positions). Returns
    the step's fields in ``dtype`` on ``device``: density, near_density,
    pressure, near_pressure, acc, pos, vel, predicted, time, and
    vel_alt, predicted_alt: the outcome with the other wall decision where
    the particle ends within rounding of a wall (``_collide``)."""
    x = torch.as_tensor(pos, device=device).to(dtype)
    v = torch.as_tensor(vel, device=device).to(dtype)
    n, dim = x.shape

    def cst(val):
        return torch.tensor(val, dtype=dtype, device=device)
    h = cst(params["smoothing_radius"])
    co = {k: cst(val) for k, val in
          coefficients(params["smoothing_radius"], dim).items()}
    dt = cst(params["dt"])
    look = cst(params["lookahead"])
    p = x if steps_done == 0 else x + v * look

    i, j = neighbour_pairs(p, params["smoothing_radius"], dtype)
    disp = p[j] - p[i]
    d = torch.sqrt((disp * disp).sum(1))
    u = h - d
    rho = torch.zeros(n, dtype=dtype, device=device).index_add_(
        0, i, u * u * co["pow2"]) + DENSITY_PADDING
    rhon = torch.zeros(n, dtype=dtype, device=device).index_add_(
        0, i, u * u * u * co["pow3"]) + DENSITY_PADDING
    prs = cst(params["pressure_scalar"]) * (
        rho - cst(params["target_density"]))
    nprs = cst(params["near_pressure_scalar"]) * rhon

    other = i != j
    i, j, disp, d = i[other], j[other], disp[other], d[other]
    up = (torch.arange(dim, device=device) == 1).to(dtype)
    safe = torch.where(d > 0, d, torch.ones_like(d))
    direction = torch.where((d > 0)[:, None], disp / safe[:, None], up)
    s = ((prs[i] + prs[j]) / 2 * ((d - h) * co["pow2_der"]) / rho[j]
         + (nprs[i] + nprs[j]) / 2 * ((d - h) ** 2 * co["pow3_der"]) / rhon[j])
    f_p = torch.zeros((n, dim), dtype=dtype, device=device).index_add_(
        0, i, direction * s[:, None])
    wv = (h * h - d * d) ** 3 * co["spikey"]
    f_v = torch.zeros((n, dim), dtype=dtype, device=device).index_add_(
        0, i, (v[j] - v[i]) * wv[:, None])
    acc = f_p / rho[:, None] + cst(params["viscosity_strength"]) * f_v

    # the state's clock is a float32 accumulator; the control keeps it in
    # its own lower precision
    clock_dtype = torch.float32 if dtype == torch.float64 else dtype
    t_new = cst(clock(steps_done + 1, params["dt"], clock_dtype))
    field = params.get("field")
    fa = torch.zeros_like(x)
    if field and field["strength"] != 0.0:
        r = x - torch.tensor(field["position"], dtype=dtype, device=device)
        dist = torch.sqrt((r * r).sum(1, keepdim=True))
        fall = torch.clamp(1 - dist / field["radius"], min=0)
        fa = torch.where(dist > 0, r / torch.where(dist > 0, dist, 1.0),
                         0.0) * field["strength"] * fall
    g = torch.tensor(params["gravity"], dtype=dtype, device=device)
    v1 = v + (g + acc + fa) * dt
    if params["max_speed"] > 0:
        speed = torch.sqrt((v1 * v1).sum(1, keepdim=True))
        v1 = torch.where(speed > params["max_speed"],
                         v1 * (params["max_speed"] / speed), v1)
    x1 = x + v1 * dt
    # a wall decision within 8 float32 ulps of the coordinates' scale
    scale = float(x1.abs().max()) + max(abs(c) for c in box["center"]) + max(
        abs(v) for v in box["velocity"]) * float(t_new)
    xs, vs, vs_alt = _collide([x1[:, a] for a in range(dim)],
                              [v1[:, a] for a in range(dim)], box,
                              cst(params["particle_radius"]),
                              cst(params["collision_damping"]), t_new,
                              8 * 2.0**-23 * scale)
    x1, v1, v_alt = (torch.stack(xs, 1), torch.stack(vs, 1),
                     torch.stack(vs_alt, 1))
    return {"density": rho, "near_density": rhon, "pressure": prs,
            "near_pressure": nprs, "acc": acc, "pos": x1, "vel": v1,
            "predicted": x1 + v1 * look, "time": t_new, "vel_alt": v_alt,
            "predicted_alt": x1 + v_alt * look}


def hud(out: dict, steps: int) -> dict:
    """The HUD's readout of a step's result (the upstream's stats)."""
    speed2 = (out["vel"] ** 2).sum(1)
    return {"step": float(steps), "time": float(out["time"]),
            "kinetic_energy": float(0.5 * speed2.sum()),
            "max_speed": float(speed2.max().sqrt()),
            "mean_density": float(out["density"].mean()),
            "max_density": float(out["density"].max()),
            "mean_pressure": float(out["pressure"].mean())}
