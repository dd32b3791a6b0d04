"""Semi-implicit Euler integration + boundary collision + prediction — the
counterpart of ``water_sandbox_tpu/ops/integrate.py``, in the same axes
form (per-axis lists of tensors of any common shape).

    v += (g + a + field)·dt;  optional |v| clamp;  x += v·dt;
    box clamp with velocity flip ×(-damping) in the container's frame;
    predicted = x + v·lookahead

On CUDA tensors ``integrate`` launches one kernel of the same bits
(``csrc/sph_integrate.cu``); ``integrate_plain`` is the chain on any
device.
"""

from __future__ import annotations

import torch

from ..core.params import Container, InteractionField, SimParams


def _axes(x: torch.Tensor) -> list[torch.Tensor]:
    return [x[:, a] for a in range(x.shape[1])]


def _stack(xs: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(xs, dim=1)


def field_acceleration_axes(pos: list[torch.Tensor],
                            field: InteractionField) -> list[torch.Tensor]:
    """Point repulsor (strength > 0) / attractor (strength < 0) with linear
    falloff over ``radius``. Zero strength disables (exactly zero force)."""
    disp = [pos[a] - field.position[a] for a in range(len(pos))]
    r2 = disp[0] * disp[0]
    for a in range(1, len(pos)):
        r2 = r2 + disp[a] * disp[a]
    r = torch.sqrt(r2)
    safe_r = torch.where(r > 0.0, r, 1.0)
    falloff = torch.clamp_min(1.0 - r / field.radius, 0.0)
    scale = field.strength * falloff
    return [torch.where(r > 0.0, d / safe_r, 0.0) * scale for d in disp]


def field_acceleration(pos: torch.Tensor,
                       field: InteractionField) -> torch.Tensor:
    return _stack(field_acceleration_axes(_axes(pos), field))


def _rotate_yaw_axes(x: list[torch.Tensor], angle: torch.Tensor,
                     inverse: bool = False) -> list[torch.Tensor]:
    """Yaw rotation (about +z in 2-D, +y in 3-D) with explicit
    multiply-adds. Never a matmul: a reduced-precision product (bf16 on a
    TPU, TF32 on a GPU) rounds every position each step, coincident pairs
    form and the simulation detonates."""
    c, s = torch.cos(angle), torch.sin(angle)
    if inverse:
        s = -s
    if len(x) == 2:
        return [c * x[0] - s * x[1], s * x[0] + c * x[1]]
    return [c * x[0] + s * x[2], x[1], -s * x[0] + c * x[2]]


def _rotate_yaw(x: torch.Tensor, angle: torch.Tensor,
                inverse: bool = False) -> torch.Tensor:
    return _stack(_rotate_yaw_axes(_axes(x), angle, inverse))


def container_at(container: Container, t: torch.Tensor):
    """Box pose at absolute sim time t: (center, yaw angle)."""
    return (container.center + container.velocity * t,
            container.angle + container.angular_velocity * t)


def collide_container_axes(pos, vel, container: Container, padding,
                           damping, t):
    """Clamp + velocity flip against the box posed at time t, resolved in
    the box frame against the wall-relative velocity."""
    dim = len(pos)
    center, angle = container_at(container, t)
    rel = [pos[a] - center[a] for a in range(dim)]
    w = container.angular_velocity
    if dim == 2:
        spin = [w * (-rel[1]), w * rel[0]]
    else:
        # omega = (0, w, 0);  omega x r = (w*r_z, 0, -w*r_x)
        spin = [w * rel[2], torch.zeros_like(rel[0]), w * (-rel[0])]
    wall_vel = [container.velocity[a] + spin[a] for a in range(dim)]

    local_pos = _rotate_yaw_axes(rel, angle, inverse=True)
    local_vel = _rotate_yaw_axes(
        [vel[a] - wall_vel[a] for a in range(dim)], angle, inverse=True)

    lo = -container.half_size + padding
    hi = container.half_size - padding
    for a in range(dim):
        hit = (local_pos[a] < lo[a]) | (local_pos[a] > hi[a])
        local_pos[a] = torch.clamp(local_pos[a], lo[a], hi[a])
        local_vel[a] = torch.where(hit, local_vel[a] * (-damping),
                                   local_vel[a])

    back_pos = _rotate_yaw_axes(local_pos, angle)
    back_vel = _rotate_yaw_axes(local_vel, angle)
    return ([back_pos[a] + center[a] for a in range(dim)],
            [back_vel[a] + wall_vel[a] for a in range(dim)])


def collide_container(pos, vel, container: Container, padding, damping, t):
    p, v = collide_container_axes(_axes(pos), _axes(vel), container,
                                  padding, damping, t)
    return _stack(p), _stack(v)


def integrate_axes(pos, vel, acc, params: SimParams, t_new):
    """One integration step at absolute time t_new (post-step time), on
    per-axis tensors. Returns (pos, vel, predicted) axes lists."""
    dim = len(pos)
    fa = field_acceleration_axes(pos, params.field)
    vel = [vel[a] + (params.gravity[a] + acc[a] + fa[a]) * params.dt
           for a in range(dim)]
    speed2 = vel[0] * vel[0]
    for a in range(1, dim):
        speed2 = speed2 + vel[a] * vel[a]
    limit = params.max_speed
    scale = torch.where((limit > 0.0) & (speed2 > limit * limit),
                        limit * torch.rsqrt(torch.clamp_min(speed2, 1e-30)),
                        1.0)
    vel = [v * scale for v in vel]
    pos = [pos[a] + vel[a] * params.dt for a in range(dim)]
    pos, vel = collide_container_axes(pos, vel, params.container,
                                      params.particle_radius,
                                      params.collision_damping, t_new)
    predicted = [pos[a] + vel[a] * params.lookahead for a in range(dim)]
    return pos, vel, predicted


def integrate_plain(pos, vel, acc, params: SimParams, t_new):
    """One integration step on (n, dim) rows as the ATen chain of
    ``integrate_axes``. Returns (pos, vel, predicted)."""
    p, v, pr = integrate_axes(_axes(pos), _axes(vel), _axes(acc), params,
                              t_new)
    return _stack(p), _stack(v), _stack(pr)


def integrate(pos, vel, acc, params: SimParams, t_new):
    """One integration step on (n, dim) rows. Returns (pos, vel, predicted):
    ``integrate_plain`` for CPU tensors, one kernel of the same bits for
    CUDA tensors (``ops/cuda/integrate.py::run_integrate``)."""
    if pos.device.type == "cpu":
        return integrate_plain(pos, vel, acc, params, t_new)
    from .cuda.integrate import run_integrate
    return run_integrate(pos, vel, acc, params, t_new)
