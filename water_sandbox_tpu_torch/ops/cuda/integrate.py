"""The integrate phase in one kernel (``csrc/sph_integrate.cu``): the field,
the velocity update, the speed clamp, the box collision and the
prediction — ``ops/integrate.py::integrate`` on CUDA tensors.

``run_integrate`` launches the kernel and gives the bits of
``ops/integrate.py::integrate_plain``, the ATen chain that ``integrate``
runs for CPU tensors; there is no fallback between the two. The kernel
reads the parameters through the ``SimParams`` leaves' device pointers, so
a captured step sees what ``Simulation.tune`` copies into them. It
launches through ``_build.launch``, which counts.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.params import SimParams
from . import _build

def _leaves(params: SimParams, t_new: torch.Tensor, dim: int):
    """(tensor, element count) of each parameter the kernel reads, in the
    order of ``csrc/sph_integrate.cu::IntegrateParams``."""
    c, f = params.container, params.field
    return ((params.dt, 1), (params.gravity, dim), (params.max_speed, 1),
            (params.lookahead, 1), (params.particle_radius, 1),
            (params.collision_damping, 1), (c.center, dim),
            (c.velocity, dim), (c.angle, 1), (c.angular_velocity, 1),
            (c.half_size, dim), (f.position, dim), (f.strength, 1),
            (f.radius, 1), (t_new, 1))


def _check_inputs(pos, vel, acc, leaves) -> None:
    """What the kernel reads through raw pointers: f32 (n, 2 or 3) rows of
    one shape at any strides, f32 parameters of their sizes laid out
    densely, everything on one CUDA device."""
    for name, t in (("pos", pos), ("vel", vel), ("acc", acc)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"integrate {name}: expected float32 (n, dim), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if vel.shape != pos.shape or acc.shape != pos.shape:
        raise ValueError(f"integrate: pos, vel, acc shapes {tuple(pos.shape)}"
                         f", {tuple(vel.shape)}, {tuple(acc.shape)} differ")
    if pos.shape[1] not in (2, 3):
        raise ValueError(f"integrate: dim must be 2 or 3, got {pos.shape[1]}")
    for t, size in leaves:
        if (t.dtype != torch.float32 or t.numel() != size
                or not t.is_contiguous()):
            raise ValueError(f"integrate parameters: expected contiguous "
                             f"float32 of {size} elements, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if pos.device.type != "cuda":
        raise ValueError(f"the integrate kernel runs on CUDA tensors, not "
                         f"{pos.device}")
    if any(t.device != pos.device
           for t in (vel, acc, *(leaf for leaf, _ in leaves))):
        raise ValueError("integrate inputs must share one device")


def run_integrate(pos, vel, acc, params: SimParams, t_new):
    """One integration step at absolute time ``t_new`` (a () tensor) on
    (n, dim) CUDA rows at any strides: returns fresh contiguous (pos, vel,
    predicted), the bits of ``integrate_plain``."""
    n, dim = pos.shape
    leaves = _leaves(params, t_new, dim)
    _check_inputs(pos, vel, acc, leaves)
    dev = pos.device
    out = [torch.empty((n, dim), dtype=torch.float32, device=dev)
           for _ in range(3)]
    ptrs = (ctypes.c_void_p * len(leaves))(*(t.data_ptr() for t, _ in leaves))
    _build.launch(
        "sph_integrate", pos.data_ptr(), *pos.stride(), vel.data_ptr(),
        *vel.stride(), acc.data_ptr(), *acc.stride(), ptrs,
        *(t.data_ptr() for t in out), n, dim, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    return tuple(out)
