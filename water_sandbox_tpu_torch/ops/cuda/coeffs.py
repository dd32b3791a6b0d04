"""The step's kernel parameters in hand kernels (``csrc/sph_coeffs.cu``):
the five smoothing-kernel coefficients from the radius and the (1, 16)
parameter vector the bucket kernels read.

``run_coeffs`` is ``KernelCoeffs.from_radius`` on a CUDA radius and
``run_param_vector`` is ``sph_bucket._param_vector`` on CUDA tensors; each
gives the bits of the ATen chain those functions run for CPU tensors, and
there is no fallback between the two. Both read their inputs through
device pointers, so a captured step sees what ``Simulation.tune`` copies
into the parameter buffers. They launch through ``_build.launch``, which
counts.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def _check_scalars(what: str, ts) -> torch.device:
    """What the kernels read through raw pointers: one f32 element each,
    all on one CUDA device; returns the device."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{what}: expected one float32 element, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: the kernel reads CUDA tensors on one "
                             f"device, got {t.device} and {dev}")
    return dev


def run_coeffs(h: torch.Tensor, terms) -> tuple:
    """The coefficients num / (den_scale · h**power) of ``terms`` (five
    (num, den_scale, power) triples) from the () radius ``h``, in one
    launch: five () views of one fresh (5,) buffer."""
    dev = _check_scalars("kernel coefficients", (h,))
    if len(terms) != 5:
        raise ValueError(f"kernel coefficients: 5 terms, got {len(terms)}")
    out = torch.empty(5, dtype=torch.float32, device=dev)
    num, den, pw = zip(*terms)
    _build.launch("sph_coeffs", h.data_ptr(), (ctypes.c_float * 5)(*num),
                  (ctypes.c_float * 5)(*den), (ctypes.c_int * 5)(*pw),
                  out.data_ptr(), dev.index or 0,
                  torch.cuda.current_stream(dev).cuda_stream)
    return out.unbind(0)


def run_param_vector(values) -> torch.Tensor:
    """The (1, 16) parameter vector from its ten scalars in slot order
    (``sph_bucket._param_values``), zeros in the other slots, in one
    launch."""
    dev = _check_scalars("parameter vector", values)
    if len(values) != 10:
        raise ValueError(f"parameter vector: 10 values, got {len(values)}")
    out = torch.empty((1, 16), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in values))
    _build.launch("sph_param_vector", ptrs, out.data_ptr(), dev.index or 0,
                  torch.cuda.current_stream(dev).cuda_stream)
    return out
