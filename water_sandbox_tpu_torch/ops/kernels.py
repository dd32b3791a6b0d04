"""SPH smoothing-kernel functions — the counterpart of
``water_sandbox_tpu/ops/kernels.py``. The kernels are unmasked;
``support_mask`` is the inclusive ``d <= h`` support cutoff."""

from __future__ import annotations

import torch

from ..core.params import KernelCoeffs


def w_density(d: torch.Tensor, h, k: KernelCoeffs) -> torch.Tensor:
    """Spiky² density kernel: (h-d)² · pow2."""
    v = h - d
    return v * v * k.pow2


def w_near(d: torch.Tensor, h, k: KernelCoeffs) -> torch.Tensor:
    """Spiky³ near-density kernel: (h-d)³ · pow3."""
    v = h - d
    return v * v * v * k.pow3


def dw_density(d: torch.Tensor, h, k: KernelCoeffs) -> torch.Tensor:
    """Derivative of the density kernel: (d-h) · pow2_der."""
    return (d - h) * k.pow2_der


def dw_near(d: torch.Tensor, h, k: KernelCoeffs) -> torch.Tensor:
    """Derivative of the near kernel: (d-h)² · pow3_der (positive, as in
    the reference, which drops the sign when squaring)."""
    v = d - h
    return v * v * k.pow3_der


def w_viscosity(d: torch.Tensor, h, k: KernelCoeffs) -> torch.Tensor:
    """Poly6 kernel used for viscosity: (h²-d²)³ · spikey_pow3."""
    v = h * h - d * d
    return v * v * v * k.spikey_pow3


def support_mask(d: torch.Tensor, h) -> torch.Tensor:
    """Inside-support mask, inclusive of d == h like the reference."""
    return d <= h


def up_direction(dim: int, dtype, device) -> torch.Tensor:
    """+y, the direction a pair at distance 0 is pushed along: [0, 1] or
    [0, 1, 0] (JAX's ``jnp.zeros(dim).at[1].set(1.0)``). Made on the
    device: an item assignment would copy its scalar from the host, which a
    CUDA graph capture refuses."""
    return (torch.arange(dim, device=device) == 1).to(dtype)
