"""SPH smoothing-kernel functions — the counterpart of
``water_sandbox_tpu/ops/kernels.py``. Unmasked: callers apply the inclusive
``d <= h`` support cutoff themselves."""

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
