"""Dense O(N²) all-pairs SPH passes, the correctness oracle — the
counterpart of ``water_sandbox_tpu/ops/dense.py``.

The same physics as the cell-list passes, over all pairs: identical for
true neighbourhoods because every candidate is distance-filtered. To
emulate the reference's hash-collision multi-count (a pair accumulated once
per neighbour offset whose hash collides with the pair's cell hash) both
passes take an optional ``pair_weight`` (n, n) integer matrix from
``hashing.reference_pair_weights``.

Plain PyTorch on the tensors' device; memory is O(N²), use for n ≲ 16k.
"""

from __future__ import annotations

import torch

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimParams
from . import kernels


def _pairwise_dist(predicted: torch.Tensor):
    """d_ij = p_j - p_i (n, n, dim) and its length (n, n)."""
    disp = predicted[None, :, :] - predicted[:, None, :]
    return disp, torch.sqrt((disp * disp).sum(dim=-1))


def density_pass(predicted: torch.Tensor, params: SimParams,
                 coeffs: KernelCoeffs, pair_weight: torch.Tensor | None = None):
    """Densities and the equation of state; the self pair is included (the
    reference's cell walk visits the particle itself). Returns (density,
    near_density, pressure, near_pressure)."""
    h = params.smoothing_radius
    _, dist = _pairwise_dist(predicted)
    inside = kernels.support_mask(dist, h)
    w = torch.where(inside, kernels.w_density(dist, h, coeffs), 0.0)
    wn = torch.where(inside, kernels.w_near(dist, h, coeffs), 0.0)
    if pair_weight is not None:
        w = w * pair_weight
        wn = wn * pair_weight
    density = w.sum(dim=1) + DENSITY_PADDING
    near_density = wn.sum(dim=1) + DENSITY_PADDING
    pressure = params.pressure_scalar * (density - params.target_density)
    near_pressure = params.near_pressure_scalar * near_density
    return density, near_density, pressure, near_pressure


def force_pass(predicted: torch.Tensor, vel: torch.Tensor,
               density: torch.Tensor, near_density: torch.Tensor,
               pressure: torch.Tensor, near_pressure: torch.Tensor,
               params: SimParams, coeffs: KernelCoeffs,
               pair_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Pressure + near-pressure + viscosity acceleration; the self pair is
    skipped. Per neighbour j of i (d = |p_j - p_i| <= h):

        dir      = (p_j - p_i)/d, or +y when d == 0
        F_p     += dir · (p̄ · W'(d) / ρ_j  +  p̄_near · W'_near(d) / ρ_near_j)
        F_visc  += (v_j - v_i) · W_poly6(d)
        accel    = F_p / ρ_i + μ · F_visc
    """
    n, dim = predicted.shape
    h = params.smoothing_radius
    disp, dist = _pairwise_dist(predicted)

    eye = torch.eye(n, dtype=torch.bool, device=predicted.device)
    mask = kernels.support_mask(dist, h) & ~eye
    if pair_weight is not None:
        weight = torch.where(mask, pair_weight.to(predicted.dtype), 0.0)
    else:
        weight = mask.to(predicted.dtype)

    up = kernels.up_direction(dim, predicted.dtype, predicted.device)
    safe = torch.where(dist > 0.0, dist, 1.0)
    direction = torch.where((dist > 0.0)[..., None], disp / safe[..., None],
                            up)

    slope = kernels.dw_density(dist, h, coeffs)
    slope_near = kernels.dw_near(dist, h, coeffs)
    shared_p = (pressure[:, None] + pressure[None, :]) * 0.5
    shared_np = (near_pressure[:, None] + near_pressure[None, :]) * 0.5

    scale = weight * (shared_p * slope / density[None, :]
                      + shared_np * slope_near / near_density[None, :])
    pressure_force = (direction * scale[..., None]).sum(dim=1)

    w_visc = weight * kernels.w_viscosity(dist, h, coeffs)
    dvel = vel[None, :, :] - vel[:, None, :]
    viscosity_force = (dvel * w_visc[..., None]).sum(dim=1)

    return (pressure_force / density[:, None]
            + params.viscosity_strength * viscosity_force)
