"""Exact rescue pass for cell-capacity overflow — the counterpart of
``water_sandbox_tpu/ops/rescue.py``.

Particles beyond ``cell_capacity`` are absent from the bucket planes. Each
dropped particle (up to the budget) gets exact SPH physics from a chunked
dense sweep against all particles, and its contributions are injected back
into the resident particles: densities before the force pass (pressure is
nonlinear in density), pair forces after it. Overflow beyond the budget
stays dropped and is counted in ``unrescued``; every pair touching such a
particle is excluded from the force sweep.
"""

from __future__ import annotations

import torch

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from . import kernels

_FAR = 1.0e15


def dropped_selection(dropped: torch.Tensor, cap: int):
    """First ``cap`` dropped indices (stable order) and their validity.

    Returns (order (cap,) long, valid (cap,) bool, rescued (n,) bool,
    unrescued () int32 — dropped beyond the budget)."""
    n = dropped.shape[0]
    prio = torch.where(dropped, 0, 1).to(torch.int32)
    order = torch.sort(prio, stable=True).indices[:cap]
    valid = dropped[order]
    rescued = torch.zeros(n, dtype=torch.bool, device=dropped.device)
    rescued[order] = valid
    unrescued = (dropped.sum() - valid.sum()).to(torch.int32)
    return order, valid, rescued, unrescued


def _chunks(n: int, chunk: int):
    for s in range(0, n, chunk):
        yield slice(s, min(s + chunk, n))


def density_rescue(predicted, dropped, den, nden, params: SimParams,
                   coeffs: KernelCoeffs, cfg: SimConfig,
                   budget: int | None = None):
    """Exact densities with dropped particles included. ``den``/``nden``
    are the bucket results (dropped rows hold fill values). Returns
    (den, nden, rescued (n,) bool, unrescued () int32)."""
    n = predicted.shape[0]
    h = params.smoothing_radius
    O = min(budget or cfg.rescue_capacity, n)
    order, valid, rescued, unrescued = dropped_selection(dropped, O)
    opos = torch.where(valid[:, None], predicted[order], _FAR)

    den_o = torch.zeros(O, dtype=den.dtype, device=den.device)
    nden_o = torch.zeros_like(den_o)
    contrib_w = torch.empty_like(den)
    contrib_wn = torch.empty_like(den)
    for sl in _chunks(n, cfg.chunk):
        cpos = predicted[sl]
        d2 = ((opos[:, None, :] - cpos[None, :, :]) ** 2).sum(dim=-1)
        dist = torch.sqrt(torch.clamp_max(d2, _FAR))
        m = torch.where(dist <= h, 1.0, 0.0)
        dc = torch.minimum(dist, h)
        w = m * kernels.w_density(dc, h, coeffs)
        wn = m * kernels.w_near(dc, h, coeffs)
        den_o = den_o + w.sum(dim=1)       # o-side: every particle, self too
        nden_o = nden_o + wn.sum(dim=1)
        contrib_w[sl] = w.sum(dim=0)       # the dropped set's contributions
        contrib_wn[sl] = wn.sum(dim=0)
    den_o = den_o + DENSITY_PADDING
    nden_o = nden_o + DENSITY_PADDING

    den_full = torch.zeros_like(den)
    den_full[order] = torch.where(valid, den_o, 0.0)
    nden_full = torch.zeros_like(nden)
    nden_full[order] = torch.where(valid, nden_o, 0.0)
    # rescued rows take their exact dense sums; residents gain the dropped
    # contributions; dropped-but-unrescued rows keep their fill values
    den = torch.where(rescued, den_full,
                      torch.where(dropped, den, den + contrib_w))
    nden = torch.where(rescued, nden_full,
                       torch.where(dropped, nden, nden + contrib_wn))
    return den, nden, rescued, unrescued


def force_rescue(predicted, vel, den, nden, prs, nprs, dropped, acc,
                 params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
                 budget: int | None = None):
    """Exact accelerations: every pair involving a rescued particle is
    evaluated here, its contribution added to both sides. ``acc`` is the
    bucket force result computed with the corrected densities."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    O = min(budget or cfg.rescue_capacity, n)
    order, valid, rescued, _ = dropped_selection(dropped, O)
    # beyond-budget particles carry fill densities: exclude their pairs
    unres = dropped & ~rescued

    def take_o(a, fill):
        rows = a[order]
        sel = valid.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(sel, rows, fill)

    opos = take_o(predicted, _FAR)
    ovel = take_o(vel, 0.0)
    oden = take_o(den, 1.0)
    onden = take_o(nden, 1.0)
    oprs = take_o(prs, 0.0)
    onprs = take_o(nprs, 0.0)
    oid = torch.where(valid, order, -1)

    iota = torch.arange(n, device=predicted.device)
    iota = torch.where(unres, -3, iota)
    up = torch.zeros(dim, dtype=predicted.dtype, device=predicted.device)
    up[1] = 1.0

    pf_o = torch.zeros((O, dim), dtype=acc.dtype, device=acc.device)
    vf_o = torch.zeros_like(pf_o)
    pf_j = torch.empty_like(acc)
    vf_j = torch.empty_like(acc)
    for sl in _chunks(n, cfg.chunk):
        cpos, cvel, cid = predicted[sl], vel[sl], iota[sl]
        cden, cnden, cprs, cnprs = den[sl], nden[sl], prs[sl], nprs[sl]
        disp = cpos[None, :, :] - opos[:, None, :]          # o -> j
        d2 = (disp * disp).sum(dim=-1)
        dist = torch.sqrt(torch.clamp_max(d2, _FAR))
        m = torch.where((dist <= h) & (oid[:, None] != cid[None, :])
                        & (cid[None, :] != -3), 1.0, 0.0)
        dc = torch.minimum(dist, h)
        safe = torch.where(dist > 0.0, dist, 1.0)
        dir_oj = torch.where((dist > 0.0)[..., None],
                             disp / safe[..., None], up)
        shared_p = (oprs[:, None] + cprs[None, :]) * 0.5
        shared_np = (onprs[:, None] + cnprs[None, :]) * 0.5
        dw = kernels.dw_density(dc, h, coeffs)
        dwn = kernels.dw_near(dc, h, coeffs)
        wv = m * kernels.w_viscosity(dc, h, coeffs)

        # force ON o from j: divide by the neighbour's densities
        scale_o = m * (shared_p * dw / cden[None, :]
                       + shared_np * dwn / cnden[None, :])
        pf_o = pf_o + (dir_oj * scale_o[..., None]).sum(dim=1)
        vf_o = vf_o + ((cvel[None, :, :] - ovel[:, None, :])
                       * wv[..., None]).sum(dim=1)

        # force ON j from o: direction flips (except the +y fallback at
        # d == 0, which both sides take), divide by o's densities
        dir_jo = torch.where((dist > 0.0)[..., None], -dir_oj, up)
        scale_j = m * (shared_p * dw / oden[:, None]
                       + shared_np * dwn / onden[:, None])
        pf_j[sl] = (dir_jo * scale_j[..., None]).sum(dim=0)
        vf_j[sl] = ((ovel[:, None, :] - cvel[None, :, :])
                    * wv[..., None]).sum(dim=0)

    acc_o = (pf_o / torch.where(valid, oden, 1.0)[:, None]
             + params.viscosity_strength * vf_o)
    acc_o_full = torch.zeros_like(acc)
    acc_o_full[order] = torch.where(valid[:, None], acc_o, 0.0)
    acc_corr = pf_j / den[:, None] + params.viscosity_strength * vf_j
    return torch.where(rescued[:, None], acc_o_full,
                       torch.where(dropped[:, None], acc, acc + acc_corr))


def small_budget(cfg: SimConfig) -> int:
    """The cheap-tier budget, taken when overflow is at most this many
    particles (sweep cost is O(budget · n))."""
    return min(256, cfg.rescue_capacity)
