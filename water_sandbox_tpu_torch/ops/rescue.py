"""Exact rescue pass for cell-capacity overflow — the counterpart of
``water_sandbox_tpu/ops/rescue.py``.

Particles beyond ``cell_capacity`` are absent from the bucket planes. Each
dropped particle (up to the budget) gets exact SPH physics from a chunked
dense sweep against all particles, and its contributions are injected back
into the resident particles: densities before the force pass (pressure is
nonlinear in density), pair forces after it. Overflow beyond the budget
stays dropped and is counted in ``unrescued``; every pair touching such a
particle is excluded from the force sweep.

One sweep computes it: ``rescue_selection`` picks the rescued rows with
the count on the device, and ``density_rescue_count`` and
``force_rescue_count`` run the two halves gated on that count. The step
runs it (on the card through the kernels of ``ops/cuda/rescue.py``, whose
plain versions these are). ``density_rescue`` and ``force_rescue`` keep the
JAX package's signatures, with a budget picked on the host, and run the
same sweep.
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


# ------------------------------------------------- the device-count form --
#
# The same rescue with nothing read on the host: the dropped rows' ranks by
# one cumsum, a fixed (cap,) list of the first min(n_over, cap) dropped rows
# in row order, and the rescued count as a 0-d device tensor that gates both
# halves. This is what the CUDA kernels (csrc/sph_rescue.cu) compute, and
# their plain version (ops/cuda/rescue.py).
#
# One budget, not the JAX package's two tiers. With n_over <= small_budget
# (256) every dropped row is rescued under either tier; above it, both
# rescue the first rescue_capacity dropped rows in row order (the stable
# sort of dropped_selection). So the rescued set is the same for every
# n_over: the tier only ever chose the sweep's cost, which here is the
# count's, not the budget's.

def rescue_selection(dropped: torch.Tensor, overflow: torch.Tensor,
                     cap: int):
    """The rescue's selection from ``dropped`` (n,) bool and ``overflow``
    () int32 (``dropped.sum()``), with no host read and no mask index.

    Returns (sel (cap,) int32 — row of the k-th dropped row for k < count,
    0 past it —, slot (n,) int32 — a dropped row's rank among the dropped
    rows in row order, -1 for a resident —, count () int32 —
    min(overflow, cap), the rescued rows)."""
    n = dropped.shape[0]
    dev = dropped.device
    rank = torch.cumsum(dropped, 0, dtype=torch.int32) - 1
    slot = torch.where(dropped, rank, -1)
    # rows past the budget and residents land in the spill slot ``cap``
    dest = torch.where(dropped & (rank < cap), rank, cap).long()
    buf = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    buf.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    count = torch.clamp_max(overflow, cap).to(torch.int32)
    return buf[:cap], slot, count


def _rescued_rows(sel, slot, count):
    """(valid (cap,) bool: slot k holds a rescued row, rescued (n,) bool,
    dropped (n,) bool, at (n,) long: a row's slot, clamped into the list)."""
    cap = sel.shape[0]
    valid = torch.arange(cap, device=sel.device) < count
    dropped = slot >= 0
    rescued = dropped & (slot < count)
    at = torch.clamp(slot, 0, cap - 1).long()
    return valid, rescued, dropped, at


def density_rescue_count(predicted, sel, slot, count, den, nden,
                         params: SimParams, coeffs: KernelCoeffs,
                         cfg: SimConfig):
    """``density_rescue`` driven by the device count (``rescue_selection``):
    rescued rows take their exact sums over every particle (self included)
    plus DENSITY_PADDING, residents gain the rescued rows' contributions,
    dropped-but-unrescued rows keep their fill values. With count 0 the
    result is ``den``/``nden`` bit for bit. Returns (den, nden)."""
    h = params.smoothing_radius
    valid, rescued, dropped, at = _rescued_rows(sel, slot, count)
    opos = torch.where(valid[:, None], predicted[sel.long()], _FAR)

    den_o = torch.zeros(sel.shape[0], dtype=den.dtype, device=den.device)
    nden_o = torch.zeros_like(den_o)
    contrib_w = torch.empty_like(den)
    contrib_wn = torch.empty_like(den)
    for sl in _chunks(predicted.shape[0], cfg.chunk):
        d2 = ((opos[:, None, :] - predicted[sl][None, :, :]) ** 2).sum(dim=-1)
        dist = torch.sqrt(torch.clamp_max(d2, _FAR))
        m = torch.where(dist <= h, 1.0, 0.0)
        dc = torch.minimum(dist, h)
        w = m * kernels.w_density(dc, h, coeffs)
        wn = m * kernels.w_near(dc, h, coeffs)
        den_o = den_o + w.sum(dim=1)
        nden_o = nden_o + wn.sum(dim=1)
        contrib_w[sl] = w.sum(dim=0)
        contrib_wn[sl] = wn.sum(dim=0)
    den_o = den_o + DENSITY_PADDING
    nden_o = nden_o + DENSITY_PADDING

    gate = count > 0
    den_new = torch.where(rescued, den_o[at],
                          torch.where(dropped, den, den + contrib_w))
    nden_new = torch.where(rescued, nden_o[at],
                           torch.where(dropped, nden, nden + contrib_wn))
    return (torch.where(gate, den_new, den),
            torch.where(gate, nden_new, nden))


def force_rescue_count(predicted, vel, den, nden, prs, nprs, sel, slot,
                       count, acc, params: SimParams, coeffs: KernelCoeffs,
                       cfg: SimConfig):
    """``force_rescue`` driven by the device count: every pair touching a
    rescued row, both sides, the self pair and every pair of a
    beyond-budget row excluded, +y at d == 0 on both sides. With count 0
    the result is ``acc`` bit for bit."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    valid, rescued, dropped, at = _rescued_rows(sel, slot, count)
    order = sel.long()

    def take_o(a, fill):
        sel_ = valid.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(sel_, a[order], fill)

    opos = take_o(predicted, _FAR)
    ovel = take_o(vel, 0.0)
    oden = take_o(den, 1.0)
    onden = take_o(nden, 1.0)
    oprs = take_o(prs, 0.0)
    onprs = take_o(nprs, 0.0)
    oid = torch.where(valid, order, -1)
    iota = torch.arange(n, device=predicted.device)
    iota = torch.where(dropped & ~rescued, -3, iota)
    up = kernels.up_direction(dim, predicted.dtype, predicted.device)

    pf_o = torch.zeros((sel.shape[0], dim), dtype=acc.dtype,
                       device=acc.device)
    vf_o = torch.zeros_like(pf_o)
    pf_j = torch.empty_like(acc)
    vf_j = torch.empty_like(acc)
    for sl in _chunks(n, cfg.chunk):
        cpos, cvel, cid = predicted[sl], vel[sl], iota[sl]
        disp = cpos[None, :, :] - opos[:, None, :]          # o -> j
        dist = torch.sqrt(torch.clamp_max((disp * disp).sum(dim=-1), _FAR))
        m = torch.where((dist <= h) & (oid[:, None] != cid[None, :])
                        & (cid[None, :] != -3), 1.0, 0.0)
        dc = torch.minimum(dist, h)
        safe = torch.where(dist > 0.0, dist, 1.0)
        dir_oj = torch.where((dist > 0.0)[..., None],
                             disp / safe[..., None], up)
        shared_p = (oprs[:, None] + prs[sl][None, :]) * 0.5
        shared_np = (onprs[:, None] + nprs[sl][None, :]) * 0.5
        dw = kernels.dw_density(dc, h, coeffs)
        dwn = kernels.dw_near(dc, h, coeffs)
        wv = m * kernels.w_viscosity(dc, h, coeffs)
        scale_o = m * (shared_p * dw / den[sl][None, :]
                       + shared_np * dwn / nden[sl][None, :])
        pf_o = pf_o + (dir_oj * scale_o[..., None]).sum(dim=1)
        vf_o = vf_o + ((cvel[None, :, :] - ovel[:, None, :])
                       * wv[..., None]).sum(dim=1)
        dir_jo = torch.where((dist > 0.0)[..., None], -dir_oj, up)
        scale_j = m * (shared_p * dw / oden[:, None]
                       + shared_np * dwn / onden[:, None])
        pf_j[sl] = (dir_jo * scale_j[..., None]).sum(dim=0)
        vf_j[sl] = ((ovel[:, None, :] - cvel[None, :, :])
                    * wv[..., None]).sum(dim=0)

    acc_o = (pf_o / torch.where(valid, oden, 1.0)[:, None]
             + params.viscosity_strength * vf_o)
    acc_corr = pf_j / den[:, None] + params.viscosity_strength * vf_j
    acc_new = torch.where(rescued[:, None], acc_o[at],
                          torch.where(dropped[:, None], acc, acc + acc_corr))
    return torch.where(count > 0, acc_new, acc)


# ------------------------------------------------ the host-budget form --
#
# The JAX package's signatures, for callers that pick a budget on the host
# (the tests held against JAX): the same sweep as above over the first
# ``budget`` dropped rows, and so the same bits. No step calls them: every
# step's rescue is the device-count form.

def density_rescue(predicted, dropped, den, nden, params: SimParams,
                   coeffs: KernelCoeffs, cfg: SimConfig,
                   budget: int | None = None):
    """Exact densities with dropped particles included. ``den``/``nden``
    are the bucket results (dropped rows hold fill values). Returns
    (den, nden, rescued (n,) bool, unrescued () int32)."""
    cap = min(budget or cfg.rescue_capacity, predicted.shape[0])
    overflow = dropped.sum().to(torch.int32)
    sel, slot, count = rescue_selection(dropped, overflow, cap)
    den, nden = density_rescue_count(predicted, sel, slot, count, den, nden,
                                     params, coeffs, cfg)
    rescued = (slot >= 0) & (slot < count)
    return den, nden, rescued, (overflow - count).to(torch.int32)


def force_rescue(predicted, vel, den, nden, prs, nprs, dropped, acc,
                 params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
                 budget: int | None = None):
    """Exact accelerations: every pair involving a rescued particle is
    evaluated here, its contribution added to both sides. ``acc`` is the
    bucket force result computed with the corrected densities."""
    cap = min(budget or cfg.rescue_capacity, predicted.shape[0])
    sel, slot, count = rescue_selection(
        dropped, dropped.sum().to(torch.int32), cap)
    return force_rescue_count(predicted, vel, den, nden, prs, nprs, sel,
                              slot, count, acc, params, coeffs, cfg)


def small_budget(cfg: SimConfig) -> int:
    """The cheap-tier budget, taken when overflow is at most this many
    particles (sweep cost is O(budget · n))."""
    return min(256, cfg.rescue_capacity)
