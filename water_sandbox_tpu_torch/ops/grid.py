"""Neighbour-search pipelines in plain PyTorch — the counterpart of
``water_sandbox_tpu/ops/grid.py`` (the JAX package's XLA path; none of it
reaches a hand-written kernel).

* ``bucket_grid``: particles are scattered once per step into a dense
  cell-bucket tensor, slot-major: ``(dim, C, num_cells)`` planes with the
  cell axis last (C = fixed per-cell capacity). The 3^dim neighbour cells
  come from ``torch.roll`` of the flat cell axis, and each cell computes a
  dense masked C×C pair block against each rolled neighbourhood. The only
  irregular memory operations are one stable sort, one n-row scatter and one
  n-row gather-back per pass.
* ``hash_grid``: emulation of the reference's hashed cell table — hash
  collision aliasing and per-offset multi-count included — by sorted-run
  gathers. Slow by design; it exists for parity against the dense oracle.

Grid-boundary notes (bucket mode): the grid anchors one cell below the
minimum predicted position each step; out-of-range cells clamp to the
border. Roll wraparound at the border can only alias cells that are at
least a grid extent apart in space, so the per-pair distance filter keeps
it exact.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from . import hashing, kernels
from .rescue import _chunks

# Padded-position sentinel: farther than any support radius but small enough
# that squared distances stay finite in float32.
_FAR = 1.0e15


@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """Cell-bucket neighbour structure for one step, slot-major.

    ``cell_pos``: (dim, C, num_cells), padding slots hold _FAR;
    ``cell_vel``: (dim, C, num_cells), padding 0;
    ``cell_mask``: (C, num_cells), 1.0 for real particles;
    ``addr``: (n,) int32 each particle's flat (slot·num_cells + cell)
    address, or C·num_cells (one past the end) for capacity-overflow
    particles;
    ``overflow``: () int32 count of dropped particles."""

    cell_pos: torch.Tensor
    cell_vel: torch.Tensor | None
    cell_mask: torch.Tensor
    addr: torch.Tensor | None
    origin: torch.Tensor | None
    overflow: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HashGrid:
    """The reference's hashed table: ``order`` the sorted permutation,
    ``sorted_keys`` its hash keys, ``starts`` the first sorted rank per hash
    (n where the hash is empty), ``overflow`` the entries beyond the
    ``max_run`` prefix of their run."""

    order: torch.Tensor
    sorted_keys: torch.Tensor
    starts: torch.Tensor
    overflow: torch.Tensor


def num_cells(cfg: SimConfig) -> int:
    return math.prod(cfg.grid_dims)


def _slots_in_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of every entry within its run of equal sorted keys (int32), by a
    running max over the run boundaries."""
    n = sorted_keys.shape[0]
    ranks = torch.arange(n, dtype=torch.int32, device=sorted_keys.device)
    first = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(first, ranks, 0), dim=0).values
    return ranks - run_start


# --------------------------------------------------------------------------
# bucket grid
# --------------------------------------------------------------------------

def _scatter_buckets(cid: torch.Tensor, active: torch.Tensor | None,
                     predicted: torch.Tensor, vel: torch.Tensor, cap: int,
                     nc: int):
    """Rows with cell ids ``cid`` (< nc) into slot-major buckets of ``cap``
    slots a cell: stable sort by cell, in-cell slot, one scatter a plane.
    Rows whose ``active`` (when given) is not positive sort last and are
    dropped like the rows beyond a cell's capacity.

    Returns (cell_pos, cell_vel (dim, cap, nc), cell_mask (cap, nc), addr
    (n,) int32 in row order — cap·nc for dropped rows —, the number of rows
    kept)."""
    n, dim = predicted.shape
    key = cid if active is None else torch.where(active > 0, cid, nc)
    # stable, as jnp.argsort is: the slot of every particle hangs on it
    sorted_key, order = torch.sort(key, stable=True)
    slot = _slots_in_runs(sorted_key)
    ok = (slot < cap) & (sorted_key < nc)
    flat = torch.where(ok, slot * nc + sorted_key, cap * nc)
    idx = flat.long()

    def scatter(values, fill):
        # every kept row has a distinct (slot, cell) address; the dropped
        # rows' address cap·nc lands in one extra element that is cut off
        out = torch.full((cap * nc + 1,), fill, dtype=predicted.dtype,
                         device=predicted.device)
        out[idx] = values
        return out[:-1].view(cap, nc)

    spred, svel = predicted[order], vel[order]
    cell_pos = torch.stack([scatter(spred[:, a], _FAR) for a in range(dim)])
    cell_vel = torch.stack([scatter(svel[:, a], 0.0) for a in range(dim)])
    cell_mask = scatter(torch.ones(n, dtype=predicted.dtype,
                                   device=predicted.device), 0.0)
    # addr in row order (invert the sort): addr[order[r]] = flat[r]
    addr = torch.empty(n, dtype=torch.int32, device=predicted.device)
    addr[order] = flat.to(torch.int32)
    return cell_pos, cell_vel, cell_mask, addr, ok.sum()


def build_bucket_grid(predicted: torch.Tensor, vel: torch.Tensor,
                      params: SimParams, cfg: SimConfig,
                      time: torch.Tensor | None = None) -> BucketGrid:
    """cell ids → ``_scatter_buckets`` (stable argsort → in-cell slots, a
    running max over run boundaries → scatter into slot-major buckets).

    ``time`` feeds the container pose when cfg.grid_frame == 'container'
    (hashing.key_coords); the buckets still store world coordinates."""
    n = predicted.shape[0]
    h = params.smoothing_radius
    nc = num_cells(cfg)
    cap = cfg.cell_capacity

    kpred = hashing.key_coords(predicted, params, cfg, time)
    origin = hashing.grid_origin(kpred, h)
    _, cid = hashing.bounded_cell_ids(kpred, h, origin, cfg.grid_dims)

    cell_pos, cell_vel, cell_mask, addr, kept = _scatter_buckets(
        cid, None, predicted, vel, cap, nc)
    return BucketGrid(cell_pos=cell_pos, cell_vel=cell_vel,
                      cell_mask=cell_mask, addr=addr, origin=origin,
                      overflow=(n - kept).to(torch.int32))


def _roll_shifts(dims: tuple) -> list[int]:
    """The 3^dim FLAT roll shifts, one per neighbour offset (x outermost).

    Cell ids are row-major (x slowest), so the cell at offset (ox, oy, oz)
    from cell c has flat id c + (ox·gy + oy)·gz + oz, and the whole
    neighbourhood shift is one rotation of the flat cell axis. Cells that
    wrap across a row boundary alias spatially distant cells, which the
    per-pair distance filter removes. The shift is negated so cell c sees
    cell c + off."""
    strides = [1] * len(dims)
    for a in range(len(dims) - 2, -1, -1):
        strides[a] = strides[a + 1] * dims[a + 1]
    return [-sum(o * s for o, s in zip(off, strides))
            for off in itertools.product((-1, 0, 1), repeat=len(dims))]


def bucket_density_pass(grid: BucketGrid, params: SimParams,
                        coeffs: KernelCoeffs, cfg: SimConfig):
    """Density + EOS over the slot-major bucket layout: a loop over the
    3^dim neighbour offsets, each rolling the cell grid and accumulating a
    dense masked Cq×Cn pair block per cell (one block's temporaries live at
    a time). Returns cell-layout (den, nden, prs, nprs), each
    (C, num_cells). Self-interaction included."""
    h = params.smoothing_radius
    P, M = grid.cell_pos, grid.cell_mask            # (dim, C, nc), (C, nc)
    dim = P.shape[0]
    PM = torch.cat([P, M[None]], dim=0)             # (dim+1, C, nc)
    den = torch.zeros_like(M)
    nden = torch.zeros_like(M)
    for shift in _roll_shifts(cfg.grid_dims):
        rolled = torch.roll(PM, shift, dims=-1)
        # pair block: query slots on axis 0, neighbour slots on axis 1,
        # cells last
        dist2 = None
        for a in range(dim):
            d_a = rolled[a][None, :, :] - P[a][:, None, :]  # (Cq, Cn, nc)
            d_a = d_a * d_a
            dist2 = d_a if dist2 is None else dist2.add_(d_a)
        dist = dist2.sqrt_()
        m = torch.where(dist <= h, rolled[dim][None], 0.0)
        # clamp before the kernels: sentinel distances overflow f32 in the
        # (h-d)^3 term and turn the masked product into 0·inf = NaN
        dc = torch.clamp_max(dist, h)
        den = den + (m * kernels.w_density(dc, h, coeffs)).sum(dim=1)
        nden = nden + (m * kernels.w_near(dc, h, coeffs)).sum(dim=1)

    den = den + DENSITY_PADDING
    nden = nden + DENSITY_PADDING
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    return den, nden, prs, nprs


def bucket_force_pass(grid: BucketGrid, den: torch.Tensor,
                      nden: torch.Tensor, prs: torch.Tensor,
                      nprs: torch.Tensor, params: SimParams,
                      coeffs: KernelCoeffs, cfg: SimConfig) -> torch.Tensor:
    """Pressure + viscosity acceleration over the slot-major bucket layout,
    a loop over the neighbour offsets. The self pair is excluded in the
    centre offset only. Returns cell acc (dim, C, num_cells)."""
    h = params.smoothing_radius
    P, V, M = grid.cell_pos, grid.cell_vel, grid.cell_mask
    dim, cap, nc = P.shape
    dtype = P.dtype

    not_self = (1.0 - torch.eye(cap, dtype=dtype, device=P.device))[:, :, None]
    feats = torch.cat(
        [P, V, M[None], den[None], nden[None], prs[None], nprs[None]], dim=0)
    pressure_force = [torch.zeros_like(M) for _ in range(dim)]
    viscosity_force = [torch.zeros_like(M) for _ in range(dim)]
    for shift in _roll_shifts(cfg.grid_dims):
        rolled = torch.roll(feats, shift, dims=-1)
        MQ = rolled[2 * dim]
        dQ, ndQ = rolled[2 * dim + 1], rolled[2 * dim + 2]
        pQ, npQ = rolled[2 * dim + 3], rolled[2 * dim + 4]

        disp = []
        dist2 = None
        for a in range(dim):
            d_a = rolled[a][None, :, :] - P[a][:, None, :]  # (Cq, Cn, nc)
            disp.append(d_a)
            dist2 = d_a * d_a if dist2 is None else dist2.add_(d_a * d_a)
        dist = dist2.sqrt_()
        m = torch.where(dist <= h, MQ[None], 0.0)
        if shift == 0:
            m = m * not_self        # skip self in the centre cell only
        dc = torch.clamp_max(dist, h)  # see density pass: avoid 0·inf = NaN

        positive = dist > 0.0
        inv_dist = torch.where(positive,
                               1.0 / torch.where(positive, dist, 1.0), 0.0)
        zero_dist = (~positive).to(dtype)
        del positive

        shared_p = (prs[:, None, :] + pQ[None, :, :]) * 0.5
        shared_np = (nprs[:, None, :] + npQ[None, :, :]) * 0.5
        # neighbour densities: padded slots hold 0 — guard the divide, the
        # mask zeroes those lanes anyway
        dQ_safe = torch.where(dQ > 0.0, dQ, 1.0)[None]
        ndQ_safe = torch.where(ndQ > 0.0, ndQ, 1.0)[None]
        scale = m * (shared_p * kernels.dw_density(dc, h, coeffs) / dQ_safe
                     + shared_np * kernels.dw_near(dc, h, coeffs) / ndQ_safe)
        del shared_p, shared_np
        w_visc = m * kernels.w_viscosity(dc, h, coeffs)
        del m, dc

        for a in range(dim):
            # direction: disp/dist, or +y when dist == 0
            dir_a = disp[a] * inv_dist
            if a == 1:
                dir_a = dir_a + zero_dist
            pressure_force[a] = pressure_force[a] + (dir_a * scale).sum(dim=1)
            viscosity_force[a] = viscosity_force[a] + (
                (rolled[dim + a][None, :, :] - V[a][:, None, :])
                * w_visc).sum(dim=1)

    return (torch.stack(pressure_force) / den[None]
            + params.viscosity_strength * torch.stack(viscosity_force))


def _from_cells(cell_arr: torch.Tensor, addr: torch.Tensor,
                fill) -> torch.Tensor:
    """Gather per-particle values back from cell layout. Overflow particles
    (addr == one past the end) get ``fill``.

    cell_arr: (C, nc) scalar plane → (n,), or (dim, C, nc) → (n, dim)."""
    if cell_arr.dim() == 2:
        tail = torch.as_tensor(fill, dtype=cell_arr.dtype,
                               device=cell_arr.device).reshape(1)
        return torch.cat([cell_arr.reshape(-1), tail])[addr.long()]
    return torch.stack([_from_cells(cell_arr[a], addr, fill)
                        for a in range(cell_arr.shape[0])], dim=-1)


def _to_cells(cell_arr: torch.Tensor, addr: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """A copy of the (C, nc) plane with ``values`` written at every in-range
    address of ``addr`` (one-past-the-end addresses are dropped)."""
    keep = addr < cell_arr.numel()
    out = cell_arr.reshape(-1).clone()
    out[addr[keep].long()] = values[keep]
    return out.view(cell_arr.shape)


def bucket_sph(predicted: torch.Tensor, vel: torch.Tensor,
               params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
               time: torch.Tensor | None = None):
    """Full bucket-grid SPH: per-particle (den, nden, prs, nprs, acc,
    overflow).

    With ``cfg.rescue_capacity > 0`` dropped particles get exact physics
    from the dense rescue sweep (ops/rescue.py): densities are corrected
    before the force pass (written back into the cell planes) and every
    dropped↔any pair force is added afterwards; the returned ``overflow``
    then counts only particles beyond the rescue budget. Whether a step
    overflowed, and which budget tier it takes, is read on the host (one
    device sync per step), as in ``ops/cuda/sph_bucket.sph_passes``. With
    the rescue off, dropped particles get rest density and zero
    acceleration and all are counted.

    The JAX function's ``constrain`` argument (a sharding hook for its
    GSPMD multi-chip path) is not ported."""
    from . import rescue as rescue_mod

    grid = build_bucket_grid(predicted, vel, params, cfg, time=time)
    den_c, nden_c, prs_c, nprs_c = bucket_density_pass(grid, params, coeffs,
                                                       cfg)
    addr = grid.addr
    den = _from_cells(den_c, addr, params.target_density)
    nden = _from_cells(nden_c, addr, DENSITY_PADDING)
    unrescued = grid.overflow

    n_over = int(grid.overflow) if cfg.rescue_capacity > 0 else 0
    if n_over > 0:
        # two-tier budget: the sweep costs O(budget · n), so the full budget
        # runs only when the small tier cannot cover the count
        small = rescue_mod.small_budget(cfg)
        budget = small if n_over <= small else cfg.rescue_capacity
        dropped = addr == cfg.cell_capacity * num_cells(cfg)
        den, nden, _, unrescued = rescue_mod.density_rescue(
            predicted, dropped, den, nden, params, coeffs, cfg, budget=budget)
        # corrected densities must be visible to the force pass
        den_c = _to_cells(den_c, addr, den)
        nden_c = _to_cells(nden_c, addr, nden)
        prs_c = params.pressure_scalar * (den_c - params.target_density)
        nprs_c = params.near_pressure_scalar * nden_c

    acc_c = bucket_force_pass(grid, den_c, nden_c, prs_c, nprs_c, params,
                              coeffs, cfg)
    acc = _from_cells(acc_c, addr, 0.0)
    if cfg.rescue_capacity > 0:
        prs = params.pressure_scalar * (den - params.target_density)
        nprs = params.near_pressure_scalar * nden
    else:
        prs = _from_cells(prs_c, addr, 0.0)
        nprs = _from_cells(nprs_c, addr, 0.0)
    if n_over > 0:
        acc = rescue_mod.force_rescue(predicted, vel, den, nden, prs, nprs,
                                      dropped, acc, params, coeffs, cfg,
                                      budget=budget)
    return den, nden, prs, nprs, acc, unrescued


# --------------------------------------------------------------------------
# hash grid (reference-parity mode)
# --------------------------------------------------------------------------

def build_hash_grid(predicted: torch.Tensor, params: SimParams,
                    cfg: SimConfig) -> HashGrid:
    """Hash the particles, sort by hash (stable), and take the first sorted
    rank of every hash (a scatter-min over a table filled with n).

    ``overflow`` counts sorted entries beyond the ``cfg.max_run`` prefix of
    their same-hash run: the reference walks runs without a bound while
    ``_hash_candidates`` walks at most max_run entries, so such an entry is
    invisible as a candidate and the emulation is exact only when this
    count is 0."""
    n = predicted.shape[0]
    table = cfg.table_size
    cell = hashing.get_cell(predicted, params.smoothing_radius)
    keys = hashing.reference_hash(cell, table)
    sorted_keys, order = torch.sort(keys, stable=True)
    ranks = torch.arange(n, dtype=torch.int32, device=predicted.device)
    starts = torch.full((table,), n, dtype=torch.int32,
                        device=predicted.device)
    starts.scatter_reduce_(0, sorted_keys.long(), ranks, "amin",
                           include_self=True)
    truncated = (_slots_in_runs(sorted_keys) >= cfg.max_run).sum().to(
        torch.int32)
    return HashGrid(order=order.to(torch.int32), sorted_keys=sorted_keys,
                    starts=starts, overflow=truncated)


def _hash_candidates(chunk_pred: torch.Tensor, grid: HashGrid,
                     params: SimParams, cfg: SimConfig) -> torch.Tensor:
    """Reference-walk emulation: for each of the 3^dim offsets, up to
    ``max_run`` sorted ranks from starts[hash] while the key matches.
    Duplicates across colliding offsets are kept (the reference's
    multi-count). The sentinel n marks an invalid candidate. Returns
    (c, 3^dim · max_run) long."""
    n = grid.order.shape[0]
    table = cfg.table_size
    dev = chunk_pred.device
    cell = hashing.get_cell(chunk_pred, params.smoothing_radius)
    offs = hashing.neighbor_offsets(chunk_pred.shape[-1], dev)
    nkeys = hashing.reference_hash(cell[:, None, :] + offs[None, :, :], table)
    start = grid.starts[nkeys.long()]                       # (c, m)
    r = start[:, :, None] + torch.arange(cfg.max_run, dtype=torch.int32,
                                         device=dev)
    in_range = r < n
    r_safe = torch.where(in_range, r, 0).long()
    match = in_range & (grid.sorted_keys[r_safe] == nkeys[:, :, None])
    idx = torch.where(match, grid.order[r_safe], n)
    return idx.reshape(chunk_pred.shape[0], -1).long()


def _pad_rows(arr: torch.Tensor, pad_value) -> torch.Tensor:
    pad = torch.full((1,) + tuple(arr.shape[1:]), pad_value, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], dim=0)


def hash_density_pass(predicted: torch.Tensor, grid: HashGrid,
                      params: SimParams, coeffs: KernelCoeffs,
                      cfg: SimConfig):
    """Grid-accelerated density + EOS with reference hash semantics, in
    chunks of ``cfg.chunk`` query rows."""
    h = params.smoothing_radius
    pred_pad = _pad_rows(predicted, _FAR)
    den, nden = [], []
    for sl in _chunks(predicted.shape[0], cfg.chunk):
        chunk_pred = predicted[sl]
        idx = _hash_candidates(chunk_pred, grid, params, cfg)
        disp = pred_pad[idx] - chunk_pred[:, None, :]
        dist = torch.sqrt((disp * disp).sum(dim=-1))
        m = dist <= h
        dc = torch.clamp_max(dist, h)  # sentinel distances overflow the kernels
        den.append(torch.where(m, kernels.w_density(dc, h, coeffs),
                               0.0).sum(dim=1))
        nden.append(torch.where(m, kernels.w_near(dc, h, coeffs),
                                0.0).sum(dim=1))
    density = torch.cat(den) + DENSITY_PADDING
    near_density = torch.cat(nden) + DENSITY_PADDING
    pressure = params.pressure_scalar * (density - params.target_density)
    near_pressure = params.near_pressure_scalar * near_density
    return density, near_density, pressure, near_pressure


def hash_force_pass(predicted: torch.Tensor, vel: torch.Tensor,
                    density: torch.Tensor, near_density: torch.Tensor,
                    pressure: torch.Tensor, near_pressure: torch.Tensor,
                    grid: HashGrid, params: SimParams, coeffs: KernelCoeffs,
                    cfg: SimConfig) -> torch.Tensor:
    """Grid-accelerated forces with reference hash semantics; the self pair
    is excluded by index."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    pred_pad = _pad_rows(predicted, _FAR)
    vel_pad = _pad_rows(vel, 0.0)
    den_pad = _pad_rows(density, 1.0)
    nden_pad = _pad_rows(near_density, 1.0)
    prs_pad = _pad_rows(pressure, 0.0)
    nprs_pad = _pad_rows(near_pressure, 0.0)
    up = torch.zeros(dim, dtype=predicted.dtype, device=predicted.device)
    up[1] = 1.0
    iota = torch.arange(n, device=predicted.device)

    out = []
    for sl in _chunks(n, cfg.chunk):
        chunk_pred = predicted[sl]
        idx = _hash_candidates(chunk_pred, grid, params, cfg)
        disp = pred_pad[idx] - chunk_pred[:, None, :]
        dist = torch.sqrt((disp * disp).sum(dim=-1))
        m = (dist <= h) & (idx != iota[sl][:, None])
        mf = m.to(predicted.dtype)
        dc = torch.clamp_max(dist, h)  # sentinel distances overflow the kernels

        safe = torch.where(dist > 0.0, dist, 1.0)
        direction = torch.where((dist > 0.0)[..., None],
                                disp / safe[..., None], up)
        shared_p = (pressure[sl][:, None] + prs_pad[idx]) * 0.5
        shared_np = (near_pressure[sl][:, None] + nprs_pad[idx]) * 0.5
        scale = mf * (shared_p * kernels.dw_density(dc, h, coeffs)
                      / den_pad[idx]
                      + shared_np * kernels.dw_near(dc, h, coeffs)
                      / nden_pad[idx])
        pressure_force = (direction * scale[..., None]).sum(dim=1)

        w_visc = mf * kernels.w_viscosity(dc, h, coeffs)
        viscosity_force = ((vel_pad[idx] - vel[sl][:, None, :])
                           * w_visc[..., None]).sum(dim=1)
        out.append(pressure_force / density[sl][:, None]
                   + params.viscosity_strength * viscosity_force)
    return torch.cat(out)


def hash_sph(predicted: torch.Tensor, vel: torch.Tensor, params: SimParams,
             coeffs: KernelCoeffs, cfg: SimConfig):
    """Full reference-semantics SPH via the hashed table: per-particle
    (den, nden, prs, nprs, acc, overflow)."""
    grid = build_hash_grid(predicted, params, cfg)
    den, nden, prs, nprs = hash_density_pass(predicted, grid, params, coeffs,
                                             cfg)
    acc = hash_force_pass(predicted, vel, den, nden, prs, nprs, grid, params,
                          coeffs, cfg)
    return den, nden, prs, nprs, acc, grid.overflow
