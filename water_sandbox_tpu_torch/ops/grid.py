"""Neighbour-search pipelines in plain PyTorch — the counterpart of
``water_sandbox_tpu/ops/grid.py`` (the JAX package's XLA path; none of it
reaches a hand-written kernel).

* ``bucket_grid``: particles are scattered once per step into a dense
  cell-bucket tensor, slot-major: ``(dim, C, num_cells)`` planes with the
  cell axis last (C = fixed per-cell capacity). The 3^dim neighbour cells
  sit at fixed offsets of the flat cell axis (the JAX package rolls it;
  here each occupied cell gathers its neighbours at those offsets), and
  each occupied cell computes a dense masked C×C pair block against each
  neighbour. Empty cells are skipped: their slots pair with nothing. The
  occupied cells are a fixed-size list (``_occupied_cells``), so the step
  reads nothing on the host and ``ops/cuda/graph.py`` captures it. The
  irregular memory operations are one stable sort, one n-row scatter, the
  neighbour gathers and one n-row gather-back per pass. The exact rescue
  of capacity-overflow rows is the kernel pipeline's: R1 and R2
  (``ops/cuda/rescue.py``), gated on the device count.
* ``hash_grid``: emulation of the reference's hashed cell table — hash
  collision aliasing and per-offset multi-count included — by sorted-run
  gathers. Slow by design; it exists for parity against the dense oracle.

Grid-boundary notes (bucket mode): the grid anchors one cell below the
minimum predicted position each step; out-of-range cells clamp to the
border. Offset wraparound at the border can only alias cells that are at
least a grid extent apart in space, so the per-pair distance filter keeps
it exact.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

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


def slots_in_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of every entry within its run of equal sorted keys (int32), by a
    running max over the run boundaries: the port's one slot-rank rule (the
    bucket builds, the hashed table's truncation, the incremental step's
    mover ranks)."""
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
    kept, the sorted keys (n,) int32 — nc for inactive rows —, the sort
    permutation (n,) int32)."""
    n, dim = predicted.shape
    key = cid if active is None else torch.where(active > 0, cid, nc)
    # stable, as jnp.argsort is: the slot of every particle hangs on it
    sorted_key, order = torch.sort(key, stable=True)
    slot = slots_in_runs(sorted_key)
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
    return (cell_pos, cell_vel, cell_mask, addr, ok.sum(), sorted_key,
            order.to(torch.int32))


def build_bucket_grid(predicted: torch.Tensor, vel: torch.Tensor,
                      params: SimParams, cfg: SimConfig,
                      time: torch.Tensor | None = None) -> BucketGrid:
    """cell ids → ``_scatter_buckets`` (stable argsort → in-cell slots, a
    running max over run boundaries → scatter into slot-major buckets).

    ``time`` feeds the container pose when cfg.grid_frame == 'container'
    (hashing.key_coords); the buckets still store world coordinates."""
    return _build(predicted, vel, params, cfg, time)[0]


def _build(predicted, vel, params: SimParams, cfg: SimConfig, time=None):
    """``build_bucket_grid`` and its stable sort: (grid, sorted cell ids
    (n,) int32, the row at each sorted position (n,) int32) — the cell
    order the rescue's kernels walk."""
    n = predicted.shape[0]
    h = params.smoothing_radius
    nc = num_cells(cfg)
    cap = cfg.cell_capacity

    kpred = hashing.key_coords(predicted, params, cfg, time)
    origin = hashing.grid_origin(kpred, h)
    _, cid = hashing.bounded_cell_ids(kpred, h, origin, cfg.grid_dims)

    cell_pos, cell_vel, cell_mask, addr, kept, sorted_cid, order = (
        _scatter_buckets(cid, None, predicted, vel, cap, nc))
    return BucketGrid(cell_pos=cell_pos, cell_vel=cell_vel,
                      cell_mask=cell_mask, addr=addr, origin=origin,
                      overflow=(n - kept).to(torch.int32)), sorted_cid, order


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


def _occupied_cells(cell_mask: torch.Tensor, size: int, lo: int = 0,
                    hi: int | None = None) -> torch.Tensor:
    """The passes' query cells: the flat ids of the cells in [lo, hi) that
    hold a particle, ascending, then the sentinel ``num_cells`` (the
    planes' cell count) up to ``size`` entries, int64. ``size`` must be at
    least the number of such cells (the rows that fill them bound it), so
    the list has a fixed shape and taking it reads nothing on the host.
    An empty cell's slots pair with nothing, so skipping it changes no
    occupied slot's sums."""
    nc = cell_mask.shape[-1]
    hi = nc if hi is None else hi
    occ = (cell_mask[:, lo:hi] > 0).any(dim=0)
    return torch.nonzero_static(occ, size=size,
                                fill_value=nc - lo).reshape(-1) + lo


def _query_cells(cells: torch.Tensor | None, cell_mask: torch.Tensor):
    """(cells, q): the query list (``_occupied_cells``; every occupied cell
    of the planes when None) and the cells each entry reads, the sentinel
    reading cell 0 (its results land in a column that is cut off). The
    neighbour at roll ``shift`` of cell ``c`` is cell ``(c - shift) %
    num_cells``, as ``torch.roll(x, shift, -1)[..., c]`` reads it."""
    nc = cell_mask.shape[-1]
    if cells is None:
        cells = _occupied_cells(cell_mask, nc)
    return cells, cells % nc


def bucket_density_pass(grid: BucketGrid, params: SimParams,
                        coeffs: KernelCoeffs, cfg: SimConfig,
                        cells: torch.Tensor | None = None):
    """Density + EOS over the slot-major bucket layout: a loop over the
    3^dim neighbour offsets of ``cfg.grid_dims``, each gathering the query
    cells' neighbours and accumulating a dense masked Cq×Cn pair block per
    query cell (one block's temporaries live at a time). ``cells`` is the
    query list (``_occupied_cells``; None: every occupied cell). Returns
    cell-layout (den, nden, prs, nprs), each (C, num_cells); cells off the
    list hold the padding alone. Self-interaction included."""
    h = params.smoothing_radius
    P, M = grid.cell_pos, grid.cell_mask            # (dim, C, nc), (C, nc)
    dim, nc = P.shape[0], M.shape[1]
    cells, q = _query_cells(cells, M)
    PM = torch.cat([P, M[None]], dim=0)             # (dim+1, C, nc)
    Pq = P[:, :, q]
    den_o = torch.zeros_like(M[:, q])
    nden_o = torch.zeros_like(den_o)
    for shift in _roll_shifts(cfg.grid_dims):
        nb = PM[:, :, (q - shift) % nc]
        # pair block: query slots on axis 0, neighbour slots on axis 1,
        # cells last
        dist2 = None
        for a in range(dim):
            d_a = nb[a][None, :, :] - Pq[a][:, None, :]  # (Cq, Cn, occ)
            d_a = d_a * d_a
            dist2 = d_a if dist2 is None else dist2.add_(d_a)
        dist = dist2.sqrt_()
        m = torch.where(kernels.support_mask(dist, h), nb[dim][None],
                        0.0)
        # clamp before the kernels: sentinel distances overflow f32 in the
        # (h-d)^3 term and turn the masked product into 0·inf = NaN
        dc = torch.clamp_max(dist, h)
        den_o = den_o + (m * kernels.w_density(dc, h, coeffs)).sum(dim=1)
        nden_o = nden_o + (m * kernels.w_near(dc, h, coeffs)).sum(dim=1)

    # an empty cell's slots see no pair: padding alone, as the full pass
    # gives them; the sentinel entries write the extra column
    den = M.new_full((M.shape[0], nc + 1), DENSITY_PADDING)
    nden = M.new_full((M.shape[0], nc + 1), DENSITY_PADDING)
    den[:, cells] = den_o + DENSITY_PADDING
    nden[:, cells] = nden_o + DENSITY_PADDING
    den, nden = den[:, :nc], nden[:, :nc]
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    return den, nden, prs, nprs


def bucket_force_pass(grid: BucketGrid, den: torch.Tensor,
                      nden: torch.Tensor, prs: torch.Tensor,
                      nprs: torch.Tensor, params: SimParams,
                      coeffs: KernelCoeffs, cfg: SimConfig,
                      cells: torch.Tensor | None = None) -> torch.Tensor:
    """Pressure + viscosity acceleration over the slot-major bucket layout,
    a loop over the neighbour offsets of the query cells (``cells``, as in
    the density pass). The self pair is excluded in the centre offset
    only. Returns cell acc (dim, C, num_cells), 0 off the list."""
    h = params.smoothing_radius
    P, V, M = grid.cell_pos, grid.cell_vel, grid.cell_mask
    dim, cap, nc = P.shape
    dtype = P.dtype

    not_self = (1.0 - torch.eye(cap, dtype=dtype, device=P.device))[:, :, None]
    feats = torch.cat(
        [P, V, M[None], den[None], nden[None], prs[None], nprs[None]], dim=0)
    cells, q = _query_cells(cells, M)
    Pq, Vq = P[:, :, q], V[:, :, q]
    prs_q, nprs_q = prs[:, q], nprs[:, q]
    pressure_force = [torch.zeros_like(M[:, q]) for _ in range(dim)]
    viscosity_force = [torch.zeros_like(M[:, q]) for _ in range(dim)]
    for shift in _roll_shifts(cfg.grid_dims):
        nb = feats[:, :, (q - shift) % nc]
        MQ = nb[2 * dim]
        dQ, ndQ = nb[2 * dim + 1], nb[2 * dim + 2]
        pQ, npQ = nb[2 * dim + 3], nb[2 * dim + 4]

        disp = []
        dist2 = None
        for a in range(dim):
            d_a = nb[a][None, :, :] - Pq[a][:, None, :]  # (Cq, Cn, occ)
            disp.append(d_a)
            dist2 = d_a * d_a if dist2 is None else dist2.add_(d_a * d_a)
        dist = dist2.sqrt_()
        m = torch.where(kernels.support_mask(dist, h), MQ[None], 0.0)
        if shift == 0:
            m = m * not_self        # skip self in the centre cell only
        dc = torch.clamp_max(dist, h)  # see density pass: avoid 0·inf = NaN

        positive = dist > 0.0
        inv_dist = torch.where(positive,
                               1.0 / torch.where(positive, dist, 1.0), 0.0)
        zero_dist = (~positive).to(dtype)
        del positive

        shared_p = (prs_q[:, None, :] + pQ[None, :, :]) * 0.5
        shared_np = (nprs_q[:, None, :] + npQ[None, :, :]) * 0.5
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
                (nb[dim + a][None, :, :] - Vq[a][:, None, :])
                * w_visc).sum(dim=1)

    # an empty cell's slots feel no pair force; the sentinel entries write
    # the extra column
    acc = P.new_zeros((dim, cap, nc + 1))
    acc[:, :, cells] = (torch.stack(pressure_force) / den[None, :, q]
                        + params.viscosity_strength
                        * torch.stack(viscosity_force))
    return acc[:, :, :nc]


def _from_cells(cell_arr: torch.Tensor, addr: torch.Tensor,
                fill) -> torch.Tensor:
    """Gather per-particle values back from cell layout. Overflow particles
    (addr == one past the end) get ``fill`` (a number or a () tensor).

    cell_arr: (C, nc) scalar plane → (n,), or (dim, C, nc) → (n, dim)."""
    if cell_arr.dim() == 2:
        if isinstance(fill, torch.Tensor):
            tail = fill.to(cell_arr.dtype).reshape(1)
        else:   # a fill kernel, not a host-to-device copy
            tail = cell_arr.new_full((1,), fill)
        return torch.cat([cell_arr.reshape(-1), tail])[addr.long()]
    return torch.stack([_from_cells(cell_arr[a], addr, fill)
                        for a in range(cell_arr.shape[0])], dim=-1)


def _to_cells(cell_arr: torch.Tensor, addr: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """A copy of the (C, nc) plane with ``values`` written at every in-range
    address of ``addr``: the one-past-the-end addresses land in an extra
    element that is cut off (no mask index, so no host read)."""
    n = cell_arr.numel()
    out = torch.cat([cell_arr.reshape(-1), cell_arr.new_zeros(1)])
    out[torch.clamp_max(addr, n).long()] = values
    return out[:n].view(cell_arr.shape)


def column_grid(dims: tuple) -> tuple:
    """The cell ids' grid as the rescue's kernels take a column grid
    (``ops/cuda/rescue.py::Walk.cols``): cell id ``x·S + y·gz + z`` is the
    column key ``x·S_pad + y·gz + z`` with ``S_pad = S``. Returns
    (S_pad, gx, gy, gz), gz 1 in 2-D."""
    gz = dims[2] if len(dims) == 3 else 1
    return (math.prod(dims[1:]), dims[0], dims[1], gz)


class Rescue(NamedTuple):
    """The rescue's selection and walk, from its density half for its force
    half."""
    sel: torch.Tensor
    slot: torch.Tensor
    count: torch.Tensor
    walk: object
    params_vec: torch.Tensor


def rescue_density(predicted, dropped, overflow, den, nden, sorted_cid,
                   order, params: SimParams, coeffs: KernelCoeffs,
                   cfg: SimConfig) -> Rescue:
    """The rescue's density half over all rows, in place on ``den``/``nden``
    (n,): the selection (``ops/rescue.py::rescue_selection``, the first
    ``rescue_capacity`` dropped rows in row order), the cell order of the
    build's sort (``sorted_cid``, ``order``; ``ops/cuda/rescue.py::
    cell_walk`` over ``cfg.grid_dims``) and R1, which leaves the bucket
    planes to the caller. Gated on the device
    count: with no overflow nothing changes. Returns the selection and
    walk for ``rescue_force``."""
    from . import rescue as rescue_mod
    from .cuda import rescue as rescue_k, sph_bucket as sb
    sel, slot, count = rescue_mod.rescue_selection(
        dropped, overflow, min(cfg.rescue_capacity, dropped.shape[0]))
    walk = rescue_k.cell_walk(sel, count, sorted_cid, order,
                              column_grid(cfg.grid_dims))
    params_vec = sb._param_vector(params, coeffs)
    rescue_k.rescue_density(predicted, sel, slot, count, None, den, nden,
                            None, params, coeffs, params_vec, cfg, walk)
    return Rescue(sel, slot, count, walk, params_vec)


def rescue_force(predicted, vel, den, nden, prs, nprs, acc, r: Rescue,
                 params: SimParams, coeffs: KernelCoeffs,
                 cfg: SimConfig) -> None:
    """The rescue's force half (R2) in place on ``acc`` (n, dim): every
    pair touching a rescued row, both sides."""
    from .cuda import rescue as rescue_k
    rescue_k.rescue_force(predicted, vel, den, nden, prs, nprs, r.sel,
                          r.slot, r.count, acc, params, coeffs, r.params_vec,
                          cfg, r.walk)


def bucket_sph(predicted: torch.Tensor, vel: torch.Tensor,
               params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
               time: torch.Tensor | None = None):
    """Full bucket-grid SPH: per-particle (den, nden, prs, nprs, acc,
    overflow).

    With ``cfg.rescue_capacity > 0`` dropped particles get exact physics
    from the rescue's kernels R1 and R2 (``rescue_density``,
    ``rescue_force``; their plain versions, the sweeps of ops/rescue.py, on
    the CPU): densities are corrected before the force pass (written back
    into the cell planes) and every dropped↔any pair force is added
    afterwards; the returned ``overflow`` then counts only particles beyond
    the rescue budget. Both run on every step and gate themselves on the
    device count, as in the kernel pipeline (``ops/cuda/sph_bucket.py::
    sph_passes``): the step reads nothing on the host. With the rescue
    off, dropped particles get rest density and zero acceleration and all
    are counted.

    The JAX function's ``constrain`` argument (a sharding hook for its
    GSPMD multi-chip path) has no torch counterpart: the sharded step is
    written out in ``parallel/gspmd.py``."""
    n = predicted.shape[0]
    nc = num_cells(cfg)
    grid, sorted_cid, order = _build(predicted, vel, params, cfg, time)
    cells = _occupied_cells(grid.cell_mask, min(n, nc))
    den_c, nden_c, prs_c, nprs_c = bucket_density_pass(grid, params, coeffs,
                                                       cfg, cells)
    addr = grid.addr
    den = _from_cells(den_c, addr, params.target_density)
    nden = _from_cells(nden_c, addr, DENSITY_PADDING)
    unrescued = grid.overflow

    rescue = cfg.rescue_capacity > 0
    if rescue:
        # the kernels read rows through raw pointers
        predicted, vel = predicted.contiguous(), vel.contiguous()
        r = rescue_density(predicted, addr == cfg.cell_capacity * nc,
                           grid.overflow, den, nden, sorted_cid, order,
                           params, coeffs, cfg)
        unrescued = grid.overflow - r.count
        # corrected densities must be visible to the force pass
        den_c = _to_cells(den_c, addr, den)
        nden_c = _to_cells(nden_c, addr, nden)
        prs_c = params.pressure_scalar * (den_c - params.target_density)
        nprs_c = params.near_pressure_scalar * nden_c

    acc_c = bucket_force_pass(grid, den_c, nden_c, prs_c, nprs_c, params,
                              coeffs, cfg, cells)
    acc = _from_cells(acc_c, addr, 0.0)
    if rescue:
        prs = params.pressure_scalar * (den - params.target_density)
        nprs = params.near_pressure_scalar * nden
        rescue_force(predicted, vel, den, nden, prs, nprs, acc, r, params,
                     coeffs, cfg)
    else:
        prs = _from_cells(prs_c, addr, 0.0)
        nprs = _from_cells(nprs_c, addr, 0.0)
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
    truncated = (slots_in_runs(sorted_keys) >= cfg.max_run).sum().to(
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
        m = kernels.support_mask(dist, h)
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
    up = kernels.up_direction(dim, predicted.dtype, predicted.device)
    iota = torch.arange(n, device=predicted.device)

    out = []
    for sl in _chunks(n, cfg.chunk):
        chunk_pred = predicted[sl]
        idx = _hash_candidates(chunk_pred, grid, params, cfg)
        disp = pred_pad[idx] - chunk_pred[:, None, :]
        dist = torch.sqrt((disp * disp).sum(dim=-1))
        m = kernels.support_mask(dist, h) & (idx != iota[sl][:, None])
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
