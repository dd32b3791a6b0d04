"""Explicit spatial domain decomposition — the counterpart of
``water_sandbox_tpu/parallel/domain.py``: its fused-kernel path
(``_sph_local_pallas``, the default) and its plain per-shard passes
(``_sph_local``, ``use_pallas=False``, over ``ops/grid.py``).

Scheme (1-D mesh of shards over the container's x axis, ``parallel/mesh.py``):

* Every shard owns a fixed-capacity slice of the particle slots (P slots a
  shard, inactive ones masked). Ownership is by cell-x slab: shard d owns
  cells [d·gx_loc, (d+1)·gx_loc) of a grid anchored to the container.
* Per step each shard buckets its local particles into its slab range
  (``build_local_slab_buckets``), then the boundary slabs of the position
  and velocity planes go to the neighbours' pad lanes, where the kernels'
  neighbour walk reads them as candidates. Density is computed for the
  local rows, its boundary slabs are exchanged the same way, and the force
  kernel evaluates every pair from the query side — so each pair is
  computed by its owner with exact neighbour data.
* Capacity overflow gets the exact rescue, across shard boundaries.
* Migration: after integration, particles whose cell-x left the local slab
  move to the neighbour's free slots (at most ``mig_cap`` each way a step;
  the rest stay and move next step; arrivals with no free slot are counted
  in ``lost``).

A sharded state is a list of per-shard ``FluidState``s (P rows each, the
scalars replicated) and a list of per-shard ``active`` masks (P,) f32.
Shards run one phase after another in one process; the collectives are the
mesh's. The JAX package's ``lax.scan`` over rescue chunks is a Python loop,
and its ``lax.cond`` on ``pmax(overflow) > 0`` one host read per step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from ..core.state import FluidState
from ..ops import grid as grid_mod, integrate as integrate_mod, kernels
from ..ops.cuda import sph_bucket as sb
from ..ops.rescue import _chunks
from .mesh import Mesh

_FAR = sb._FAR


def _grid_origin_static(params: SimParams, cfg: SimConfig) -> torch.Tensor:
    """Grid anchor shared by all shards: 2h below the container's minimum
    corner."""
    h = params.smoothing_radius
    c = params.container
    return c.center - c.half_size - 2.0 * h


def _per_shard(params: SimParams, mesh: Mesh) -> list[SimParams]:
    by_dev = {dev: params.to(dev) for dev in set(mesh.devices)}
    return [by_dev[dev] for dev in mesh.devices]


def shard_state(state: FluidState, mesh: Mesh, cfg: SimConfig,
                params: SimParams, slack: float = 2.0):
    """Re-pack a dense state into fixed-capacity per-shard slots, each
    particle on the shard of its cell-x slab (host-side, init time only).

    Returns (list of per-shard FluidState with P = ceil(n/ndev)·slack rows,
    list of active masks (P,) f32)."""
    ndev = mesh.size
    n = state.n
    gx = cfg.grid_dims[0]
    if gx % ndev:
        raise ValueError(f"grid_dims[0]={gx} not divisible by {ndev}")
    gx_loc = gx // ndev
    P_cap = int(-(-n // ndev) * slack)

    host = state.to("cpu")
    hparams = params.to("cpu")
    origin = _grid_origin_static(hparams, cfg)
    cell = torch.floor((host.predicted - origin) / hparams.smoothing_radius)
    owner = np.clip(cell[:, 0].to(torch.int32).numpy() // gx_loc, 0,
                    ndev - 1)
    idx_by_dev = [torch.from_numpy(np.where(owner == d)[0])
                  for d in range(ndev)]
    for d, idx in enumerate(idx_by_dev):
        if len(idx) > P_cap:
            raise ValueError(
                f"shard {d} gets {len(idx)} particles > capacity {P_cap}; "
                "raise slack")

    fills = dict(pos=_FAR, predicted=_FAR, ids=-1)
    states, active = [], []
    for d, (idx, dev) in enumerate(zip(idx_by_dev, mesh.devices)):
        fields = {}
        for f in dataclasses.fields(FluidState):
            arr = getattr(host, f.name)
            if arr.dim() == 0:                  # replicated scalars
                fields[f.name] = arr.to(dev)
                continue
            out = torch.full((P_cap,) + tuple(arr.shape[1:]),
                             fills.get(f.name, 0), dtype=arr.dtype)
            out[:len(idx)] = arr[idx]
            fields[f.name] = out.to(dev)
        states.append(FluidState(**fields))
        act = torch.zeros(P_cap)
        act[:len(idx)] = 1.0
        active.append(act.to(dev))
    return states, active


def _exchange_halo_slabs(planes: list[torch.Tensor], gx_loc: int, S_pad: int,
                         PAD: int, mesh: Mesh) -> list[torch.Tensor]:
    """In place: shard d's S_pad lanes just below PAD take shard d-1's last
    local slab, the S_pad lanes just past its local range take shard d+1's
    first. Edge shards keep their own pad content (the build's fill: _FAR in
    position planes) — zeros would turn empty slots into phantom particles
    at the world origin."""
    lo = PAD + (gx_loc - 1) * S_pad
    hi = PAD + gx_loc * S_pad
    from_left = mesh.shift_right([p[:, :, lo:lo + S_pad] for p in planes])
    from_right = mesh.shift_left([p[:, :, PAD:PAD + S_pad] for p in planes])
    for d, p in enumerate(planes):
        if d > 0:
            p[:, :, PAD - S_pad:PAD] = from_left[d]
        if d < mesh.size - 1:
            p[:, :, hi:hi + S_pad] = from_right[d]
    return planes


def _local_cfg(cfg: SimConfig, gx_loc: int) -> SimConfig:
    return dataclasses.replace(cfg, grid_dims=(gx_loc,) + cfg.grid_dims[1:])


def halo_planes(pred, vel, active, params, cfg: SimConfig, gx_loc: int,
                mesh: Mesh):
    """Each shard's local build, then the exchange of the position and
    velocity boundary slabs, then the occupied-slot counts re-derived from
    the EXCHANGED position plane (so the walk sees the halo candidates).

    Returns lists (feats, counts, addr, overflow); ``addr`` addresses the
    local rows only, the halo lanes are read as candidates."""
    cfg_loc = _local_cfg(cfg, gx_loc)
    planes, addr, overflow = [], [], []
    for d in range(mesh.size):
        origin = _grid_origin_static(params[d], cfg)
        p, _, a, o = sb.build_local_slab_buckets(
            pred[d], vel[d], active[d], origin, gx_loc, d, params[d],
            cfg_loc)
        planes.append(p)
        addr.append(a)
        overflow.append(o)
    g = sb._geometry(cfg_loc)
    feats = _exchange_halo_slabs(planes, gx_loc, g.S_pad, g.PAD, mesh)
    counts = [(f[0] < _FAR * 0.5).sum(dim=0, dtype=f.dtype)[None, :]
              for f in feats]
    return feats, counts, addr, overflow


def _sph_local_pallas(pred, vel, active, params, coeffs, cfg: SimConfig,
                      gx_loc: int, mesh: Mesh, rescue_cap: int = 256):
    """Density + force for every shard's local rows with halo-exact
    neighbour data, through the density and force kernels.

    With cfg.rescue_capacity > 0, capacity-overflow particles get the exact
    rescue, up to ``rescue_cap`` a shard a step, with dropped rows sent to
    both neighbours so cross-shard pairs are exact too. Whether any shard
    overflowed is read on the host (one sync per step).

    All arguments but cfg, gx_loc, mesh and rescue_cap are per-shard lists.
    Returns lists (den, nden, prs, nprs, acc, overflow)."""
    nsh = mesh.size
    dim = cfg.dim
    cfg_loc = _local_cfg(cfg, gx_loc)
    g = sb._geometry(cfg_loc)
    sentinel = sb._cap_pad(cfg.cell_capacity) * g.L
    Pn = pred[0].shape[0]

    feats, counts, addr, overflow = halo_planes(pred, vel, active, params,
                                                cfg, gx_loc, mesh)
    pv = [sb._param_vector(p, c) for p, c in zip(params, coeffs)]
    dens = [sb.run_density(feats[d], counts[d], addr[d], pv[d], cfg_loc)
            for d in range(nsh)]

    dropped = [(addr[d] == sentinel) & (active[d] > 0) for d in range(nsh)]
    R = min(rescue_cap, cfg.rescue_capacity or 1, Pn)
    rescue = (cfg.rescue_capacity > 0
              and int(mesh.pmax(overflow)[0]) > 0)
    unres = overflow

    def halo(planes):
        return [_halo_pseudo(p, gx_loc, g.S_pad, g.PAD) for p in planes]

    if rescue:
        halo_pos = [hp.T for hp in halo([f[:dim] for f in feats])]
        den_p, nden_p = [], []
        for d in range(nsh):
            invalid = addr[d] == sentinel            # dropped or inactive
            safe = torch.clamp_max(addr[d], sentinel - 1).long()
            dflat = dens[d][:2].reshape(2, -1)
            den_p.append(torch.where(invalid, params[d].target_density,
                                     dflat[0, safe]))
            nden_p.append(torch.where(invalid, DENSITY_PADDING,
                                      dflat[1, safe]))
        den_p, nden_p, odata, rescued, unres = _rescue_density_common(
            pred, vel, active, dropped, den_p, nden_p, halo_pos, params,
            coeffs, R, mesh, cfg.chunk)
        # corrected resident rows, with consistent derived planes, before
        # the exchange so the neighbours' force passes see them too
        for d in range(nsh):
            keep = addr[d] != sentinel
            dens[d].view(6, -1)[:, addr[d][keep].long()] = (
                sb.derived_density_planes(den_p[d], nden_p[d],
                                          params[d])[:, keep])

    # halo densities are the neighbours' exact local results
    dens = _exchange_halo_slabs(dens, gx_loc, g.S_pad, g.PAD, mesh)
    # the query-side force kernel (the JAX step pins the "qrow3" gate): a
    # pair-once kernel would write the mirrored halves of boundary pairs
    # into halo lanes that no shard reads back
    out = [sb.run_force(feats[d], dens[d], counts[d], addr[d], pv[d],
                        cfg_loc) for d in range(nsh)]
    res = [sb.gather_results(out[d], addr[d], addr[d] == sentinel, params[d])
           for d in range(nsh)]
    den, nden, acc = (list(x) for x in zip(*res))

    if rescue:
        den = [torch.where(r, a, b) for r, a, b in zip(rescued, den_p, den)]
        nden = [torch.where(r, a, b)
                for r, a, b in zip(rescued, nden_p, nden)]
        hvel = [hv.T for hv in halo([f[dim:2 * dim] for f in feats])]
        hdens = halo([x[:2] for x in dens])
        halo_rows = []
        for d in range(nsh):
            # empty halo slots hold no density (the kernel leaves them
            # unwritten): a finite fill keeps the sweep's masked terms 0
            occ = halo_pos[d][:, 0] < _FAR * 0.5
            halo_rows.append({
                "pos": halo_pos[d], "vel": hvel[d],
                "den": torch.where(occ, hdens[d][0], 1.0),
                "nden": torch.where(occ, hdens[d][1], 1.0)})
        acc = _rescue_force_common(acc, pred, vel, active, dropped, den,
                                   nden, odata, rescued, halo_rows, params,
                                   coeffs, mesh, cfg.chunk)

    prs = [p.pressure_scalar * (x - p.target_density)
           for p, x in zip(params, den)]
    nprs = [p.near_pressure_scalar * x for p, x in zip(params, nden)]
    return den, nden, prs, nprs, acc, unres


def _local_buckets(pred, vel, active, origin, params, cfg: SimConfig,
                   gx_loc: int, my_dev: int):
    """Bucket a shard's local particles into its slab range of the dense
    cell layout of ``ops/grid.py`` (gx_loc·S cells, S = cells a slab).
    Particles outside the local slab (stragglers between migrations) clamp
    into the boundary slab with their positions untouched, so every pair
    the walk visits uses exact geometry; inactive slots sort last and are
    dropped.

    Returns (cell_pos, cell_vel (dim, C, nc_loc), cell_mask (C, nc_loc),
    addr (n,) i32 — C·nc_loc for inactive and capacity-overflow rows —,
    overflow () i32, S)."""
    h = params.smoothing_radius
    dims = cfg.grid_dims
    S = 1
    for d in dims[1:]:
        S *= d
    nc_loc = gx_loc * S
    dev = pred.device

    cell = torch.floor((pred - origin) / h).to(torch.int32)
    hi = torch.tensor(dims, dtype=torch.int32, device=dev) - 1
    cell = torch.minimum(torch.clamp_min(cell, 0), hi)
    cx_local = torch.clamp(cell[:, 0] - my_dev * gx_loc, 0, gx_loc - 1)
    rest = cell[:, 1]
    for a in range(2, len(dims)):
        rest = rest * dims[a] + cell[:, a]
    cid = cx_local * S + rest
    cell_pos, cell_vel, cell_mask, addr, kept = grid_mod._scatter_buckets(
        cid, active, pred, vel, cfg.cell_capacity, nc_loc)
    overflow = (active.sum() - kept).to(torch.int32)
    return cell_pos, cell_vel, cell_mask, addr, overflow, S


def _pad_slabs(planes: list[torch.Tensor], S: int,
               fill: list[float]) -> list[torch.Tensor]:
    """Each shard's (F, C, gx_loc·S) planes with one slab of ``fill`` (a
    value per feature: the plane's empty-slot fill, _FAR for positions) in
    front and behind, (F, C, (gx_loc+2)·S): the halo lanes that
    ``_exchange_halo_slabs`` (S_pad = PAD = S) fills from the neighbours.
    The outer slabs of the edge shards keep the fill, so the rescue's halo
    sweep finds no phantom particle at the world origin there."""
    out = []
    for p in planes:
        slab = torch.tensor(fill, dtype=p.dtype, device=p.device)[
            :, None, None].expand(p.shape[0], p.shape[1], S)
        out.append(torch.cat([slab, p, slab], dim=-1))
    return out


def _sph_local(pred, vel, active, params, coeffs, cfg: SimConfig,
               gx_loc: int, mesh: Mesh, rescue_cap: int = 256):
    """Density + force for every shard's local rows with halo-exact
    neighbour data, through the plain pair-block passes of ``ops/grid.py``
    (the JAX package's ``_sph_local``). Only the middle slabs' densities
    are right after the first pass (the halo slabs lack their own outer
    neighbours), so the computed density planes are exchanged again before
    the force pass. The rescue is ``_sph_local_pallas``'s.

    All arguments but cfg, gx_loc, mesh and rescue_cap are per-shard lists.
    Returns lists (den, nden, prs, nprs, acc, overflow)."""
    nsh = mesh.size
    dim = cfg.dim
    cap = cfg.cell_capacity
    Pn = pred[0].shape[0]
    ext_cfg = _local_cfg(cfg, gx_loc + 2)

    cell_vel, addr, overflow, pm = [], [], [], []
    for d in range(nsh):
        cp, cv, cm, a, o, S = _local_buckets(
            pred[d], vel[d], active[d], _grid_origin_static(params[d], cfg),
            params[d], cfg, gx_loc, d)
        pm.append(torch.cat([cp, cm[None]], dim=0))
        cell_vel.append(cv)
        addr.append(a)
        overflow.append(o)
    nc_loc = gx_loc * S
    local = slice(S, S + nc_loc)

    def with_halo(planes, fill):
        return _exchange_halo_slabs(_pad_slabs(planes, S, fill), gx_loc, S,
                                    S, mesh)

    pm_ext = with_halo(pm, [_FAR] * dim + [0.0])
    den_c, nden_c = [], []
    for d in range(nsh):
        grid_ext = grid_mod.BucketGrid(
            cell_pos=pm_ext[d][:dim], cell_vel=None, cell_mask=pm_ext[d][dim],
            addr=None, origin=None, overflow=overflow[d])
        den_e, nden_e, _, _ = grid_mod.bucket_density_pass(
            grid_ext, params[d], coeffs[d], ext_cfg)
        den_c.append(den_e[:, local])
        nden_c.append(nden_e[:, local])

    dropped = [(addr[d] == cap * nc_loc) & (active[d] > 0)
               for d in range(nsh)]
    R = min(rescue_cap, cfg.rescue_capacity or 1, Pn)
    rescue = (cfg.rescue_capacity > 0
              and int(mesh.pmax(overflow)[0]) > 0)
    unres = overflow

    def halo(planes):
        return [torch.cat([p[..., :S], p[..., -S:]], dim=-1).reshape(
            p.shape[0], -1) for p in planes]

    if rescue:
        halo_pos = [hp.T for hp in halo([p[:dim] for p in pm_ext])]
        den_p = [grid_mod._from_cells(den_c[d], addr[d],
                                      params[d].target_density)
                 for d in range(nsh)]
        nden_p = [grid_mod._from_cells(nden_c[d], addr[d], DENSITY_PADDING)
                  for d in range(nsh)]
        den_p, nden_p, odata, rescued, unres = _rescue_density_common(
            pred, vel, active, dropped, den_p, nden_p, halo_pos, params,
            coeffs, R, mesh, cfg.chunk)
        # corrected resident rows into the planes before the exchange, so
        # the neighbours' force passes see them too
        den_c = [grid_mod._to_cells(den_c[d], addr[d], den_p[d])
                 for d in range(nsh)]
        nden_c = [grid_mod._to_cells(nden_c[d], addr[d], nden_p[d])
                  for d in range(nsh)]

    dfields = [torch.stack([
        den_c[d], nden_c[d],
        params[d].pressure_scalar * (den_c[d] - params[d].target_density),
        params[d].near_pressure_scalar * nden_c[d]]) for d in range(nsh)]
    # halo densities are the neighbours' exact local results; the edge
    # shards' outer slabs hold 0, which the force pass guards
    dfields_e = with_halo(dfields, [0.0] * 4)
    v_ext = with_halo(cell_vel, [0.0] * dim)

    den, nden, acc = [], [], []
    for d in range(nsh):
        grid_f = grid_mod.BucketGrid(
            cell_pos=pm_ext[d][:dim], cell_vel=v_ext[d],
            cell_mask=pm_ext[d][dim], addr=None, origin=None,
            overflow=overflow[d])
        acc_e = grid_mod.bucket_force_pass(grid_f, *dfields_e[d], params[d],
                                           coeffs[d], ext_cfg)
        den.append(grid_mod._from_cells(den_c[d], addr[d],
                                        params[d].target_density))
        nden.append(grid_mod._from_cells(nden_c[d], addr[d],
                                         DENSITY_PADDING))
        acc.append(grid_mod._from_cells(acc_e[:, :, local], addr[d], 0.0))

    if rescue:
        den = [torch.where(r, a, b) for r, a, b in zip(rescued, den_p, den)]
        nden = [torch.where(r, a, b)
                for r, a, b in zip(rescued, nden_p, nden)]
        hvel = [hv.T for hv in halo(v_ext)]
        hdens = halo([x[:2] for x in dfields_e])
        halo_rows = [{"pos": halo_pos[d], "vel": hvel[d],
                      "den": hdens[d][0], "nden": hdens[d][1]}
                     for d in range(nsh)]
        acc = _rescue_force_common(acc, pred, vel, active, dropped, den,
                                   nden, odata, rescued, halo_rows, params,
                                   coeffs, mesh, cfg.chunk)

    prs = [p.pressure_scalar * (x - p.target_density)
           for p, x in zip(params, den)]
    nprs = [p.near_pressure_scalar * x for p, x in zip(params, nden)]
    return den, nden, prs, nprs, acc, unres


# --------------------------------------------------------------------------
# exact capacity-overflow rescue across shards
# --------------------------------------------------------------------------
#
# 1. each shard packs up to R dropped rows (pos, vel) and sends them to both
#    neighbours;
# 2. density: one sweep of [mine + from-left + from-right] dropped queries
#    against the LOCAL particles (query-side sums for my rows, candidate-side
#    corrections for local residents), plus a sweep of my dropped rows
#    against the halo pseudo-particles and the neighbours' dropped rows;
#    corrected densities go into the planes BEFORE the density exchange;
# 3. force: the same sweeps with the pair-force formulas, adding corrections
#    to my residents from mine and the neighbours' dropped rows.
# Beyond-budget overflow stays dropped and is counted. A dropped particle at
# the far edge of the halo window misses neighbours deeper than one slab —
# the one-slab locality the whole step rests on.

def _pack_dropped(pred, vel, dropped, R: int):
    """First R dropped rows (stable order): local indices, validity and
    _FAR-padded feature rows."""
    prio = torch.where(dropped, 0, 1).to(torch.int32)
    order = torch.sort(prio, stable=True).indices[:R]
    valid = dropped[order]
    opos = torch.where(valid[:, None], pred[order], _FAR)
    ovel = torch.where(valid[:, None], vel[order], 0.0)
    return order, valid, opos, ovel


def _both_ways(trees: list[dict], mesh: Mesh):
    """Each shard's dict to its right and left neighbours. Returns
    (from_left, from_right) lists; the wrapped edges' 'valid' is False."""
    keys = list(trees[0])
    from_left = [dict() for _ in trees]
    from_right = [dict() for _ in trees]
    for k in keys:
        xs = [t[k] for t in trees]
        for d, x in enumerate(mesh.shift_right(xs)):
            from_left[d][k] = x
        for d, x in enumerate(mesh.shift_left(xs)):
            from_right[d][k] = x
    from_left[0]["valid"] = torch.zeros_like(from_left[0]["valid"])
    from_right[-1]["valid"] = torch.zeros_like(from_right[-1]["valid"])
    return from_left, from_right


def _halo_pseudo(planes, gx_loc: int, S_pad: int, PAD: int):
    """The two halo-slab regions of (F, cap, L) planes as (F, 2·cap·S_pad)
    pseudo-particle feature rows (empty slots _FAR in position planes)."""
    F = planes.shape[0]
    lo = planes[:, :, PAD - S_pad:PAD]
    hi = planes[:, :, PAD + gx_loc * S_pad:PAD + (gx_loc + 1) * S_pad]
    return torch.cat([lo.reshape(F, -1), hi.reshape(F, -1)], dim=-1)


def _density_sweep(opos, cand_groups, params: SimParams,
                   coeffs: KernelCoeffs, chunk: int,
                   want_corrections: bool = False):
    """Chunked dense density sweep: queries (O, dim) against each candidate
    group (C, dim) of positions. Returns query-side (den_o, nden_o) sums
    and, for the FIRST group when asked, per-candidate corrections (all
    queries' contributions to each candidate)."""
    h = params.smoothing_radius
    den_o = torch.zeros(opos.shape[0], dtype=opos.dtype, device=opos.device)
    nden_o = torch.zeros_like(den_o)
    corrections = None
    for gi, cpos_all in enumerate(cand_groups):
        cw, cwn = [], []
        for sl in _chunks(cpos_all.shape[0], chunk):
            cpos = cpos_all[sl]
            d2 = ((opos[:, None, :] - cpos[None, :, :]) ** 2).sum(dim=-1)
            dist = torch.sqrt(torch.clamp_max(d2, _FAR))
            m = torch.where(dist <= h, 1.0, 0.0)
            dc = torch.minimum(dist, h)
            w = m * kernels.w_density(dc, h, coeffs)
            wn = m * kernels.w_near(dc, h, coeffs)
            den_o = den_o + w.sum(dim=1)
            nden_o = nden_o + wn.sum(dim=1)
            if gi == 0 and want_corrections:
                cw.append(w.sum(dim=0))
                cwn.append(wn.sum(dim=0))
        if gi == 0 and want_corrections:
            corrections = (torch.cat(cw), torch.cat(cwn))
    return den_o, nden_o, corrections


def _force_sweep(q: dict, cand_groups: list[dict], params: SimParams,
                 coeffs: KernelCoeffs, chunk: int,
                 want_corrections: bool = False):
    """Chunked dense pair-force sweep (the formulas of ops/rescue.py::
    force_rescue). q: query rows (pos, vel, den, nden, prs, nprs, id).
    Candidate groups: dicts of the same rows (id -2 padding, -3 excluded
    beyond-budget rows). Returns query-side (pf_o, vf_o) and, for the first
    group when asked, per-candidate (pf_j, vf_j) corrections."""
    h = params.smoothing_radius
    O, dim = q["pos"].shape
    dev = q["pos"].device
    up = torch.zeros(dim, dtype=q["pos"].dtype, device=dev)
    up[1] = 1.0
    pf_o = torch.zeros((O, dim), dtype=q["pos"].dtype, device=dev)
    vf_o = torch.zeros_like(pf_o)
    corrections = None
    for gi, grp in enumerate(cand_groups):
        pf_j, vf_j = [], []
        for sl in _chunks(grp["pos"].shape[0], chunk):
            ch = {k: v[sl] for k, v in grp.items()}
            disp = ch["pos"][None, :, :] - q["pos"][:, None, :]    # o -> j
            d2 = (disp * disp).sum(dim=-1)
            dist = torch.sqrt(torch.clamp_max(d2, _FAR))
            m = torch.where((dist <= h)
                            & (q["id"][:, None] != ch["id"][None])
                            & (ch["id"][None] != -3), 1.0, 0.0)
            dc = torch.minimum(dist, h)
            safe = torch.where(dist > 0.0, dist, 1.0)
            dir_oj = torch.where((dist > 0.0)[..., None],
                                 disp / safe[..., None], up)
            shared_p = (q["prs"][:, None] + ch["prs"][None]) * 0.5
            shared_np = (q["nprs"][:, None] + ch["nprs"][None]) * 0.5
            dw = kernels.dw_density(dc, h, coeffs)
            dwn = kernels.dw_near(dc, h, coeffs)
            wv = m * kernels.w_viscosity(dc, h, coeffs)

            scale_o = m * (shared_p * dw / ch["den"][None]
                           + shared_np * dwn / ch["nden"][None])
            pf_o = pf_o + (dir_oj * scale_o[..., None]).sum(dim=1)
            vf_o = vf_o + ((ch["vel"][None] - q["vel"][:, None])
                           * wv[..., None]).sum(dim=1)
            if gi == 0 and want_corrections:
                # force ON the candidate: the direction flips except for
                # the +y fallback at d == 0, which both sides take
                dir_jo = torch.where((dist > 0.0)[..., None], -dir_oj, up)
                scale_j = m * (shared_p * dw / q["den"][:, None]
                               + shared_np * dwn / q["nden"][:, None])
                pf_j.append((dir_jo * scale_j[..., None]).sum(dim=0))
                vf_j.append(((q["vel"][:, None] - ch["vel"][None])
                             * wv[..., None]).sum(dim=0))
        if gi == 0 and want_corrections:
            corrections = (torch.cat(pf_j), torch.cat(vf_j))
    return pf_o, vf_o, corrections


def _rescue_density_common(pred, vel, active, dropped, den_p, nden_p,
                           halo_pos, params, coeffs, R: int, mesh: Mesh,
                           chunk: int):
    """Phase-1 rescue over all shards (per-shard lists): pack and exchange
    the dropped rows, sweep [mine + neighbours'] against the locals and mine
    against the halo pseudo-particles and the neighbours' dropped rows.

    Returns lists (den_p, nden_p, odata, rescued, unres): fully corrected
    per-slot densities, the data phase 2 needs, the rescued mask and the
    beyond-budget count."""
    packs = [_pack_dropped(pred[d], vel[d], dropped[d], R)
             for d in range(mesh.size)]
    fl, fr = _both_ways([{"pos": opos, "vel": ovel, "valid": valid}
                         for _, valid, opos, ovel in packs], mesh)
    out = ([], [], [], [], [])
    for d, (order, valid, opos, ovel) in enumerate(packs):
        p, c = params[d], coeffs[d]
        vall = torch.cat([valid, fl[d]["valid"], fr[d]["valid"]])
        opos_all = torch.where(
            vall[:, None],
            torch.cat([opos, fl[d]["pos"], fr[d]["pos"]]), _FAR)
        local_pos = torch.where((active[d] > 0)[:, None], pred[d], _FAR)
        den_all, nden_all, (cw, cwn) = _density_sweep(
            opos_all, [local_pos], p, c, chunk, want_corrections=True)
        nbr_pos = [torch.where(x["valid"][:, None], x["pos"], _FAR)
                   for x in (fl[d], fr[d])]
        den_h, nden_h, _ = _density_sweep(opos, [halo_pos[d]] + nbr_pos, p,
                                          c, chunk)
        my_den = den_all[:R] + den_h + DENSITY_PADDING
        my_nden = nden_all[:R] + nden_h + DENSITY_PADDING

        rescued = torch.zeros_like(dropped[d])
        rescued[order] = valid
        den_full = torch.zeros_like(den_p[d])
        den_full[order] = torch.where(valid, my_den, 0.0)
        nden_full = torch.zeros_like(nden_p[d])
        nden_full[order] = torch.where(valid, my_nden, 0.0)
        # residents gain the dropped contributions; rescued rows take their
        # exact sums; beyond-budget rows keep their fills
        out[0].append(torch.where(
            rescued, den_full,
            torch.where(dropped[d], den_p[d], den_p[d] + cw)))
        out[1].append(torch.where(
            rescued, nden_full,
            torch.where(dropped[d], nden_p[d], nden_p[d] + cwn)))
        out[2].append({"order": order, "valid": valid, "pos": opos,
                       "vel": ovel, "den": my_den, "nden": my_nden})
        out[3].append(rescued)
        out[4].append((dropped[d].sum() - valid.sum()).to(torch.int32))
    return out


def _rescue_force_common(acc, pred, vel, active, dropped, den, nden, odata,
                         rescued, halo, params, coeffs, mesh: Mesh,
                         chunk: int):
    """Phase-2 rescue over all shards: pair forces for every pair that
    involves a dropped particle, both sides. ``den``/``nden`` are the
    corrected per-slot densities; ``halo`` the per-shard pseudo-particle
    dicts (pos, vel, den, nden). Returns the corrected accelerations."""
    fl, fr = _both_ways([{k: o[k] for k in ("pos", "vel", "den", "nden",
                                            "valid")} for o in odata], mesh)
    out = []
    for d in range(mesh.size):
        p, c = params[d], coeffs[d]
        Pn = pred[d].shape[0]
        R = odata[d]["order"].shape[0]
        dev = pred[d].device

        def eos(dn, ndn):
            return (p.pressure_scalar * (dn - p.target_density),
                    p.near_pressure_scalar * ndn)

        def qrows(x, ids):
            prs, nprs = eos(x["den"], x["nden"])
            v = x["valid"]
            return {"pos": torch.where(v[:, None], x["pos"], _FAR),
                    "vel": x["vel"],
                    "den": torch.where(v, x["den"], 1.0),
                    "nden": torch.where(v, x["nden"], 1.0),
                    "prs": torch.where(v, prs, 0.0),
                    "nprs": torch.where(v, nprs, 0.0),
                    "id": ids}

        mine = odata[d]
        my_ids = torch.where(mine["valid"], mine["order"], -1)
        neg = torch.full((R,), -1, dtype=my_ids.dtype, device=dev)
        parts = [qrows(mine, my_ids), qrows(fl[d], neg), qrows(fr[d], neg)]
        q_all = {k: torch.cat([x[k] for x in parts]) for k in parts[0]}

        iota = torch.arange(Pn, device=dev)
        unres = dropped[d] & ~rescued[d]
        prs, nprs = eos(den[d], nden[d])
        act = active[d] > 0
        locals_grp = {
            "pos": torch.where(act[:, None], pred[d], _FAR),
            "vel": vel[d],
            "den": torch.where(den[d] > 0, den[d], 1.0),
            "nden": torch.where(nden[d] > 0, nden[d], 1.0),
            "prs": prs, "nprs": nprs,
            # beyond-budget rows carry fill densities: out of the physics
            # this step (counted)
            "id": torch.where(act, torch.where(unres, -3, iota), -2),
        }
        pf_all, vf_all, (pf_j, vf_j) = _force_sweep(
            q_all, [locals_grp], p, c, chunk, want_corrections=True)

        h = halo[d]
        hprs, hnprs = eos(h["den"], h["nden"])
        halo_grp = {"pos": h["pos"], "vel": h["vel"],
                    "den": torch.where(h["den"] > 0, h["den"], 1.0),
                    "nden": torch.where(h["nden"] > 0, h["nden"], 1.0),
                    "prs": hprs, "nprs": hnprs,
                    "id": torch.full((h["pos"].shape[0],), -1,
                                     dtype=my_ids.dtype, device=dev)}
        q_mine = {k: v[:R] for k, v in q_all.items()}
        pf_h, vf_h, _ = _force_sweep(q_mine, [halo_grp] + parts[1:], p, c,
                                     chunk)

        valid = mine["valid"]
        my_den_safe = torch.where(valid, mine["den"], 1.0)
        acc_o = ((pf_all[:R] + pf_h) / my_den_safe[:, None]
                 + p.viscosity_strength * (vf_all[:R] + vf_h))
        acc_full = torch.zeros_like(acc[d])
        acc_full[mine["order"]] = torch.where(valid[:, None], acc_o, 0.0)
        den_safe = torch.where(den[d] > 0, den[d], 1.0)
        acc_corr = pf_j / den_safe[:, None] + p.viscosity_strength * vf_j
        out.append(torch.where(
            rescued[d][:, None], acc_full,
            torch.where(dropped[d][:, None], acc[d], acc[d] + acc_corr)))
    return out


def _migrate(states, active, params, cfg: SimConfig, gx_loc: int,
             mesh: Mesh, mig_cap: int):
    """Move particles whose predicted cell-x left the local slab to the
    neighbour shard (one slab a step at most). Returns (states, active,
    lost per shard (), f32)."""
    ndev = mesh.size
    fields = ("pos", "vel", "predicted", "ids")
    out_l, out_r, act = [], [], []
    for d, (s, a) in enumerate(zip(states, active)):
        p = params[d]
        origin = _grid_origin_static(p, cfg)
        cx = torch.floor((s.predicted[:, 0] - origin[0])
                         / p.smoothing_radius).to(torch.int32)
        cx = torch.clamp(cx, 0, cfg.grid_dims[0] - 1)
        target = torch.clamp(cx // gx_loc, 0, ndev - 1)
        a = a.clone()
        for mask, sink in (((target < d) & (a > 0), out_l),
                           ((target > d) & (a > 0), out_r)):
            # up to mig_cap flagged rows, in row order
            prio = torch.where(mask, 0, 1)
            order = torch.sort(prio, stable=True).indices[:mig_cap]
            valid = mask[order]
            rows = {f: getattr(s, f)[order] for f in fields}
            rows["valid"] = valid.to(torch.float32)
            sink.append(rows)
            # departed rows go inactive
            a[order] = torch.where(valid, 0.0, a[order])
        act.append(a)

    def shift(rows, move):
        moved = [dict() for _ in rows]
        for k in rows[0]:
            for d, x in enumerate(move([r[k] for r in rows])):
                moved[d][k] = x
        return moved

    in_from_right = shift(out_l, mesh.shift_left)
    in_from_left = shift(out_r, mesh.shift_right)
    # wrapped edges carry nothing
    in_from_right[-1]["valid"] = torch.zeros_like(in_from_right[-1]["valid"])
    in_from_left[0]["valid"] = torch.zeros_like(in_from_left[0]["valid"])

    def merge(s, a, inc):
        """Arrivals into free slots (inactive slots first, in row order)."""
        free = torch.sort(a, stable=True).indices[:inc["valid"].shape[0]]
        take = (inc["valid"] > 0) & (a[free] == 0.0)
        lost = inc["valid"].sum() - take.sum()
        new = {}
        for f in fields:
            arr = getattr(s, f).clone()
            sel = take.reshape((-1,) + (1,) * (arr.dim() - 1))
            arr[free] = torch.where(sel, inc[f], arr[free])
            new[f] = arr
        a = a.clone()
        a[free] = torch.where(take, 1.0, a[free])
        return dataclasses.replace(s, **new), a, lost

    new_states, new_active, lost = [], [], []
    for d in range(ndev):
        s, a, lost_r = merge(states[d], act[d], in_from_right[d])
        s, a, lost_l = merge(s, a, in_from_left[d])
        new_states.append(s)
        new_active.append(a)
        lost.append((lost_r + lost_l).to(torch.float32))
    return new_states, new_active, lost


def make_domain_step(mesh: Mesh, cfg: SimConfig, mig_cap: int = 256,
                     use_pallas: bool | None = None, rescue_cap: int = 256):
    """The domain-decomposed step: ``step(states, active, params) ->
    (states, active, lost)``, ``lost`` the migration losses summed over
    shards (() f32 on shard 0's device).

    ``use_pallas`` None or True: the density and force kernels on every
    device (their plain versions on CPU tensors). False: the plain
    pair-block passes of ``ops/grid.py`` on every shard (``_sph_local``,
    the JAX package's XLA per-device passes)."""
    ndev = mesh.size
    gx = cfg.grid_dims[0]
    if cfg.grid_frame != "world":
        raise ValueError(
            "the domain-decomposed step shards x-slabs of a static WORLD "
            "grid (_grid_origin_static); grid_frame='container' is a "
            "single-device layout optimization — drop it for multi-shard")
    if gx % ndev:
        raise ValueError(f"grid_dims[0]={gx} not divisible by {ndev}")
    gx_loc = gx // ndev
    sph_local = _sph_local if use_pallas is False else _sph_local_pallas

    def domain_step(states, active, params: SimParams):
        ps = _per_shard(params, mesh)
        coeffs = [KernelCoeffs.from_radius(p.smoothing_radius, cfg.dim)
                  for p in ps]
        den, nden, prs, nprs, acc, overflow = sph_local(
            [s.predicted for s in states], [s.vel for s in states], active,
            ps, coeffs, cfg, gx_loc, mesh, rescue_cap=rescue_cap)
        ovf = mesh.psum(overflow)
        stepped = []
        for d, s in enumerate(states):
            t_new = s.time + ps[d].dt
            pos, vel, predicted = integrate_mod.integrate(
                s.pos, s.vel, acc[d], ps[d], t_new)
            # inactive slots stay inert and far away
            act = (active[d] > 0)[:, None]
            stepped.append(FluidState(
                pos=torch.where(act, pos, _FAR),
                vel=torch.where(act, vel, 0.0),
                predicted=torch.where(act, predicted, _FAR),
                acc=acc[d], density=den[d], near_density=nden[d],
                pressure=prs[d], near_pressure=nprs[d],
                step_count=s.step_count + 1, time=t_new, overflow=ovf[d],
                overflow_total=s.overflow_total + ovf[d].to(torch.float32),
                ids=s.ids))
        stepped, active, lost = _migrate(stepped, active, ps, cfg, gx_loc,
                                         mesh, mig_cap)
        return stepped, active, mesh.psum(lost)[0]

    return domain_step


def make_domain_rollout(mesh: Mesh, cfg: SimConfig, mig_cap: int = 256,
                        use_pallas: bool | None = None,
                        rescue_cap: int = 256):
    """``rollout(states, active, params, num_steps) -> (states, active,
    lost_sum)``: a loop over the domain step, losses summed on the
    device."""
    step = make_domain_step(mesh, cfg, mig_cap=mig_cap,
                            use_pallas=use_pallas, rescue_cap=rescue_cap)

    def rollout(states, active, params, num_steps: int):
        lost = torch.zeros((), device=mesh.devices[0])
        for _ in range(num_steps):
            states, active, lost_step = step(states, active, params)
            lost = lost + lost_step
        return states, active, lost

    return rollout


def gather_dense(states, active) -> tuple:
    """Host-side: the active particles' (positions, velocities) as numpy
    arrays, in shard order."""
    act = np.concatenate([a.cpu().numpy() for a in active]) > 0
    pos = np.concatenate([s.pos.cpu().numpy() for s in states])
    vel = np.concatenate([s.vel.cpu().numpy() for s in states])
    return pos[act], vel[act]
