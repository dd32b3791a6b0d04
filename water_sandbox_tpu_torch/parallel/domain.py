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
  move to the neighbour's free slots with every per-row field the step
  gave them (at most ``mig_cap`` each way a step; the rest stay and move
  next step; arrivals with no free slot are counted in ``lost``).

A sharded state is a list of per-shard ``FluidState``s (P rows each, the
scalars replicated) and a list of per-shard ``active`` masks (P,) f32.
Every shard's work runs under its scope of the mesh (``Mesh.each``), on
its own CUDA stream, so on one card the shards run concurrently, as JAX's
shards run on their own devices; the collectives are the mesh's and the
only place where one shard waits on another. The step reads nothing on the
host, as JAX's ``jit(shard_map)``
does not: the cross-shard rescue's kernels (``ops/cuda/domain_rescue.py``)
gate themselves on a device count where JAX has ``lax.cond`` on
``pmax(overflow) > 0``, and the plain pair-block path computes its rescue
and selects it with ``torch.where``. So ``ops/cuda/graph.py::DomainGraph``
captures the step as one CUDA graph when every shard sits on one CUDA
device (``make_domain_rollout``, ``DistributedSimulation.run``), the
counterpart of JAX's ``lax.scan`` over the jitted step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.params import (DENSITY_PADDING, KernelCoeffs, SimConfig,
                           SimParams, _map_tensors)
from ..core.state import FluidState
from ..ops import grid as grid_mod, integrate as integrate_mod
from ..ops import rescue as rescue_mod
from ..ops.cuda import domain_rescue as dr, graph as graph_mod
from ..ops.cuda import sph_bucket as sb
from ..runtime import profiling
from .mesh import Mesh

_FAR = sb._FAR


def _grid_origin_static(params: SimParams, cfg: SimConfig) -> torch.Tensor:
    """Grid anchor shared by all shards: 2h below the container's minimum
    corner."""
    h = params.smoothing_radius
    c = params.container
    return c.center - c.half_size - 2.0 * h


def _per_shard(params: SimParams, mesh: Mesh) -> list[SimParams]:
    """The parameters on every shard's device, moved on the shard's stream
    (on one device: the same tensors, which a step only reads)."""
    return mesh.each(lambda d: params.to(mesh.devices[d]))


def _split(rows: list) -> tuple:
    """Per-shard tuples as a tuple of per-shard lists."""
    return tuple(list(x) for x in zip(*rows))


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

    def fill(d):
        p = planes[d]
        if d > 0:
            p[:, :, PAD - S_pad:PAD] = from_left[d]
        if d < mesh.size - 1:
            p[:, :, hi:hi + S_pad] = from_right[d]

    mesh.each(fill)
    return planes


def _local_cfg(cfg: SimConfig, gx_loc: int) -> SimConfig:
    return dataclasses.replace(cfg, grid_dims=(gx_loc,) + cfg.grid_dims[1:])


def _halo_build(pred, vel, active, params, cfg: SimConfig, gx_loc: int,
                mesh: Mesh):
    """``halo_planes`` and each shard's rows in its build's column order
    (``domain_rescue.Rows``, the order the rescue's kernels walk)."""
    cfg_loc = _local_cfg(cfg, gx_loc)
    g = sb._geometry(cfg_loc)

    def build(d):
        p, _, a, o, skey, order = sb.build_local_slab_buckets(
            pred[d], vel[d], active[d], _grid_origin_static(params[d], cfg),
            gx_loc, d, params[d], cfg_loc)
        return p, a, o, dr.Rows(skey, order)

    with mesh.step():
        planes, addr, overflow, walks = _split(mesh.each(build))
        feats = _exchange_halo_slabs(planes, gx_loc, g.S_pad, g.PAD, mesh)
        counts = mesh.each(lambda d: (feats[d][0] < _FAR * 0.5).sum(
            dim=0, dtype=feats[d].dtype)[None, :])
    return feats, counts, addr, overflow, walks


def halo_planes(pred, vel, active, params, cfg: SimConfig, gx_loc: int,
                mesh: Mesh):
    """Each shard's local build, then the exchange of the position and
    velocity boundary slabs, then the occupied-slot counts re-derived from
    the EXCHANGED position plane (so the walk sees the halo candidates).

    Returns lists (feats, counts, addr, overflow); ``addr`` addresses the
    local rows only, the halo lanes are read as candidates."""
    return _halo_build(pred, vel, active, params, cfg, gx_loc, mesh)[:4]


def _sph_local_pallas(pred, vel, active, params, coeffs, cfg: SimConfig,
                      gx_loc: int, mesh: Mesh, rescue_cap: int = 256):
    """Density + force for every shard's local rows with halo-exact
    neighbour data, through the density and force kernels.

    With cfg.rescue_capacity > 0, capacity-overflow particles get the exact
    rescue, up to ``rescue_cap`` a shard a step, with dropped rows sent to
    both neighbours so cross-shard pairs are exact too: the kernels D1 and
    D2 (``ops/cuda/domain_rescue.py``) run on every step, each shard's
    launches gated on the device count of its valid query rows.

    All arguments but cfg, gx_loc, mesh and rescue_cap are per-shard lists.
    Returns lists (den, nden, prs, nprs, acc, overflow)."""
    cfg_loc = _local_cfg(cfg, gx_loc)
    g = sb._geometry(cfg_loc)
    sentinel = sb._cap_pad(cfg.cell_capacity) * g.L

    feats, counts, addr, overflow, walks = _halo_build(
        pred, vel, active, params, cfg, gx_loc, mesh)
    pv = mesh.each(lambda d: sb._param_vector(params[d], coeffs[d]))
    dens = mesh.each(lambda d: sb.run_density(feats[d], counts[d], addr[d],
                                              pv[d], cfg_loc))

    rescue = cfg.rescue_capacity > 0
    unres = overflow
    if rescue:
        # the kernels read rows through raw pointers
        pred, vel = _split(mesh.each(lambda d: (pred[d].contiguous(),
                                                vel[d].contiguous())))
        dropped = mesh.each(lambda d: (addr[d] == sentinel) & (active[d] > 0))
        qs, slots, R = _rescue_queries(pred, vel, dropped, overflow, params,
                                       cfg, gx_loc, mesh, rescue_cap)

        def d1(d):
            # corrected resident rows, with consistent derived planes, go
            # into the planes before the exchange so the neighbours' force
            # passes see them too
            qden = torch.zeros(R, device=pred[d].device)
            qnden = torch.zeros_like(qden)
            dr.rescue_density(pred[d], walks[d], addr[d], qs[d], feats[d],
                              dens[d], qden, qnden, params[d], coeffs[d],
                              pv[d], cfg_loc)
            return qden, qnden, overflow[d] - torch.clamp_max(overflow[d], R)

        qden, qnden, unres = _split(mesh.each(d1))

    # halo densities are the neighbours' exact local results
    dens = _exchange_halo_slabs(dens, gx_loc, g.S_pad, g.PAD, mesh)

    def force(d):
        # the query-side force kernel (the JAX step pins the "qrow3" gate):
        # a pair-once kernel would write the mirrored halves of boundary
        # pairs into halo lanes that no shard reads back
        out = sb.run_force(feats[d], dens[d], counts[d], addr[d], pv[d],
                           cfg_loc)
        return sb.gather_results(out, addr[d], addr[d] == sentinel,
                                 params[d])

    den, nden, acc = _split(mesh.each(force))

    if rescue:
        den, nden = _split(mesh.each(lambda d: (
            _rescued(slots[d], qden[d], den[d], R),
            _rescued(slots[d], qnden[d], nden[d], R))))
        qfs = _force_queries(qs, qden, qnden, params, mesh)

        def d2(d):
            p = params[d]
            a = acc[d].contiguous()
            dr.rescue_force(
                pred[d], vel[d], den[d], nden[d],
                p.pressure_scalar * (den[d] - p.target_density),
                p.near_pressure_scalar * nden[d], walks[d], slots[d], qs[d],
                qfs[d], feats[d], dens[d], a, p, coeffs[d], pv[d], cfg_loc)
            return a

        acc = mesh.each(d2)

    prs, nprs = _pressures(den, nden, params, mesh)
    return den, nden, prs, nprs, acc, unres


def _pressures(den, nden, params, mesh: Mesh) -> tuple:
    """Each shard's pressures and near pressures from its densities."""
    return _split(mesh.each(lambda d: (
        params[d].pressure_scalar * (den[d] - params[d].target_density),
        params[d].near_pressure_scalar * nden[d])))


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

    cell = torch.floor((pred - origin) / h).to(torch.int32)
    # clamped axis by axis with Python bounds: no host-to-device copy
    ax = [torch.clamp(cell[:, a], 0, dims[a] - 1) for a in range(len(dims))]
    cx_local = torch.clamp(ax[0] - my_dev * gx_loc, 0, gx_loc - 1)
    rest = ax[1]
    for a in range(2, len(dims)):
        rest = rest * dims[a] + ax[a]
    cid = cx_local * S + rest
    cell_pos, cell_vel, cell_mask, addr, kept, _, _ = (
        grid_mod._scatter_buckets(cid, active, pred, vel, cfg.cell_capacity,
                                  nc_loc))
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
        slab = torch.empty((p.shape[0], p.shape[1], S), dtype=p.dtype,
                           device=p.device)
        for f, v in enumerate(fill):
            slab[f].fill_(v)
        out.append(torch.cat([slab, p, slab], dim=-1))
    return out


def _sph_local(pred, vel, active, params, coeffs, cfg: SimConfig,
               gx_loc: int, mesh: Mesh, rescue_cap: int = 256):
    """Density + force for every shard's local rows with halo-exact
    neighbour data, through the plain pair-block passes of ``ops/grid.py``
    (the JAX package's ``_sph_local``). Only the middle slabs' densities
    are right after the first pass (the halo slabs lack their own outer
    neighbours), so the computed density planes are exchanged again before
    the force pass. The rescue is the plain one of the kernels' path (the
    sweeps of ``ops/cuda/domain_rescue.py``), computed on every step and
    selected by ``pmax(overflow) > 0`` on the device (JAX's ``lax.cond``).

    All arguments but cfg, gx_loc, mesh and rescue_cap are per-shard lists.
    Returns lists (den, nden, prs, nprs, acc, overflow)."""
    dim = cfg.dim
    cap = cfg.cell_capacity
    ext_cfg = _local_cfg(cfg, gx_loc + 2)

    def buckets(d):
        cp, cv, cm, a, o, S = _local_buckets(
            pred[d], vel[d], active[d], _grid_origin_static(params[d], cfg),
            params[d], cfg, gx_loc, d)
        return torch.cat([cp, cm[None]], dim=0), cv, a, o, S

    pm, cell_vel, addr, overflow, S = _split(mesh.each(buckets))
    S = S[0]
    nc_loc = gx_loc * S
    local = slice(S, S + nc_loc)

    def with_halo(planes, fill):
        padded = mesh.each(lambda d: _pad_slabs([planes[d]], S, fill)[0])
        return _exchange_halo_slabs(padded, gx_loc, S, S, mesh)

    pm_ext = with_halo(pm, [_FAR] * dim + [0.0])
    # the query cells: the occupied local cells (at most a row each), a
    # fixed-size list with no host read
    query = mesh.each(lambda d: grid_mod._occupied_cells(
        pm_ext[d][dim], min(pred[d].shape[0], nc_loc), S, S + nc_loc))

    def density(d):
        grid_ext = grid_mod.BucketGrid(
            cell_pos=pm_ext[d][:dim], cell_vel=None, cell_mask=pm_ext[d][dim],
            addr=None, origin=None, overflow=overflow[d])
        den_e, nden_e, _, _ = grid_mod.bucket_density_pass(
            grid_ext, params[d], coeffs[d], ext_cfg, query[d])
        return den_e[:, local], nden_e[:, local]

    den_c, nden_c = _split(mesh.each(density))

    rescue = cfg.rescue_capacity > 0
    unres = overflow

    def halo(p):
        return torch.cat([p[..., :S], p[..., -S:]], dim=-1).reshape(
            p.shape[0], -1)

    if rescue:
        top = mesh.pmax(overflow)
        on = mesh.each(lambda d: top[d] > 0)
        dropped = mesh.each(lambda d: (addr[d] == cap * nc_loc)
                            & (active[d] > 0))
        qs, slots, R = _rescue_queries(pred, vel, dropped, overflow, params,
                                       cfg, gx_loc, mesh, rescue_cap)
        halo_pos = mesh.each(lambda d: halo(pm_ext[d][:dim]).T)

        def d1(d):
            my_den, my_nden, cw, cwn = dr.density_sums(
                qs[d].pos, qs[d].valid, R,
                torch.where((active[d] > 0)[:, None], pred[d], _FAR),
                halo_pos[d], params[d], coeffs[d], cfg.chunk)
            # residents gain the dropped contributions; rescued rows take
            # their exact sums; beyond-budget rows keep their fills; the
            # corrected resident rows go into the planes before the
            # exchange, so the neighbours' force passes see them too
            planes = []
            for cells, fill, mine, gain in (
                    (den_c[d], params[d].target_density, my_den, cw),
                    (nden_c[d], DENSITY_PADDING, my_nden, cwn)):
                x = grid_mod._from_cells(cells, addr[d], fill)
                rows = _rescued(slots[d], mine, torch.where(
                    dropped[d], x, x + gain), R)
                planes.append(torch.where(on[d], grid_mod._to_cells(
                    cells, addr[d], rows), cells))
            o = overflow[d]
            return (*planes, my_den, my_nden,
                    torch.where(on[d], o - torch.clamp_max(o, R), o))

        den_c, nden_c, qden, qnden, unres = _split(mesh.each(d1))

    dfields = mesh.each(lambda d: torch.stack([
        den_c[d], nden_c[d],
        params[d].pressure_scalar * (den_c[d] - params[d].target_density),
        params[d].near_pressure_scalar * nden_c[d]]))
    # halo densities are the neighbours' exact local results; the edge
    # shards' outer slabs hold 0, which the force pass guards
    dfields_e = with_halo(dfields, [0.0] * 4)
    v_ext = with_halo(cell_vel, [0.0] * dim)

    def force(d):
        grid_f = grid_mod.BucketGrid(
            cell_pos=pm_ext[d][:dim], cell_vel=v_ext[d],
            cell_mask=pm_ext[d][dim], addr=None, origin=None,
            overflow=overflow[d])
        acc_e = grid_mod.bucket_force_pass(grid_f, *dfields_e[d], params[d],
                                           coeffs[d], ext_cfg, query[d])
        return (grid_mod._from_cells(den_c[d], addr[d],
                                     params[d].target_density),
                grid_mod._from_cells(nden_c[d], addr[d], DENSITY_PADDING),
                grid_mod._from_cells(acc_e[:, :, local], addr[d], 0.0))

    den, nden, acc = _split(mesh.each(force))

    if rescue:
        den, nden = _split(mesh.each(lambda d: (
            torch.where(on[d], _rescued(slots[d], qden[d], den[d], R),
                        den[d]),
            torch.where(on[d], _rescued(slots[d], qnden[d], nden[d], R),
                        nden[d]))))
        qfs = _force_queries(qs, qden, qnden, params, mesh)

        def d2(d):
            p = params[d]
            hdens = halo(dfields_e[d][:2])
            halo_grp = dr.halo_group(halo_pos[d], halo(v_ext[d]).T,
                                     hdens[0], hdens[1], p)
            new = dr.rescued_forces(
                acc[d], pred[d], vel[d], den[d], nden[d],
                p.pressure_scalar * (den[d] - p.target_density),
                p.near_pressure_scalar * nden[d], active[d] > 0, slots[d],
                qs[d], qfs[d], halo_grp, p, coeffs[d], cfg.chunk)
            return torch.where(on[d], new, acc[d])

        acc = mesh.each(d2)

    prs, nprs = _pressures(den, nden, params, mesh)
    return den, nden, prs, nprs, acc, unres


# --------------------------------------------------------------------------
# exact capacity-overflow rescue across shards
# --------------------------------------------------------------------------
#
# 1. each shard picks its first R dropped rows in row order
#    (ops/rescue.py::rescue_selection: one cumsum, no sort, no host read)
#    and sends them to both neighbours;
# 2. density (D1): [mine + neighbours'] dropped rows against the LOCAL
#    particles (their sums for my rows, their contributions for local
#    residents), my rows also against the halo pseudo-particles and the
#    neighbours' rows; corrected densities go into the planes BEFORE the
#    density exchange;
# 3. force (D2): my rows' densities go to the neighbours, then the same
#    pairs with the pair-force formulas, adding corrections to my residents
#    from mine and the neighbours' dropped rows.
# Beyond-budget overflow stays dropped and is counted. A dropped particle at
# the far edge of the halo window misses neighbours deeper than one slab —
# the one-slab locality the whole step rests on.

def _neighbours(xs: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Each shard's own tensor, its left neighbour's and its right
    neighbour's, concatenated (``lax.ppermute`` both ways; the rows that
    came across the wrapped edges are masked by the callers)."""
    left, right = mesh.shift_right(xs), mesh.shift_left(xs)
    return mesh.each(lambda d: torch.cat([xs[d], left[d], right[d]]))


def _rescue_queries(pred, vel, dropped, overflow, params, cfg: SimConfig,
                    gx_loc: int, mesh: Mesh, rescue_cap: int):
    """Each shard's first R = min(rescue_cap, rescue_capacity, P) dropped
    rows, sent to both neighbours. Returns (per-shard
    ``domain_rescue.Queries``, per-shard ``slot`` (P,) i32 — a dropped
    row's rank, -1 otherwise —, R)."""
    cfg_loc = _local_cfg(cfg, gx_loc)
    R = min(rescue_cap, cfg.rescue_capacity, pred[0].shape[0])

    def select(d):
        s, slot, count = rescue_mod.rescue_selection(dropped[d], overflow[d],
                                                     R)
        v = torch.arange(R, device=s.device) < count
        return (s, slot, v, torch.where(v[:, None], pred[d][s.long()], _FAR),
                torch.where(v[:, None], vel[d][s.long()], 0.0))

    sel, slots, valid, pos, vel_q = _split(mesh.each(select))
    valid, pos, vel_q = (_neighbours(x, mesh) for x in (valid, pos, vel_q))

    def queries(d):
        v = valid[d]
        if d == 0:
            v[R:2 * R] = False                    # the wrapped edges
        if d == mesh.size - 1:
            v[2 * R:] = False
        p = torch.where(v[:, None], pos[d], _FAR)
        col, scol, qord = dr.query_walk(
            p, v, _grid_origin_static(params[d], cfg), gx_loc, d, params[d],
            cfg_loc)
        return dr.Queries(p, vel_q[d], v, sel[d], col, scol, qord,
                          v.sum(dtype=torch.int32))

    return mesh.each(queries), slots, R


def _force_queries(qs, qden, qnden, params, mesh: Mesh) -> list:
    """D2's query rows (``domain_rescue.force_rows``): each shard's rows
    with the densities D1 gave them, sent to both neighbours."""
    den, nden = _neighbours(qden, mesh), _neighbours(qnden, mesh)
    return mesh.each(lambda d: dr.force_rows(qs[d], den[d], nden[d],
                                             params[d]))


def _rescued(slot, mine, x, R: int):
    """``x`` (P,) with each rescued row's value of ``mine`` (R,), the list
    in row order (row ``sel[k]`` has slot k)."""
    at = torch.clamp(slot, 0, R - 1).long()
    return torch.where((slot >= 0) & (slot < R), mine[at], x)


# What a migrating particle takes to its new slot: every per-row field of
# its state, the vector fields and then the scalar ones, in one flat buffer
# a shard (``_packed``), so that one gather and one scatter of each kind
# move a row whole. ``ids`` rides bit-cast to float32: gathers, selects and
# copies keep its bits.
_VECTORS = ("pos", "vel", "predicted", "acc")
_SCALARS = ("density", "near_density", "pressure", "near_pressure", "ids")


def _packed(s: FluidState) -> tuple:
    """Shard state ``s``'s per-row fields copied into one buffer, as the
    views (len(_VECTORS), P, dim) and (len(_SCALARS), P)."""
    P, dim = s.pos.shape
    flat = torch.cat([getattr(s, f).reshape(-1) for f in _VECTORS]
                     + [getattr(s, f).view(torch.float32) for f in _SCALARS])
    nv = len(_VECTORS) * P * dim
    return (flat[:nv].view(len(_VECTORS), P, dim),
            flat[nv:].view(len(_SCALARS), P))


def _unpacked(s: FluidState, vec: torch.Tensor,
              sca: torch.Tensor) -> FluidState:
    """``s`` with its per-row fields read from ``_packed``'s views (each a
    contiguous slice of the buffer)."""
    fields = dict(zip(_VECTORS, vec.unbind(0)))
    fields.update(zip(_SCALARS, sca.unbind(0)))
    fields["ids"] = fields["ids"].view(s.ids.dtype)
    return dataclasses.replace(s, **fields)


def _migrate(states, active, params, cfg: SimConfig, gx_loc: int,
             mesh: Mesh, mig_cap: int):
    """Move particles whose predicted cell-x left the local slab to the
    neighbour shard (one slab a step at most), each with every per-row
    field the step gave it (the JAX package's ``_migrate`` moves ``pos``,
    ``vel``, ``predicted`` and ``ids`` alone and leaves the slot's old
    density, pressures and acceleration beside them). Returns (states,
    active, lost per shard (), f32)."""
    ndev = mesh.size

    def depart(d):
        s, p = states[d], params[d]
        origin = _grid_origin_static(p, cfg)
        cx = torch.floor((s.predicted[:, 0] - origin[0])
                         / p.smoothing_radius).to(torch.int32)
        cx = torch.clamp(cx, 0, cfg.grid_dims[0] - 1)
        target = torch.clamp(cx // gx_loc, 0, ndev - 1)
        vec, sca = _packed(s)
        a = active[d].clone()
        sinks = []
        for mask in ((target < d) & (a > 0), (target > d) & (a > 0)):
            # up to mig_cap flagged rows, in row order
            prio = torch.where(mask, 0, 1)
            order = torch.sort(prio, stable=True).indices[:mig_cap]
            valid = mask[order]
            sinks.append({"vec": vec.index_select(1, order),
                          "sca": sca.index_select(1, order),
                          "valid": valid.to(torch.float32)})
            # departed rows go inactive
            a[order] = torch.where(valid, 0.0, a[order])
        return (*sinks, vec, sca, a)

    out_l, out_r, vecs, scas, act = _split(mesh.each(depart))

    def shift(rows, move):
        moved = [dict() for _ in rows]
        for k in rows[0]:
            for d, x in enumerate(move([r[k] for r in rows])):
                moved[d][k] = x
        return moved

    in_from_right = shift(out_l, mesh.shift_left)
    in_from_left = shift(out_r, mesh.shift_right)

    def merge(vec, sca, a, inc):
        """Arrivals into free slots (inactive slots first, in row order),
        written in place into the shard's buffer and ``a``; returns the
        arrivals that found no free slot."""
        free = torch.sort(a, stable=True).indices[:inc["valid"].shape[0]]
        take = (inc["valid"] > 0) & (a[free] == 0.0)
        for buf, rows in ((vec, inc["vec"]), (sca, inc["sca"])):
            sel = take.reshape((-1,) + (1,) * (rows.dim() - 2))
            buf.index_copy_(1, free, torch.where(
                sel, rows, buf.index_select(1, free)))
        a[free] = torch.where(take, 1.0, a[free])
        return inc["valid"].sum() - take.sum()

    def arrive(d):
        inc_r, inc_l = in_from_right[d], in_from_left[d]
        # wrapped edges carry nothing
        if d == ndev - 1:
            inc_r = dict(inc_r, valid=torch.zeros_like(inc_r["valid"]))
        if d == 0:
            inc_l = dict(inc_l, valid=torch.zeros_like(inc_l["valid"]))
        lost = (merge(vecs[d], scas[d], act[d], inc_r)
                + merge(vecs[d], scas[d], act[d], inc_l))
        return (_unpacked(states[d], vecs[d], scas[d]), act[d],
                lost.to(torch.float32))

    return _split(mesh.each(arrive))


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
        with mesh.step():
            ps = _per_shard(params, mesh)
            coeffs = mesh.each(lambda d: KernelCoeffs.from_radius(
                ps[d].smoothing_radius, cfg.dim))
            den, nden, prs, nprs, acc, overflow = sph_local(
                [s.predicted for s in states], [s.vel for s in states],
                active, ps, coeffs, cfg, gx_loc, mesh, rescue_cap=rescue_cap)
            ovf = mesh.psum(overflow)

            def integrate(d):
                s = states[d]
                t_new = s.time + ps[d].dt
                pos, vel, predicted = integrate_mod.integrate(
                    s.pos, s.vel, acc[d], ps[d], t_new)
                # inactive slots stay inert and far away
                act = (active[d] > 0)[:, None]
                return FluidState(
                    pos=torch.where(act, pos, _FAR),
                    vel=torch.where(act, vel, 0.0),
                    predicted=torch.where(act, predicted, _FAR),
                    acc=acc[d], density=den[d], near_density=nden[d],
                    pressure=prs[d], near_pressure=nprs[d],
                    step_count=s.step_count + 1, time=t_new, overflow=ovf[d],
                    overflow_total=s.overflow_total
                    + ovf[d].to(torch.float32),
                    ids=s.ids)

            stepped = mesh.each(integrate)
            with profiling.span("wst.phase.migrate"):
                stepped, active, lost = _migrate(stepped, active, ps, cfg,
                                                 gx_loc, mesh, mig_cap)
            return stepped, active, mesh.psum(lost)[0]

    return domain_step


def make_domain_rollout(mesh: Mesh, cfg: SimConfig, mig_cap: int = 256,
                        use_pallas: bool | None = None,
                        rescue_cap: int = 256):
    """``rollout(states, active, params, num_steps) -> (states, active,
    lost_sum)``: ``num_steps`` domain steps, the migration losses summed
    on the device (the JAX package's ``lax.scan`` over the step). Each call
    steps a ``DomainGraph`` (``ops/cuda/graph.py``) over copies of its
    inputs: on a mesh whose shards share one CUDA device it warms up and
    captures, then replays one graph a step (keep a
    ``DistributedSimulation`` for repeated windows), on the kernels and
    on the plain pair-block path (``use_pallas=False``) alike. The graph
    forks into the shards' streams and joins them again, so the shards'
    kernels run concurrently within a replay; on a ``serial`` mesh they
    run one after another on one stream. Elsewhere it steps eagerly, on
    the same per-shard streams."""
    step = make_domain_step(mesh, cfg, mig_cap=mig_cap,
                            use_pallas=use_pallas, rescue_cap=rescue_cap)

    def rollout(states, active, params, num_steps: int):
        g = graph_mod.DomainGraph(
            step, [s.clone() for s in states], [a.clone() for a in active],
            _map_tensors(params, torch.clone), mesh)
        g.run(num_steps)
        return g.states, g.active, g.lost

    return rollout


def gather_dense(states, active) -> tuple:
    """Host-side: the active particles' (positions, velocities) as numpy
    arrays, in shard order."""
    act = np.concatenate([a.cpu().numpy() for a in active]) > 0
    pos = np.concatenate([s.pos.cpu().numpy() for s in states])
    vel = np.concatenate([s.vel.cpu().numpy() for s in states])
    return pos[act], vel[act]


def dense_by_id(states, active) -> tuple:
    """The active particles as one FluidState on shard 0's device, rows in
    id order (shard 0's scalars), and the shard that holds each row."""
    dev = states[0].pos.device
    act = torch.cat([a.to(dev) for a in active]) > 0

    def rows(per_shard):
        return torch.cat([x.to(dev) for x in per_shard])[act]
    order = torch.argsort(rows([s.ids for s in states]).long())
    fields = {}
    for f in dataclasses.fields(FluidState):
        x = getattr(states[0], f.name)
        fields[f.name] = x.clone() if x.dim() == 0 else rows(
            [getattr(s, f.name) for s in states])[order]
    shard = rows([torch.full(a.shape, d, device=a.device)
                  for d, a in enumerate(active)])[order]
    return FluidState(**fields), shard
