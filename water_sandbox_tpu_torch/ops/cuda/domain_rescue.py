"""The domain step's cross-shard overflow rescue as two kernels
(``csrc/sph_domain_rescue.cu``): D1, the density half, and D2, the force
half — the counterpart of ``water_sandbox_tpu/parallel/domain.py::
_rescue_density_common`` and ``_rescue_force_common`` under the JAX domain
step's ``lax.cond`` on ``pmax(overflow) > 0``.

A launch works on one shard. Its query rows (``Queries``) are the shard's
first R dropped rows in row order and the R rows each neighbour sent
(``parallel/domain.py`` packs and exchanges them); ``Queries.count``, the
valid rows among the 3R, is the device scalar both kernels gate on, so the
step launches them on every step and reads nothing on the host. The walk
(``Rows``) is the shard build's sorted keys and order
(``sph_bucket.build_local_slab_buckets``); the query rows' columns, sorted,
come from ``query_walk``.

Each wrapper runs its plain version (``density_plain`` / ``force_plain``:
the JAX package's all-pairs sweeps, selected by the gate with
``torch.where``) for CPU tensors and launches its kernel for CUDA tensors —
there is no fallback between the two — through ``_build.launch``, which
counts. The sweeps (``density_sums``, ``force_sums``) also serve the
plain pair-block path of the domain step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from .. import kernels
from ..rescue import _chunks
from . import _build
from . import sph_bucket as sb

_FAR = sb._FAR

# The column of an invalid query row: above every column and its reach, so
# it sorts last and lies in no run (csrc/sph_domain_rescue.cu::kNoCol).
NO_COL = 1 << 30

# Blocks of part (a) at most, striding a shard's R rows (R <= 256 on the
# domain step's default).
_BLOCKS_A = 1024


class Rows(NamedTuple):
    """A shard's rows in the build's column order."""
    skey: torch.Tensor    # (P,) i32 clamped local columns, ascending;
    #                       inactive rows gx_loc·S_pad, last
    order: torch.Tensor   # (P,) i32 the row at each position


class Queries(NamedTuple):
    """A shard's rescue queries: rows [0, R) its own first R dropped rows,
    [R, 2R) the left neighbour's, [2R, 3R) the right one's."""
    pos: torch.Tensor     # (3R, dim) f32, _FAR where invalid
    vel: torch.Tensor     # (3R, dim) f32
    valid: torch.Tensor   # (3R,) bool
    row: torch.Tensor     # (R,) i32 the local rows of its own
    col: torch.Tensor     # (3R,) i32 clamped local columns, NO_COL invalid
    scol: torch.Tensor    # (3R,) i32 the columns ascending
    qord: torch.Tensor    # (3R,) i32 the query row at each of them
    count: torch.Tensor   # () i32 valid rows: the kernels' gate


def query_walk(pos, valid, origin, gx_loc: int, my_dev: int, params,
               cfg_loc: SimConfig):
    """The query rows' columns by the build's own clamped key (NO_COL where
    invalid) and the list in column order: (col, scol, qord), one stable
    sort of 3R keys on the device."""
    col = torch.where(valid, sb.local_columns(pos, origin, gx_loc, my_dev,
                                              params, cfg_loc), NO_COL)
    scol, qord = torch.sort(col, stable=True)
    return col, scol, qord.to(torch.int32)


def force_rows(q: Queries, den, nden, params: SimParams) -> torch.Tensor:
    """D2's query rows (3R, 2·dim + 4) f32: pos, vel, den, nden and the EOS
    pressures, with the JAX package's fills where invalid (_FAR, den 1,
    pressures 0). ``den``/``nden`` (3R,): the rows' densities from D1."""
    v = q.valid
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    cols = [torch.where(v, x, fill) for x, fill in (
        (den, 1.0), (nden, 1.0), (prs, 0.0), (nprs, 0.0))]
    return torch.cat([torch.where(v[:, None], q.pos, _FAR), q.vel,
                      torch.stack(cols, dim=1)], dim=1).contiguous()


# ---------------------------------------------------------- the sweeps --

def halo_pseudo(planes, g: sb.Geom):
    """The two halo-slab regions of (F, cap, L) planes as (F, 2·cap·S_pad)
    pseudo-particle feature rows (empty slots _FAR in position planes)."""
    F = planes.shape[0]
    lo = planes[:, :, g.PAD - g.S_pad:g.PAD]
    hi = planes[:, :, g.PAD + g.gx * g.S_pad:g.PAD + (g.gx + 1) * g.S_pad]
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
    up = kernels.up_direction(dim, q["pos"].dtype, dev)
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


def density_sums(qpos, qvalid, R: int, local_pos, halo_pos,
                 params: SimParams, coeffs: KernelCoeffs, chunk: int):
    """The density rescue's sweeps on one shard: the 3R query rows against
    the shard's rows ``local_pos`` (_FAR where inactive), and its own R
    rows against the halo pseudo-particles and the neighbours' rows.
    Returns (my_den, my_nden) (R,) with DENSITY_PADDING, and every row's
    gain from the query rows (cw, cwn) (P,)."""
    opos_all = torch.where(qvalid[:, None], qpos, _FAR)
    den_all, nden_all, (cw, cwn) = _density_sweep(
        opos_all, [local_pos], params, coeffs, chunk, want_corrections=True)
    # its own rows also see the halo pseudo-particles and the neighbours'
    # dropped rows (absent from the halo planes by definition)
    den_h, nden_h, _ = _density_sweep(
        opos_all[:R], [halo_pos, opos_all[R:2 * R], opos_all[2 * R:]],
        params, coeffs, chunk)
    return (den_all[:R] + den_h + DENSITY_PADDING,
            nden_all[:R] + nden_h + DENSITY_PADDING, cw, cwn)


def force_sums(q_all: dict, R: int, locals_grp: dict, halo_grp: dict,
               params: SimParams, coeffs: KernelCoeffs, chunk: int):
    """The force rescue's sweeps on one shard (dicts of rows as
    ``_force_sweep`` takes them): the 3R query rows against the shard's
    rows, and its own R rows against the halo pseudo-particles and the
    neighbours' rows. Returns the own rows' accelerations (R, dim) and
    every row's correction (P, dim)."""
    pf_all, vf_all, (pf_j, vf_j) = _force_sweep(
        q_all, [locals_grp], params, coeffs, chunk, want_corrections=True)
    part = [{k: v[s] for k, v in q_all.items()}
            for s in (slice(0, R), slice(R, 2 * R), slice(2 * R, None))]
    pf_h, vf_h, _ = _force_sweep(part[0], [halo_grp] + part[1:], params,
                                 coeffs, chunk)
    acc_o = ((pf_all[:R] + pf_h) / q_all["den"][:R, None]
             + params.viscosity_strength * (vf_all[:R] + vf_h))
    acc_corr = (pf_j / locals_grp["den"][:, None]
                + params.viscosity_strength * vf_j)
    return acc_o, acc_corr


# ------------------------------------------------------------ wrappers --

def _check_inputs(tensors, n: int, q: Queries, walk: Rows):
    """dtypes, shapes, contiguity and one device of what the kernels read
    through raw pointers; ``tensors`` maps a name to (tensor, dtype,
    shape)."""
    nq, R = q.col.shape[0], q.row.shape[0]
    if nq != 3 * R or R == 0:
        raise ValueError(f"{nq} query rows for R = {R}")
    checks = dict(tensors)
    checks.update({
        "walk.skey": (walk.skey, torch.int32, (n,)),
        "walk.order": (walk.order, torch.int32, (n,)),
        "q.row": (q.row, torch.int32, (R,)),
        "q.col": (q.col, torch.int32, (nq,)),
        "q.scol": (q.scol, torch.int32, (nq,)),
        "q.qord": (q.qord, torch.int32, (nq,)),
        "q.count": (q.count, torch.int32, ())})
    dev = walk.skey.device
    for name, (t, dtype, shape) in checks.items():
        sb._check(t, name, dtype, shape)
        if t.device != dev:
            raise ValueError("kernel inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _geometry_args(cfg_loc: SimConfig, R: int) -> tuple:
    g = sb._geometry(cfg_loc)
    return (cfg_loc.dim, sb._cap_pad(cfg_loc.cell_capacity), g.L, g.PAD,
            g.S_pad, g.gx, g.gy, g.gz, min(R, _BLOCKS_A))


def _stream(t: torch.Tensor) -> tuple:
    return (t.device.index or 0,
            torch.cuda.current_stream(t.device).cuda_stream)


def rescue_density(pred, walk: Rows, addr, q: Queries, feats, dens, qden,
                   qnden, params: SimParams, coeffs: KernelCoeffs,
                   params_vec, cfg_loc: SimConfig) -> None:
    """D1 in place on one shard: its own valid query rows' exact sums into
    ``qden``/``qnden`` (R,), the residents' gain from every valid query
    row into their six rows of the density planes ``dens`` (6, cap_p, L)
    at ``addr``. ``feats``: the halo-filled (2·dim, cap_p, L) planes.
    Nothing changes when ``q.count`` is 0. Plain version on the CPU,
    kernel on CUDA."""
    n, dim = pred.shape
    R = q.row.shape[0]
    cap_p = sb._cap_pad(cfg_loc.cell_capacity)
    L = sb._geometry(cfg_loc).L
    _check_inputs({"pred": (pred, torch.float32, (n, dim)),
                   "addr": (addr, torch.int32, (n,)),
                   "q.pos": (q.pos, torch.float32, (3 * R, dim)),
                   "feats": (feats, torch.float32, (2 * dim, cap_p, L)),
                   "dens": (dens, torch.float32, (6, cap_p, L)),
                   "qden": (qden, torch.float32, (R,)),
                   "qnden": (qnden, torch.float32, (R,)),
                   "params_vec": (params_vec, torch.float32, (1, 16))},
                  n, q, walk)
    if pred.device.type == "cpu":
        density_plain(pred, walk, addr, q, feats, dens, qden, qnden, params,
                      coeffs, cfg_loc)
        return
    _build.launch(
        "sph_domain_rescue_density", pred.data_ptr(), n,
        walk.skey.data_ptr(), walk.order.data_ptr(), addr.data_ptr(),
        q.pos.data_ptr(), q.col.data_ptr(), q.scol.data_ptr(),
        q.qord.data_ptr(), 3 * R, R, feats.data_ptr(),
        q.count.data_ptr(), params_vec.data_ptr(), dens.data_ptr(),
        qden.data_ptr(), qnden.data_ptr(), *_geometry_args(cfg_loc, R),
        *_stream(pred))


def active_rows(walk: Rows, cfg_loc: SimConfig) -> torch.Tensor:
    """(P,) bool: the rows the walk holds, the shard's active rows."""
    g = sb._geometry(cfg_loc)
    act = torch.empty(walk.skey.shape[0], dtype=torch.bool,
                      device=walk.skey.device)
    act[walk.order.long()] = walk.skey < g.gx * g.S_pad
    return act


def density_plain(pred, walk: Rows, addr, q: Queries, feats, dens, qden,
                  qnden, params: SimParams, coeffs: KernelCoeffs,
                  cfg_loc: SimConfig) -> None:
    """Plain PyTorch version of D1, in place and sync-free: the JAX
    package's all-pairs sweeps, then every resident's derived rows
    written back at its address, all selected by the gate."""
    R = q.row.shape[0]
    g = sb._geometry(cfg_loc)
    flat = dens.view(6, -1)
    PL = flat.shape[1]
    local_pos = torch.where(active_rows(walk, cfg_loc)[:, None], pred, _FAR)
    halo_pos = halo_pseudo(feats[:cfg_loc.dim], g).T
    my_den, my_nden, cw, cwn = density_sums(
        q.pos, q.valid, R, local_pos, halo_pos, params, coeffs,
        cfg_loc.chunk)
    on = q.count > 0
    mine = on & q.valid[:R]
    qden.copy_(torch.where(mine, my_den, qden))
    qnden.copy_(torch.where(mine, my_nden, qnden))
    # a row without an address reads and rewrites the last element, a dead
    # pad lane that no row addresses
    safe = torch.clamp_max(addr, PL - 1).long()
    write = on & (addr < PL)
    flat[:, safe] = torch.where(write, sb.derived_density_planes(
        flat[0, safe] + cw, flat[1, safe] + cwn, params), flat[:, safe])


def rescue_force(pred, vel, den, nden, prs, nprs, walk: Rows, slot,
                 q: Queries, qf, feats, dens, acc, params: SimParams,
                 coeffs: KernelCoeffs, params_vec,
                 cfg_loc: SimConfig) -> None:
    """D2 in place on one shard's ``acc`` (P, dim): its own valid query
    rows take their exact accelerations, residents add the pair forces of
    every valid query row. ``den``..``nprs`` (P,): the rows' corrected
    densities and EOS pressures; ``slot`` (P,) i32: a dropped row's rank
    (``ops/rescue.py::rescue_selection``), -1 otherwise; ``qf``: the query
    rows of ``force_rows``; ``dens``: the exchanged density planes.
    Nothing changes when ``q.count`` is 0. Plain version on the CPU, kernel
    on CUDA."""
    n, dim = pred.shape
    R = q.row.shape[0]
    cap_p = sb._cap_pad(cfg_loc.cell_capacity)
    L = sb._geometry(cfg_loc).L
    rows = {name: (t, torch.float32, (n,)) for name, t in (
        ("den", den), ("nden", nden), ("prs", prs), ("nprs", nprs))}
    rows.update({"pred": (pred, torch.float32, (n, dim)),
                 "vel": (vel, torch.float32, (n, dim)),
                 "acc": (acc, torch.float32, (n, dim)),
                 "slot": (slot, torch.int32, (n,)),
                 "qf": (qf, torch.float32, (3 * R, 2 * dim + 4)),
                 "feats": (feats, torch.float32, (2 * dim, cap_p, L)),
                 "dens": (dens, torch.float32, (6, cap_p, L)),
                 "params_vec": (params_vec, torch.float32, (1, 16))})
    _check_inputs(rows, n, q, walk)
    if pred.device.type == "cpu":
        force_plain(pred, vel, den, nden, prs, nprs, walk, slot, q, qf,
                    feats, dens, acc, params, coeffs, cfg_loc)
        return
    _build.launch(
        "sph_domain_rescue_force", pred.data_ptr(), vel.data_ptr(),
        den.data_ptr(), nden.data_ptr(), prs.data_ptr(), nprs.data_ptr(),
        n, walk.skey.data_ptr(), walk.order.data_ptr(), slot.data_ptr(),
        qf.data_ptr(), q.row.data_ptr(), q.col.data_ptr(),
        q.scol.data_ptr(), q.qord.data_ptr(), 3 * R, R,
        feats.data_ptr(), dens.data_ptr(), q.count.data_ptr(),
        params_vec.data_ptr(), acc.data_ptr(),
        *_geometry_args(cfg_loc, R), *_stream(pred))


def force_plain(pred, vel, den, nden, prs, nprs, walk: Rows, slot,
                q: Queries, qf, feats, dens, acc, params: SimParams,
                coeffs: KernelCoeffs, cfg_loc: SimConfig) -> None:
    """Plain PyTorch version of D2, in place and sync-free: the JAX
    package's all-pairs sweeps, selected by the gate."""
    dim = cfg_loc.dim
    g = sb._geometry(cfg_loc)
    hp = halo_pseudo(feats, g)
    hd = halo_pseudo(dens[:2], g)
    # empty halo slots hold no density (the kernel leaves them unwritten):
    # a finite fill keeps the sweep's masked terms 0
    occ = hp[0] < _FAR * 0.5
    halo_grp = halo_group(hp[:dim].T, hp[dim:].T, torch.where(occ, hd[0], 1.0),
                          torch.where(occ, hd[1], 1.0), params)
    act = active_rows(walk, cfg_loc)
    new = rescued_forces(acc, pred, vel, den, nden, prs, nprs, act, slot, q,
                         qf, halo_grp, params, coeffs, cfg_loc.chunk)
    acc.copy_(torch.where(q.count > 0, new, acc))


def halo_group(pos, vel, den, nden, params: SimParams) -> dict:
    """The halo pseudo-particles (Hn rows) as a candidate group of
    ``_force_sweep``: EOS pressures from their densities, safe divisors,
    id -1."""
    return {"pos": pos, "vel": vel,
            "den": torch.where(den > 0, den, 1.0),
            "nden": torch.where(nden > 0, nden, 1.0),
            "prs": params.pressure_scalar * (den - params.target_density),
            "nprs": params.near_pressure_scalar * nden,
            "id": torch.full((pos.shape[0],), -1, dtype=torch.long,
                             device=pos.device)}


def rescued_forces(acc, pred, vel, den, nden, prs, nprs, act, slot,
                   q: Queries, qf, halo_grp: dict, params: SimParams,
                   coeffs: KernelCoeffs, chunk: int):
    """``acc`` (P, dim) with the force rescue's sums (``force_sums``): the
    rescued rows take their accelerations, the residents (``act``, not
    dropped) add their corrections, every other row keeps its value."""
    n = pred.shape[0]
    R = q.row.shape[0]
    iota = torch.arange(n, device=pred.device)
    locals_grp = {
        "pos": torch.where(act[:, None], pred, _FAR), "vel": vel,
        "den": torch.where(den > 0, den, 1.0),
        "nden": torch.where(nden > 0, nden, 1.0),
        "prs": prs, "nprs": nprs,
        # beyond-budget rows carry fill densities: out of the physics this
        # step (counted)
        "id": torch.where(act, torch.where(slot >= R, -3, iota), -2)}
    ids = torch.full((3 * R,), -1, dtype=iota.dtype, device=pred.device)
    ids[:R] = torch.where(q.valid[:R], q.row.long(), -1)
    dim = pred.shape[1]
    q_all = {"pos": qf[:, :dim], "vel": qf[:, dim:2 * dim],
             "den": qf[:, 2 * dim], "nden": qf[:, 2 * dim + 1],
             "prs": qf[:, 2 * dim + 2], "nprs": qf[:, 2 * dim + 3],
             "id": ids}
    acc_o, acc_corr = force_sums(q_all, R, locals_grp, halo_grp, params,
                                 coeffs, chunk)
    at = torch.clamp(slot, 0, R - 1).long()
    return torch.where(((slot >= 0) & (slot < R))[:, None], acc_o[at],
                       torch.where((act & (slot < 0))[:, None],
                                   acc + acc_corr, acc))
