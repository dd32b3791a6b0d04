"""Incremental plane-resident bucket stepping — the counterpart of
``water_sandbox_tpu/ops/pallas/incremental.py``.

``rollout`` in the kernel pipeline with ``cfg.incremental_rebuild > 0``
keeps the particle state RESIDENT in the bucket planes across steps. One
step is ordered

    reinsert movers -> column state -> density kernel -> exact rescue
    -> force kernel -> integrate (all in the plane layout)

* The planes carry the (predicted, vel) rows; positions are derived as
  ``predicted - vel·lookahead``. One gather at step start reads every
  particle's rows from the carried planes, so plane and particle state
  cannot drift apart.
* Only particles whose cell changed against the FROZEN grid anchor
  (movers) are re-inserted: one stable sort keyed on
  ``moved ? new column : INT32_MAX`` groups them, and one scatter clears
  their old slots (``_FAR`` into plane 0 only) and writes their new rows.
  Rank 0 and 1 of a column take its first and second free slot (from
  per-column occupancy bitmasks), so holes are refilled within a step or
  two; higher ranks stack above the column's top.
* Slots fill with holes, so the kernels walk each lane to its ``top``
  (highest occupied slot + 1), not to its occupancy: ``top`` is the
  ``counts`` argument of ``run_density`` and ``run_force``. A hole holds
  ``_FAR`` in plane 0 and stale rows in the others; both kernels and their
  plain versions reject it by the distance test whatever the stale rows
  hold.
* A full rebuild (``build_cache``) replaces the re-inserted planes every
  ``cfg.incremental_rebuild`` steps, and whenever the mover budget
  overflows, the anchor drifts by more than 3/4 h from where a fresh build
  would put it, or the hole debt ``sum(top) - occupied`` passes n/2.
* A mover whose column is full is dropped (address ``cap_p·L``): the same
  step's rescue (the kernels of ``ops/cuda/rescue.py``, launched only on
  steps with dropped particles) computes it exactly, it integrates in
  particle order, and it retries insertion every step.
  ``state.overflow`` counts the dropped particles, rescued or not, as the
  JAX package does.
* Per-particle densities and accelerations are gathered only when
  ``materialize`` (the rollout's last step); earlier steps carry
  one-step-stale shadows, and the planes are the state.

The rebuild, the drop step (the rescue's density half before the force
kernel, its force half, the residents' patch and the dropped rows'
integration after it) and the materializing gather are branches decided on
the device, as JAX's ``lax.cond``s are (``incremental.py:308``, ``:355``,
``:385``, ``:401``, ``:437``): ``graph.device_if``. Under CUDA-graph
capture each is an IF conditional node, so the step reads nothing on the
host and ``rollout_inc`` (``graph.IncrementalGraph``) replays one captured
step a step; eagerly each predicate is read on the host once.

Pair sets equal the rebuild path's; only the slot order within a column
differs, so trajectories differ from it by float reassociation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.params import KernelCoeffs, SimConfig, SimParams, _map_tensors
from ...core.state import FluidState
from .. import grid, hashing, integrate as integrate_mod
from . import graph as graph_mod
from . import rescue as rescue_k
from . import sph_bucket as sb

_I32_MAX = torch.iinfo(torch.int32).max
_U32 = 0xFFFFFFFF


class BucketCache(NamedTuple):
    """Plane-resident bucket state carried across incremental steps."""
    planes: torch.Tensor  # (2·dim, cap_p, L) f32: predicted, vel rows
    addr: torch.Tensor    # (n,) i32: slot·L + PAD + col; cap_p·L = dropped
    origin: torch.Tensor  # (dim,) f32: grid anchor frozen at the last build
    ticks: torch.Tensor   # () i32: steps since the last full rebuild


def mover_budget(cfg: SimConfig) -> int:
    """Movers re-inserted a step before a rebuild is forced."""
    if cfg.mover_capacity > 0:
        return min(cfg.mover_capacity, cfg.n)
    return min(sb._round_up(max(4096, cfg.n // 4), 128), cfg.n)


def build_cache(predicted, vel, params: SimParams,
                cfg: SimConfig) -> BucketCache:
    """Full rebuild: fresh anchor, standard feature planes, addresses."""
    origin = hashing.grid_origin(predicted, params.smoothing_radius)
    planes, _, addr, _ = sb._build_slab_buckets(predicted, vel, params, cfg,
                                                origin=origin)
    return BucketCache(planes=planes, addr=addr, origin=origin,
                       ticks=torch.zeros((), dtype=torch.int32,
                                         device=predicted.device))


def _top_row(planes, cap_p: int):
    """(top (1, L) f32: per lane the highest occupied slot + 1, occupied
    slots () i64)."""
    occupied = planes[0] < 0.5 * sb._FAR
    slot_no = 1.0 + torch.arange(cap_p, dtype=torch.float32,
                                 device=planes.device)[:, None]
    top = torch.where(occupied, slot_no, 0.0).amax(dim=0)[None, :]
    return top, occupied.sum()


def _column_state(planes, cap_p: int):
    """(top (1, L) f32, occupancy bitmasks lo and hi (L,) — uint32 values
    held in int64, bit s of lo (s - 32 of hi) set when slot s is occupied —,
    occupied slots ()). Needs cap_p <= 64."""
    if cap_p > 64:
        raise ValueError(f"bitmask slot pick needs cell capacity <= 64; "
                         f"got padded capacity {cap_p}")
    top, occ_total = _top_row(planes, cap_p)
    occupied = (planes[0] < 0.5 * sb._FAR).to(torch.int64)
    s = torch.arange(cap_p, dtype=torch.int64, device=planes.device)[:, None]
    bit = torch.ones_like(s) << (s % 32)
    # distinct powers of two: the sum is the bitwise or
    lo = (occupied * torch.where(s < 32, bit, 0)).sum(dim=0)
    hi = (occupied * torch.where(s >= 32, bit, 0)).sum(dim=0)
    return top, lo, hi, occ_total


def _popcount32(v):
    """Set bits of uint32 values held in int64 (SWAR, exact)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _U32) >> 24


def _ctz32(x):
    """Trailing zeros of uint32 values held in int64, as int32; 32 for 0
    (the popcount of (x & -x) - 1, which is all ones for 0)."""
    return _popcount32(((x & -x) - 1) & _U32).to(torch.int32)


def _first_second_free(lo, hi):
    """(first, second) free slot per column from its occupancy bitmasks,
    int32 (>= 64: none)."""
    free_lo = ~lo & _U32
    free_hi = ~hi & _U32
    lo1 = _ctz32(free_lo)
    first = torch.where(lo1 < 32, lo1, 32 + _ctz32(free_hi))
    free_lo2 = free_lo & (free_lo - 1)
    free_hi2 = free_hi & (free_hi - 1)
    lo2 = _ctz32(free_lo2)
    second = torch.where(
        lo2 < 32, lo2,
        torch.where(lo1 < 32, 32 + _ctz32(free_hi), 32 + _ctz32(free_hi2)))
    return first, second


def _new_columns(predicted, origin, params: SimParams, cfg: SimConfig,
                 S_pad: int):
    """Slab-strided column key per particle against the frozen anchor (the
    build's derivation, ``sph_bucket._build_core``)."""
    dims = cfg.grid_dims
    # a true division, not a multiply by 1/h: keys must match the build's
    cell = torch.floor((predicted - origin)
                       / params.smoothing_radius).to(torch.int32)
    # clamped axis by axis with Python bounds, as the build: no
    # host-to-device copy, so the step runs under CUDA-graph capture
    ax = [torch.clamp(cell[:, a], 0, dims[a] - 1) for a in range(cfg.dim)]
    r = ax[1]
    if cfg.dim == 3:
        r = r * dims[2] + ax[2]
    return ax[0] * S_pad + r


def _scatter_dropping(flat, idx, vals):
    """``flat[idx] = vals`` on a copy of the 1-D ``flat``, where the index
    ``flat.numel()`` (and only it) may repeat and is dropped."""
    buf = torch.empty(flat.numel() + 1, dtype=flat.dtype, device=flat.device)
    buf[:-1] = flat
    buf[idx.long()] = vals
    return buf[:-1]


def _patch_acc(out_c, addr, dropped, acc) -> None:
    """The residents' accelerations ``acc`` (n, dim) into the force planes
    ``out_c`` (2 + dim, cap_p, L) at ``addr``, in place: one scatter on the
    flat planes, dropped rows sent to the one dropped index (JAX
    ``incremental.py:389-394``), so no mask index and no host read."""
    dim = acc.shape[1]
    PL = out_c.shape[1] * out_c.shape[2]
    idx = torch.cat([torch.where(dropped, (2 + dim) * PL,
                                 (2 + a) * PL + addr) for a in range(dim)])
    out_c.copy_(_scatter_dropping(out_c.reshape(-1), idx,
                                  acc.T.reshape(-1)).view(out_c.shape))


def read_state(state: FluidState, cache: BucketCache, params: SimParams,
               cfg: SimConfig):
    """(predicted, vel, pos) of every particle: ONE gather of the carried
    planes (bit-exact plane reads, positions derived); dropped particles'
    rows come from the state."""
    dim = cfg.dim
    PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    was_dropped = (cache.addr == PL)[:, None]
    rows = cache.planes.reshape(2 * dim, -1)[
        :, torch.clamp_max(cache.addr, PL - 1).long()]
    pred = torch.where(was_dropped, state.predicted, rows[:dim].T)
    vel = torch.where(was_dropped, state.vel, rows[dim:].T)
    pos = torch.where(was_dropped, state.pos,
                      pred - vel * params.lookahead)
    return pred, vel, pos


def reinsert(pred_c, vel_c, cache: BucketCache, params: SimParams,
             cfg: SimConfig):
    """Mover detection, hole-filling slot pick and the combined clear +
    insert scatter. Returns (planes_r, addr_r, movers () i64, top0, occupied
    slots ()), the last two of the planes BEFORE the scatter."""
    dim = cfg.dim
    g = sb._geometry(cfg)
    L, PAD = g.L, g.PAD
    cap_p = sb._cap_pad(cfg.cell_capacity)
    PL = cap_p * L
    n = pred_c.shape[0]
    dev = pred_c.device
    planes, addr, origin, _ = cache

    # movers against the frozen anchor; a dropped particle's old column
    # (cap_p·L % L - PAD = -PAD) matches none, so it always retries
    newcol = _new_columns(pred_c, origin, params, cfg, g.S_pad)
    moved = newcol != addr % L - PAD
    nm = moved.sum()
    M = mover_budget(cfg)
    # stable, as jax.lax.sort with num_keys=1: ties keep particle order
    skey, sidx = torch.sort(torch.where(moved, newcol, _I32_MAX), stable=True)
    mk, mid = skey[:M], sidx[:M]
    valid = mk < _I32_MAX

    # rank among this step's movers into the same column
    rank = grid.slots_in_runs(mk)

    # rank 0 takes the first free slot, rank 1 the second, rank >= 2 stacks
    # above both the column's top and its second free slot; new slots were
    # free before this step's clears, so no index repeats
    top0, occ_lo, occ_hi, occ_total = _column_state(planes, cap_p)
    lane = (PAD + torch.where(valid, mk, 0)).long()
    top_at = top0[0, lane].to(torch.int32)
    first_free, second_free = _first_second_free(occ_lo[lane], occ_hi[lane])
    slot = torch.where(
        rank == 0, first_free,
        torch.where(rank == 1, second_free,
                    torch.maximum(top_at, second_free + 1) + (rank - 2)))
    ok = valid & (slot < cfg.cell_capacity)
    newaddr = torch.where(ok, slot * L + PAD + mk * ok, PL)

    # one scatter on the flat planes: clears write _FAR into plane 0, inserts
    # all 2·dim rows; masked entries go to the one dropped index
    OOB = 2 * dim * PL
    oldaddr_m = addr[mid]
    clear_idx = torch.where(valid & (oldaddr_m < PL), oldaddr_m, OOB)
    rows_m = torch.cat([pred_c, vel_c], dim=1)[mid]          # (M, 2·dim)
    ins_idx = [torch.where(ok, a * PL + newaddr, OOB) for a in range(2 * dim)]
    all_idx = torch.cat([clear_idx] + ins_idx)
    all_val = torch.cat([torch.full((M,), sb._FAR, device=dev)]
                        + [rows_m[:, a] for a in range(2 * dim)])
    planes_r = _scatter_dropping(planes.reshape(-1), all_idx,
                                 all_val).view(planes.shape)
    addr_r = _scatter_dropping(addr, torch.where(valid, mid, n),
                               torch.where(ok, newaddr, PL).to(torch.int32))
    return planes_r, addr_r, nm, top0, occ_total


def step_inc(state: FluidState, cache: BucketCache, params: SimParams,
             cfg: SimConfig, materialize=False, branches=None):
    """One incremental step. Returns (state', cache').

    ``materialize`` (a bool, or a () bool tensor read on the device):
    gather the post-step per-particle state (positions, velocities,
    densities, accelerations) from the planes this step, as on the
    rollout's last step; otherwise residents keep one-step-stale shadows
    (see the module docstring). Reads nothing on the host but the
    branches' predicates (``graph.device_if``), and those only outside a
    capture. ``branches`` (``graph.Branches``) counts the runs of the
    branches "rebuild", "drop", "drop_force" and "materialize"; a capture
    needs it."""
    dim = cfg.dim
    h = params.smoothing_radius
    g = sb._geometry(cfg)
    cap_p = sb._cap_pad(cfg.cell_capacity)
    PL = cap_p * g.L
    n = state.n
    dev = state.pos.device
    coeffs = KernelCoeffs.from_radius(h, dim)
    params_vec = sb._param_vector(params, coeffs)
    look = params.lookahead

    pred_c, vel_c, pos_c = read_state(state, cache, params, cfg)
    planes_r, addr_r, nm, top0, occ_total = reinsert(pred_c, vel_c, cache,
                                                     params, cfg)

    # --- the rebuild replaces the re-inserted planes (JAX :308) ---
    drift = ((cache.origin - (pred_c.amin(dim=0) - h)).abs()
             > 0.75 * h).any()
    debt = top0.sum() - occ_total.to(torch.float32)
    k = max(cfg.incremental_rebuild, 1)
    rebuild = ((cache.ticks >= k) | (nm > mover_budget(cfg)) | drift
               | (debt > float(n // 2)))
    origin, ticks = cache.origin.clone(), cache.ticks.clone()

    def do_rebuild():
        fresh = build_cache(pred_c, vel_c, params, cfg)
        planes_r.copy_(fresh.planes)
        addr_r.copy_(fresh.addr)
        origin.copy_(fresh.origin)
        ticks.zero_()

    graph_mod.device_if(rebuild, do_rebuild, branches, "rebuild")

    # --- the kernels on the re-inserted planes, lanes walked to `top` ---
    dropped = addr_r == PL
    overflow = dropped.sum().to(torch.int32)
    drops = overflow > 0
    top, _ = _top_row(planes_r, cap_p)
    dens = sb.run_density(planes_r, top, addr_r, params_vec, cfg)

    # What the drop-step branch writes, preset to JAX's else branch
    # (:324-326, :400-403); `held` carries its selection from the density
    # half (before the force kernel) to the force half (after it). Both
    # halves take the one predicate, so both run or neither does.
    den_r = torch.zeros(n, device=dev)
    nden_r = torch.zeros(n, device=dev)
    rescued = torch.zeros(n, dtype=torch.bool, device=dev)
    pos_d, vel_d, pred_d = (torch.zeros((n, dim), device=dev)
                            for _ in range(3))
    held = {}
    rescue = cfg.rescue_capacity > 0

    def rescue_density():
        # the kernels read rows through raw pointers
        pred_k, vel_k = pred_c.contiguous(), vel_c.contiguous()
        # the cell order the rescue walks: the rows' keys against the
        # anchor the planes now use, sorted (only on steps that drop)
        col = _new_columns(pred_c, origin, params, cfg, g.S_pad)
        sorted_col, order = torch.sort(col, stable=True)
        den, nden, sel, slot, count, walk = sb.rescue_density_planes(
            dens, addr_r, dropped, overflow, pred_k, params, coeffs, cfg,
            params_vec, sorted_col, order.to(torch.int32))
        den_r.copy_(den)
        nden_r.copy_(nden)
        rescued.copy_((slot >= 0) & (slot < count))
        held.update(pred_k=pred_k, vel_k=vel_k, sel=sel, slot=slot,
                    count=count, walk=walk)

    if rescue:
        graph_mod.device_if(drops, rescue_density, branches, "drop")

    out_c = sb.run_force(planes_r, dens, top, addr_r, params_vec, cfg)
    t_new = state.time + params.dt

    def fix_dropped():
        # the dropped particles' exact forces, in particle order
        den, nden, acc = sb.gather_results(out_c, addr_r, dropped, params)
        if rescue:
            den = torch.where(rescued, den_r, den)
            nden = torch.where(rescued, nden_r, nden)
            acc = acc.contiguous()
            prs = params.pressure_scalar * (den - params.target_density)
            nprs = params.near_pressure_scalar * nden
            rescue_k.rescue_force(held["pred_k"], held["vel_k"], den, nden,
                                  prs, nprs, held["sel"], held["slot"],
                                  held["count"], acc, params, coeffs,
                                  params_vec, cfg, held["walk"])
            _patch_acc(out_c, addr_r, dropped, acc)
        # dropped particles integrate in particle order
        p, v, pr = integrate_mod.integrate(pos_c, vel_c, acc, params, t_new)
        pos_d.copy_(p)
        vel_d.copy_(v)
        pred_d.copy_(pr)

    graph_mod.device_if(drops, fix_dropped, branches, "drop_force")

    # --- integrate in the plane layout; holes go back to _FAR / 0 ---
    occupied = planes_r[0] < 0.5 * sb._FAR
    _, nv, npr = integrate_mod.integrate_axes(
        [planes_r[a] - planes_r[dim + a] * look for a in range(dim)],
        [planes_r[dim + a] for a in range(dim)],
        [out_c[2 + a] for a in range(dim)], params, t_new)
    newplanes = torch.stack(
        [torch.where(occupied, npr[a], sb._FAR) for a in range(dim)]
        + [torch.where(occupied, nv[a], 0.0) for a in range(dim)])

    # --- particle shadows: dropped stay current, residents refresh on
    # materialize (JAX :437); the step's own pred_c, vel_c, pos_c take the
    # gathered rows in place ---
    den_s, nden_s = state.density.clone(), state.near_density.clone()
    acc_s = state.acc.clone()

    def gather_state():
        den, nden, acc = sb.gather_results(out_c, addr_r, dropped, params)
        den_s.copy_(torch.where(rescued, den_r, den))
        nden_s.copy_(torch.where(rescued, nden_r, nden))
        acc_s.copy_(acc)
        rows2 = newplanes.reshape(2 * dim, -1)[
            :, torch.clamp_max(addr_r, PL - 1).long()]
        pred_c.copy_(rows2[:dim].T)
        vel_c.copy_(rows2[dim:].T)
        pos_c.copy_(pred_c - vel_c * look)

    graph_mod.device_if(materialize, gather_state, branches, "materialize")
    dc = dropped[:, None]
    pred_s = torch.where(dc, pred_d, pred_c)
    vel_s = torch.where(dc, vel_d, vel_c)
    pos_s = torch.where(dc, pos_d, pos_c)

    state_out = FluidState(
        pos=pos_s, vel=vel_s, predicted=pred_s, acc=acc_s,
        density=den_s, near_density=nden_s,
        pressure=params.pressure_scalar * (den_s - params.target_density),
        near_pressure=params.near_pressure_scalar * nden_s,
        step_count=state.step_count + 1, time=t_new, overflow=overflow,
        overflow_total=state.overflow_total + overflow.to(torch.float32),
        ids=state.ids)
    cache_out = BucketCache(planes=newplanes, addr=addr_r, origin=origin,
                            ticks=ticks + 1)
    return state_out, cache_out


def rollout_inc(state: FluidState, params: SimParams, cfg: SimConfig,
                num_steps: int) -> FluidState:
    """``num_steps`` incremental steps on copies of the caller's state and
    params (``graph.IncrementalGraph``: on CUDA, replays of one captured
    step). The cache is built on entry and dropped at exit (callers that
    run in chunks pay one rebuild a chunk); per-particle results are
    gathered on the last step only."""
    g = graph_mod.IncrementalGraph(state.clone(),
                                   _map_tensors(params, torch.clone), cfg)
    g.run(num_steps)
    return g.state
