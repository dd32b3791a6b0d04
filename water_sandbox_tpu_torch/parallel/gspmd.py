"""Multi-device stepping with the cell grid split into x slabs — the
counterpart of ``water_sandbox_tpu/parallel/gspmd.py``.

The JAX module runs the ``bucket_grid`` step with its flat cell axis
sharded over a 1-D mesh and lets XLA's SPMD partitioner insert the
collectives (the ``constrain`` hook of its ``ops/grid.py::bucket_sph``).
torch has no such partitioner, so this module writes out the program the
partitioner makes of that step, whose collectives the JAX package pins
(``tests/test_parallel.py::test_gspmd_lowers_rolls_to_collective_permute``,
``benchmarks/gspmd_lowering_results.json``: the rolls as halo
collective-permutes between mesh neighbours, all-gathers of at most one
(cap, num_cells) plane, a few all-reduces), over the port's ``Mesh``
(``parallel/mesh.py``). A state is sharded on the particle axis: shard d
holds rows [d·m, (d+1)·m), m = n / mesh.size, and the scalars. Each step:

1. Keys and origin. Each shard computes its rows' cell keys; the grid
   origin is the minimum over the mesh (an all-reduce), so every key has
   the single-device bits.
2. Rows to their slab. An all-to-all sends each row to the shard that owns
   its cell's x slab (``gx / mesh.size`` layers). The row count a source
   sends to a slab is known only on the device, so a block holds all of
   its source's rows and the receiver keeps its slab's: every shard sees
   the rows in global row order, and its stable sort by cell id ranks ties
   by global row, so its planes are the x slab of the single-device
   ``build_bucket_grid``, bit for bit.
3. Halos. Each shard takes the cells within the largest flat neighbour
   shift (``S + gz + 1`` in 3-D, S the cells of a slab) from both
   neighbours (``shift_left`` / ``shift_right``), once for the density
   pass's planes and once for the force pass's, and the passes walk its
   occupied cells over the 3^dim static shifts of ``_roll_shifts``. The
   halos hold what the flat roll holds: the first and last shards' outer
   halos hold the wrap from the other end of the grid, and a halo wider
   than a slab holds the empty fill beyond it. Both are at least a cell
   away on some axis, and the distance test drops them.
4. The rescue. R1 and R2 (``ops/cuda/rescue.py``) run over all rows on
   shard 0's device: each slab's rows, in its sorted order, go there (the
   slabs' sorted keys concatenated in shard order are already the global
   cell order, so no global sort runs), R1 corrects the densities, which
   go back to the slabs before the force pass, and R2 adds the pair forces
   of the rescued rows. The rescued set is the first ``rescue_capacity``
   dropped rows in global row order, as in JAX.
5. Results home. Per-row results go from shard 0 to their home shards,
   and each shard integrates its own rows.

Each shard's part of every phase runs under its scope of the mesh
(``Mesh.each``), on its own CUDA stream, so the slabs' passes run
concurrently on one card, as JAX's run on their own devices; shard 0's
stream runs the rescue, and the collectives are the only place where one
shard's stream waits on another's. The step reads nothing on the host, so
``make_sharded_rollout`` replays it as one captured CUDA graph, forking
into the shards' streams and joining them again, when every shard sits on
one card (``ops/cuda/graph.py::ShardedGraph``); a mesh over several
devices, and the CPU, step eagerly into the same buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.params import (DENSITY_PADDING, KernelCoeffs, SimConfig,
                           SimParams, _map_tensors)
from ..core.state import FluidState
from ..ops import grid as grid_mod, hashing, integrate as integrate_mod
from ..ops.cuda import graph as graph_mod
from .domain import _per_shard, _split
from .mesh import Mesh

_FAR = grid_mod._FAR


def shard_state(state: FluidState, mesh: Mesh) -> list[FluidState]:
    """The state's particle arrays split into ``mesh.size`` equal row
    chunks, chunk d copied to ``mesh.devices[d]``, the scalars on every
    shard. Raises ValueError when the rows do not split evenly, as JAX's
    ``device_put`` of a particle-axis NamedSharding does."""
    n, size = state.n, mesh.size
    if n % size:
        raise ValueError(f"{n} particles are not divisible by the mesh "
                         f"size {size}")
    m = n // size

    def place(d):
        dev = mesh.devices[d]
        return FluidState(**{
            f.name: (x if x.dim() == 0 else x[d * m:(d + 1) * m]).to(
                dev, copy=True)
            for f in dataclasses.fields(FluidState)
            for x in (getattr(state, f.name),)})

    return [place(d) for d in range(size)]


def unshard_state(states: list[FluidState]) -> FluidState:
    """The sharded state as one state on shard 0's device (the rows in
    shard order, the scalars of shard 0): what JAX's global array of the
    sharded state holds."""
    dev = states[0].device
    fields = {}
    for f in dataclasses.fields(FluidState):
        xs = [getattr(s, f.name) for s in states]
        fields[f.name] = (xs[0].clone() if xs[0].dim() == 0 else
                          torch.cat([x.to(dev) for x in xs]))
    return FluidState(**fields)


def _checked(mesh: Mesh, cfg: SimConfig) -> SimConfig:
    cfg = cfg.resolved()
    if cfg.grid_dims and cfg.grid_dims[0] % mesh.size != 0:
        raise ValueError(
            f"grid_dims[0]={cfg.grid_dims[0]} not divisible by mesh size "
            f"{mesh.size}")
    if cfg.neighbor_mode != "bucket_grid":
        raise ValueError(
            f"the cell-slab-sharded step runs neighbor_mode 'bucket_grid', "
            f"not {cfg.neighbor_mode!r} (the JAX step ignores the sharding "
            "hook in the other modes)")
    return cfg


def _with_halo(mesh: Mesh, planes: list[torch.Tensor], H: int,
               fill: list[float]) -> list[torch.Tensor]:
    """Each shard's (F, C, nc_loc) planes as (F, C, H + nc_loc + H): the
    left neighbour's last H cells, its own, the right neighbour's first H
    cells (two shifts that carry boundary cells only, wrapping at the
    ends as the flat roll does). Where H exceeds a slab, the cells beyond
    the neighbour's slab hold ``fill``, a value a feature."""
    nc_loc = planes[0].shape[-1]
    h = min(H, nc_loc)
    from_left = mesh.shift_right([p[..., nc_loc - h:] for p in planes])
    from_right = mesh.shift_left([p[..., :h] for p in planes])

    def extend(d):
        p, left, right = planes[d], from_left[d], from_right[d]
        if h < H:
            pad = torch.empty(p.shape[:-1] + (H - h,), dtype=p.dtype,
                              device=p.device)
            for f, v in enumerate(fill):
                pad[f].fill_(v)
            left, right = torch.cat([pad, left], -1), torch.cat([right, pad],
                                                                -1)
        return torch.cat([left, p, right], dim=-1)

    return mesh.each(extend)


def _to_shard0(mesh: Mesh, packs: list[torch.Tensor]) -> torch.Tensor:
    """The shards' (n, F) packs on shard 0, (size, n, F): an all-to-all
    whose blocks for the other shards are empty."""
    empty = [p[:0] for p in packs]
    got = mesh.all_to_all([[p] + empty[s:s + 1] * (mesh.size - 1)
                           for s, p in enumerate(packs)])[0]
    return got.view(mesh.size, packs[0].shape[0], -1)


def _by_owner(got: torch.Tensor, owner: torch.Tensor) -> torch.Tensor:
    """(n, F): row r of the pack of shard ``owner[r]`` (``_to_shard0``)."""
    rows = torch.arange(got.shape[1], device=got.device)
    return got[owner.long(), rows]


class Slabs(NamedTuple):
    """Every shard's slab after the rows went to their slabs (steps 1-2):
    per-shard lists. ``pred``, ``vel`` (n, dim) and ``cid`` (n,) i32 hold
    every row in global row order, ``mine`` (n,) bool the rows of the
    shard's slab; ``grids`` the slab's bucket planes (``ops/grid.py``'s
    ``BucketGrid``, cells [d·nc_loc, (d+1)·nc_loc) of the global grid;
    ``addr`` local, cap·nc_loc for the rows of other slabs and the dropped
    rows; ``overflow`` the slab's dropped rows); ``sorted_key`` and
    ``order`` (n,) i32 its stable sort by local cell id, its rows first."""
    pred: list
    vel: list
    cid: list
    mine: list
    grids: list
    sorted_key: list
    order: list


def build_slabs(mesh: Mesh, cfg: SimConfig, states: list[FluidState],
                params: list[SimParams]) -> Slabs:
    """Steps 1-2 of the sharded step: the cell keys against the origin
    reduced over the mesh, every row to the shard of its slab, each slab's
    bucket build. ``params`` a SimParams a shard. Slab d's planes are
    cells [d·nc_loc, (d+1)·nc_loc) of ``ops/grid.py::build_bucket_grid``
    over the unsharded rows, bit for bit."""
    size, dim, dims = mesh.size, cfg.dim, cfg.grid_dims
    nc_loc = dims[0] // size * math.prod(dims[1:])

    def keys(d):
        k = hashing.key_coords(states[d].predicted, params[d], cfg,
                               states[d].time)
        return k, k.amin(dim=0)

    def slab(d):
        g = got[d]
        pred, vel = g[:, :dim], g[:, dim:2 * dim]
        c = g[:, 2 * dim].contiguous().view(torch.int32)
        mine = c // nc_loc == d
        pos, vl, mask, addr, kept, skey, order = grid_mod._scatter_buckets(
            c - d * nc_loc, mine.to(torch.float32), pred, vel,
            cfg.cell_capacity, nc_loc)
        return (pred, vel, c, mine, grid_mod.BucketGrid(
            cell_pos=pos, cell_vel=vl, cell_mask=mask, addr=addr,
            origin=low[d] - params[d].smoothing_radius,
            overflow=(mine.sum() - kept).to(torch.int32)), skey, order)

    with mesh.step():
        kpred, kmin = _split(mesh.each(keys))
        low = mesh.pmin(kmin)

        def rows(d):
            p = params[d]
            c = hashing.bounded_cell_ids(kpred[d], p.smoothing_radius,
                                         low[d] - p.smoothing_radius,
                                         dims)[1]
            # a block holds all of its source's rows; the receiver keeps
            # its slab's
            return torch.cat([states[d].predicted, states[d].vel,
                              c.view(torch.float32)[:, None]], dim=1)

        got = mesh.all_to_all([[r] * size for r in mesh.each(rows)])
        return Slabs(*_split(mesh.each(slab)))


def make_sharded_step(mesh: Mesh, cfg: SimConfig):
    """The cell-slab-sharded ``bucket_grid`` step: ``step(states, params)
    -> states``, ``states`` a list of per-shard states (``shard_state``).
    Raises ValueError when ``grid_dims[0]`` does not divide by the mesh
    size or the mode is not ``bucket_grid``. ``cfg.sorted_state`` is
    ignored, as JAX's step ignores it under the sharding hook: rows keep
    their order."""
    cfg = _checked(mesh, cfg)
    size, dim, dims = mesh.size, cfg.dim, cfg.grid_dims
    cap = cfg.cell_capacity
    nc_loc = dims[0] // size * math.prod(dims[1:])
    H = max(abs(s) for s in grid_mod._roll_shifts(dims))
    rescue = cfg.rescue_capacity > 0

    def sharded_step(states: list[FluidState], params: SimParams):
        with mesh.step():
            return step_body(states, params)

    def step_body(states, params):
        ps = _per_shard(params, mesh)
        coeffs = mesh.each(lambda d: KernelCoeffs.from_radius(
            ps[d].smoothing_radius, dim))
        m = states[0].n
        n = m * size

        # 1-2. keys, origin, every row to the shard of its slab
        sl = build_slabs(mesh, cfg, states, ps)
        pred, vel, gcid, mine = sl.pred, sl.vel, sl.cid, sl.mine
        addr = [g.addr for g in sl.grids]
        overflow = mesh.psum([g.overflow for g in sl.grids])

        # 3. density over each slab's occupied cells, halos from both
        # neighbours
        pm = _with_halo(mesh, mesh.each(lambda d: torch.cat([
            sl.grids[d].cell_pos, sl.grids[d].cell_mask[None]])), H,
            [_FAR] * dim + [0.0])
        local = slice(H, H + nc_loc)

        def density(d):
            query = grid_mod._occupied_cells(pm[d][dim], min(n, nc_loc), H,
                                             H + nc_loc)
            g = grid_mod.BucketGrid(cell_pos=pm[d][:dim], cell_vel=None,
                                    cell_mask=pm[d][dim], addr=None,
                                    origin=None, overflow=overflow[d])
            return query, [x[:, local] for x in grid_mod.bucket_density_pass(
                g, ps[d], coeffs[d], cfg, query)]

        query, dens = _split(mesh.each(density))

        # 4a. the rescue's density half on shard 0 over all rows
        p0, c0 = ps[0], coeffs[0]
        with mesh.shard(0):
            owner = gcid[0] // nc_loc
        unrescued = overflow
        if rescue:
            def pack(d):
                den_d = grid_mod._from_cells(dens[d][0], addr[d],
                                             ps[d].target_density)
                nden_d = grid_mod._from_cells(dens[d][1], addr[d],
                                              DENSITY_PADDING)
                dropped_d = (addr[d] == cap * nc_loc) & mine[d]
                return torch.stack([
                    den_d, nden_d, dropped_d.to(torch.float32),
                    (sl.sorted_key[d] + d * nc_loc).view(torch.float32),
                    sl.order[d].view(torch.float32)], dim=1)

            got0 = _to_shard0(mesh, mesh.each(pack))
            with mesh.shard(0):
                per_row = _by_owner(got0[:, :, :3], owner)
                den = per_row[:, 0].contiguous()
                nden = per_row[:, 1].contiguous()
                dropped = per_row[:, 2] > 0
                scol, order = _global_sort(got0[:, :, 3:], owner)
                pred0 = pred[0].contiguous()
                vel0 = vel[0].contiguous()
                r = grid_mod.rescue_density(pred0, dropped, overflow[0], den,
                                            nden, scol, order, p0, c0, cfg)
                corrected0 = torch.stack([den, nden], dim=1)
            unrescued = mesh.each(lambda d: overflow[d] - torch.clamp_max(
                overflow[d], r.sel.shape[0]))
            # the corrected densities to every slab, before its force pass
            corrected = mesh.all_gather(mesh.each(lambda d: torch.zeros(
                (0, 2), device=mesh.devices[d]) if d else corrected0))

            def correct(d):
                den_c = grid_mod._to_cells(dens[d][0], addr[d],
                                           corrected[d][:, 0])
                nden_c = grid_mod._to_cells(dens[d][1], addr[d],
                                            corrected[d][:, 1])
                return [den_c, nden_c,
                        ps[d].pressure_scalar
                        * (den_c - ps[d].target_density),
                        ps[d].near_pressure_scalar * nden_c]

            dens = mesh.each(correct)

        # 3b. force over each slab's occupied cells
        fx = _with_halo(mesh, mesh.each(lambda d: torch.cat([
            sl.grids[d].cell_vel, torch.stack(dens[d])])), H,
            [0.0] * (dim + 4))

        def force(d):
            g = grid_mod.BucketGrid(cell_pos=pm[d][:dim],
                                    cell_vel=fx[d][:dim],
                                    cell_mask=pm[d][dim], addr=None,
                                    origin=None, overflow=overflow[d])
            acc_c = grid_mod.bucket_force_pass(g, *fx[d][dim:], ps[d],
                                               coeffs[d], cfg, query[d])
            acc_d = grid_mod._from_cells(acc_c[:, :, local], addr[d], 0.0)
            if rescue:
                return acc_d
            return torch.cat([torch.stack([
                grid_mod._from_cells(dens[d][0], addr[d],
                                     ps[d].target_density),
                grid_mod._from_cells(dens[d][1], addr[d], DENSITY_PADDING),
                grid_mod._from_cells(dens[d][2], addr[d], 0.0),
                grid_mod._from_cells(dens[d][3], addr[d], 0.0)],
                dim=1), acc_d], dim=1)

        got0 = _to_shard0(mesh, mesh.each(force))
        with mesh.shard(0):
            per_row = _by_owner(got0, owner)
            # 4b. the rescue's force half on shard 0
            if rescue:
                acc = per_row.contiguous()
                prs = p0.pressure_scalar * (den - p0.target_density)
                nprs = p0.near_pressure_scalar * nden
                grid_mod.rescue_force(pred0, vel0, den, nden, prs, nprs, acc,
                                      r, p0, c0, cfg)
                per_row = torch.cat([torch.stack([den, nden, prs, nprs],
                                                 dim=1), acc], dim=1)

        # 5. results home; each shard integrates its rows
        home = mesh.all_to_all(mesh.each(lambda s: [
            per_row[d * m:(d + 1) * m] if s == 0
            else torch.empty((0, per_row.shape[1]), device=mesh.devices[s])
            for d in range(size)]))

        def integrate(d):
            s, p, res = states[d], ps[d], home[d]
            acc = res[:, 4:].contiguous()
            t_new = s.time + p.dt
            pos, vel_new, predicted = integrate_mod.integrate(
                s.pos, s.vel, acc, p, t_new)
            return FluidState(
                pos=pos, vel=vel_new, predicted=predicted, acc=acc,
                density=res[:, 0].contiguous(),
                near_density=res[:, 1].contiguous(),
                pressure=res[:, 2].contiguous(),
                near_pressure=res[:, 3].contiguous(),
                step_count=s.step_count + 1, time=t_new,
                overflow=unrescued[d],
                overflow_total=s.overflow_total
                + unrescued[d].to(torch.float32),
                ids=s.ids)

        return mesh.each(integrate)

    return sharded_step


def _global_sort(got: torch.Tensor, owner: torch.Tensor):
    """On shard 0: the rows' cell ids in ascending order and the row at
    each position, from each slab's sorted keys and order (``got`` (size,
    n, 2), as f32 bits), concatenated in shard order: slab d's first v_d
    entries (its rows) land at positions offset_d + k, with no host
    read."""
    size, n = got.shape[:2]
    dev = got.device
    v = (owner[None, :] == torch.arange(size, device=dev)[:, None]).sum(
        dim=1)
    offset = torch.cumsum(v, 0) - v
    k = torch.arange(n, device=dev)
    dst = torch.where(k[None, :] < v[:, None], offset[:, None] + k[None, :],
                      n).reshape(-1)
    out = torch.empty((n + 1, 2), dtype=torch.float32, device=dev)
    out[dst] = got.reshape(-1, 2)
    cols = out[:n].view(torch.int32)
    return cols[:, 0].contiguous(), cols[:, 1].contiguous()


def make_sharded_rollout(mesh: Mesh, cfg: SimConfig):
    """``rollout(states, params, num_steps) -> states``: ``num_steps``
    cell-slab-sharded ``bucket_grid`` steps (``make_sharded_step``), the
    counterpart of JAX's jitted ``lax.scan`` over the sharded step. Each
    call steps a ``ShardedGraph`` over copies of its inputs (they stay as
    they were): on a mesh whose shards share one CUDA device it warms up,
    captures one step, a branch a shard on the shards' streams, and
    replays it once a step, the slabs' passes running concurrently (one
    after another on a ``serial`` mesh); elsewhere it steps eagerly.
    Raises ValueError ("not divisible") when ``grid_dims[0]`` does not
    divide by the mesh size, as JAX's does."""
    step = make_sharded_step(mesh, cfg)

    def sharded_rollout(states: list[FluidState], params: SimParams,
                        num_steps: int) -> list[FluidState]:
        g = graph_mod.ShardedGraph(step, [s.clone() for s in states],
                                   _map_tensors(params, torch.clone), mesh)
        g.run(num_steps)
        return g.states

    return sharded_rollout
