"""The exact overflow rescue's two kernels (``csrc/sph_rescue.cu``): R1,
the density half, and R2, the force half — the counterpart of
``water_sandbox_tpu/ops/rescue.py::density_rescue`` and ``force_rescue``
under the JAX step's ``lax.cond`` (``ops/pallas/sph_bucket.py:1701``,
``:1727``).

Both work in place and read the rescued count from device memory, so the
step launches them on every step and reads nothing on the host: with count
0 they change nothing. The selection they take (``sel``, ``slot``,
``count``) comes from ``ops/rescue.py::rescue_selection``; the cell order
they walk (``Walk``: the build's sorted columns, the row at each position,
the rescued list in column order) from ``cell_walk``. Each wrapper runs its
plain version (``density_plain`` / ``force_plain``, the all-pairs
device-count functions of ``ops/rescue.py``) for CPU tensors and launches
its kernel for CUDA tensors — there is no fallback between the two —
through ``_build.launch``, which counts.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from ...core.params import KernelCoeffs, SimConfig, SimParams
from .. import rescue as rescue_mod
from . import _build
from . import sph_bucket as sb

# Blocks of part (a), one rescued row at a time, striding the list by this
# many: enough to fill the card at thousands of rescued rows, few enough
# that the empty launch of a step without overflow stays short.
_BLOCKS_A = 1024


class _Counter(threading.local):
    rows = None      # the () i64 device counter of ``counting``, or None


_COUNTER = _Counter()


@contextlib.contextmanager
def counting(rows: torch.Tensor):
    """Inside the block, each ``rescue_density`` on this thread adds its
    rescued count to ``rows``, a () i64 counter on the device (a graph's
    rescued rows): R1 adds it itself, so a captured step adds it on every
    replay; the plain version adds it with one more op."""
    if rows.dtype != torch.int64 or rows.dim() != 0:
        raise ValueError("the counter is a () int64 tensor")
    was, _COUNTER.rows = _COUNTER.rows, rows
    try:
        yield
    finally:
        _COUNTER.rows = was


class Walk(NamedTuple):
    """The cell order the kernels walk (csrc/sph_rescue.cu)."""
    scol: torch.Tensor           # (n,) i32: the rows' columns, ascending
    order: torch.Tensor | None   # (n,) i32: the row at each position;
    #                              None where row k is at position k
    rpos: torch.Tensor           # (cap,) i32: the rescued rows' positions,
    #                              ascending over [0, count)
    cols: tuple | None = None    # the columns' grid (S_pad, gx, gy, gz);
    #                              None: the kernel layout's (_geometry)


def cell_walk(sel, count, scol, order=None, cols=None) -> Walk:
    """The ``Walk`` of a rescue selection (``ops/rescue.py::
    rescue_selection``) over rows whose columns, sorted, are ``scol``, on
    the column grid ``cols`` (``Walk.cols``).

    On the sorted step (``order`` None) the rows are in column order and
    the list, in row order, is too: it is the walk's list as it is, and
    nothing runs. Otherwise ``order[k]`` is the row at position k (the
    build's sort permutation): one scatter inverts it and one sort of the
    list's ``cap`` positions puts the list in column order, on the device
    and with no host read."""
    if order is None:
        return Walk(scol, None, sel, cols)
    n, cap, dev = scol.shape[0], sel.shape[0], sel.device
    pos = torch.empty_like(order)
    pos[order.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    live = torch.arange(cap, device=dev) < count
    keys = torch.where(live, pos[sel.long()], n)    # past count: sort last
    return Walk(scol, order, torch.sort(keys).values, cols)


def _column_grid(cfg: SimConfig, cols=None) -> tuple:
    """(S_pad, gx, gy, gz) of the column keys: ``cols``, or the kernel
    layout's grid."""
    if cols is not None:
        return tuple(cols)
    g = sb._geometry(cfg)
    return (g.S_pad, g.gx, g.gy, g.gz)


def neighbour_runs(col, cfg: SimConfig, cols=None):
    """The clamped 3^dim neighbourhood of each column of ``col`` (m,) as
    3^(dim-1) runs of adjacent columns along the innermost axis, x
    outermost: (lo, hi) (m, runs) i64, inclusive, lo > hi where the run's
    cell row lies outside the grid — what the kernels walk, for the tests
    and chip_smoke.py's bound. ``cols``: the column grid (``Walk.cols``)."""
    S_pad, gx, gy, gz = _column_grid(cfg, cols)
    c = col.long()
    x, rem = c // S_pad, c % S_pad
    if cfg.dim == 3:
        m, z, n_mid, n_in, moffs = rem // gz, rem % gz, gy, gz, (-1, 0, 1)
    else:
        m, z, n_mid, n_in, moffs = torch.zeros_like(c), rem, 1, gy, (0,)
    z_lo = torch.clamp_min(z - 1, 0)
    z_hi = torch.clamp_max(z + 1, n_in - 1)
    los, his = [], []
    for ox in (-1, 0, 1):
        for om in moffs:
            xx, mm = x + ox, m + om
            ok = (xx >= 0) & (xx < gx) & (mm >= 0) & (mm < n_mid)
            base = xx * S_pad + mm * gz
            los.append(torch.where(ok, base + z_lo, 1))
            his.append(torch.where(ok, base + z_hi, 0))
    return torch.stack(los, dim=1), torch.stack(his, dim=1)


def _check_inputs(rows, sel, slot, count, params_vec, walk: Walk):
    """dtypes, shapes, contiguity and one device of what the kernels read
    through raw pointers: ``rows`` maps a name to (tensor, trailing
    shape)."""
    n = slot.shape[0]
    for name, (t, tail) in rows.items():
        sb._check(t, name, torch.float32, (n,) + tail)
    sb._check(sel, "sel", torch.int32, (sel.numel(),))
    sb._check(slot, "slot", torch.int32, (n,))
    sb._check(count, "count", torch.int32, ())
    sb._check(params_vec, "params_vec", torch.float32, (1, 16))
    sb._check(walk.scol, "walk.scol", torch.int32, (n,))
    sb._check(walk.rpos, "walk.rpos", torch.int32, (sel.numel(),))
    ts = [t for t, _ in rows.values()] + [sel, slot, count, params_vec,
                                          walk.scol, walk.rpos]
    if walk.order is not None:
        sb._check(walk.order, "walk.order", torch.int32, (n,))
        ts.append(walk.order)
    if any(t.device != slot.device for t in ts):
        raise ValueError("kernel inputs must share one device")
    if slot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {slot.device}")
    if sel.numel() == 0:
        raise ValueError("the rescue needs rescue_capacity > 0")


def _blocks_a(sel) -> int:
    return min(sel.shape[0], _BLOCKS_A)


def _walk_args(walk: Walk, cfg: SimConfig) -> tuple:
    """The walk's pointers and the column keys' grid, as the kernels take
    them (a null ``order`` where the rows are in column order)."""
    order = None if walk.order is None else walk.order.data_ptr()
    return ((walk.scol.data_ptr(), order, walk.rpos.data_ptr()),
            _column_grid(cfg, walk.cols))


def rescue_density(predicted, sel, slot, count, addr, den, nden, dens,
                   params: SimParams, coeffs: KernelCoeffs, params_vec,
                   cfg: SimConfig, walk: Walk) -> None:
    """R1 in place: rescued rows of ``den``/``nden`` (n,) take their exact
    sums; residents gain the rescued rows' contributions, in ``den``,
    ``nden`` and in their six rows of the density planes ``dens`` (6,
    cap_p, L) at ``addr``. ``addr`` and ``dens`` None: the planes are the
    caller's to update (``ops/grid.py``'s bucket planes have another
    layout). Nothing changes when ``count`` is 0. Inside ``counting``,
    ``count`` is added to its counter. Plain version on the CPU, kernel
    (walking ``walk``) on CUDA."""
    dim = cfg.dim
    _check_inputs({"predicted": (predicted, (dim,)), "den": (den, ()),
                   "nden": (nden, ())}, sel, slot, count, params_vec, walk)
    rescued = _COUNTER.rows
    if rescued is not None and rescued.device != slot.device:
        raise ValueError("kernel inputs must share one device")
    if (addr is None) != (dens is None):
        raise ValueError("addr and dens come together")
    cap_p = L = 0
    if dens is not None:
        cap_p = sb._cap_pad(cfg.cell_capacity)
        L = sb._geometry(cfg).L
        sb._check(addr, "addr", torch.int32, (slot.shape[0],))
        sb._check(dens, "dens", torch.float32, (6, cap_p, L))
        if addr.device != slot.device or dens.device != slot.device:
            raise ValueError("kernel inputs must share one device")
    if slot.device.type == "cpu":
        density_plain(predicted, sel, slot, count, addr, den, nden, dens,
                      params, coeffs, cfg)
        if rescued is not None:
            rescued.add_(count)
        return
    ptrs, grid = _walk_args(walk, cfg)
    _build.launch(
        "sph_rescue_density", predicted.data_ptr(), slot.shape[0],
        *ptrs, slot.data_ptr(), count.data_ptr(),
        None if addr is None else addr.data_ptr(),
        params_vec.data_ptr(), den.data_ptr(), nden.data_ptr(),
        None if dens is None else dens.data_ptr(),
        None if rescued is None else rescued.data_ptr(), dim, cap_p, L,
        *grid, _blocks_a(sel), slot.device.index or 0,
        torch.cuda.current_stream(slot.device).cuda_stream)


def density_plain(predicted, sel, slot, count, addr, den, nden, dens,
                  params: SimParams, coeffs: KernelCoeffs,
                  cfg: SimConfig) -> None:
    """Plain PyTorch version of R1, in place and sync-free: the device-count
    density rescue, then (``dens`` given) the residents' derived rows
    written back at their addresses (each other row rewrites the value its
    clamped address already holds)."""
    den_r, nden_r = rescue_mod.density_rescue_count(
        predicted, sel, slot, count, den, nden, params, coeffs, cfg)
    den.copy_(den_r)
    nden.copy_(nden_r)
    if dens is None:
        return
    flat = dens.view(6, -1)
    safe = torch.clamp_max(addr, flat.shape[1] - 1).long()
    write = (slot < 0) & (count > 0)
    flat[:, safe] = torch.where(
        write, sb.derived_density_planes(den, nden, params), flat[:, safe])


def rescue_force(predicted, vel, den, nden, prs, nprs, sel, slot, count,
                 acc, params: SimParams, coeffs: KernelCoeffs, params_vec,
                 cfg: SimConfig, walk: Walk) -> None:
    """R2 in place on ``acc`` (n, dim): rescued rows take their exact
    accelerations, residents add the pair forces of the rescued rows.
    Nothing changes when ``count`` is 0. Plain version on the CPU, kernel
    (walking ``walk``) on CUDA."""
    dim = cfg.dim
    _check_inputs({"predicted": (predicted, (dim,)), "vel": (vel, (dim,)),
                   "den": (den, ()), "nden": (nden, ()), "prs": (prs, ()),
                   "nprs": (nprs, ()), "acc": (acc, (dim,))},
                  sel, slot, count, params_vec, walk)
    if slot.device.type == "cpu":
        force_plain(predicted, vel, den, nden, prs, nprs, sel, slot, count,
                    acc, params, coeffs, cfg)
        return
    ptrs, grid = _walk_args(walk, cfg)
    _build.launch(
        "sph_rescue_force", predicted.data_ptr(), vel.data_ptr(),
        den.data_ptr(), nden.data_ptr(), prs.data_ptr(), nprs.data_ptr(),
        slot.shape[0], *ptrs, slot.data_ptr(), count.data_ptr(),
        params_vec.data_ptr(), acc.data_ptr(), dim, *grid,
        _blocks_a(sel), slot.device.index or 0,
        torch.cuda.current_stream(slot.device).cuda_stream)


def force_plain(predicted, vel, den, nden, prs, nprs, sel, slot, count, acc,
                params: SimParams, coeffs: KernelCoeffs,
                cfg: SimConfig) -> None:
    """Plain PyTorch version of R2, in place and sync-free."""
    acc.copy_(rescue_mod.force_rescue_count(
        predicted, vel, den, nden, prs, nprs, sel, slot, count, acc, params,
        coeffs, cfg))
