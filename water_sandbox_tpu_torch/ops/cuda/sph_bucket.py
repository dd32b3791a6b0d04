"""Bucket-grid SPH on the GPU — the counterpart of
``water_sandbox_tpu/ops/pallas/sph_bucket.py``.

* Build (torch ops): cell keys, one stable sort carrying the permutation,
  running-max slot ranks, one row gather, the slot-major "stack" scatter of
  the feature planes, per-lane occupancy counts. The layout is the JAX
  package's slab-padded ``Geom``: flat lane ``PAD + x·S_pad + y·gz + z``,
  planes ``(2·dim, cap_p, L)`` with ``_FAR`` in empty position slots, so
  planes, counts, addresses and order compare with JAX bit for bit.
* Kernels: ``run_density`` (``csrc/sph_density.cu``) and ``run_force``
  (``csrc/sph_force.cu``), hand-written CUDA for Hopper. Each wrapper runs
  its plain PyTorch version (``density_plain`` / ``force_plain``) for CPU
  tensors and launches its kernel for CUDA tensors — there is no fallback
  between the two — and counts its launches in ``LAUNCHES``.
* Passes: ``sph_passes`` (density → exact overflow rescue → force → one
  gather), ``bucket_sph`` (particle order) and ``bucket_sph_sorted`` (rows
  in this step's bucket order, identity on ``ids``).
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from ...core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from .. import hashing

_FAR = 1.0e15

# Scalar-parameter slots of the (1, 16) f32 parameter vector; the kernels
# read the same slots (csrc/sph_common.cuh).
_P_H = 0
_P_POW2 = 1
_P_POW2_DER = 2
_P_POW3 = 3
_P_POW3_DER = 4
_P_SPIKEY = 5
_P_PRESSURE = 6
_P_NEAR_PRESSURE = 7
_P_TARGET_DENSITY = 8
_P_VISCOSITY = 9

# Kernel launches by the wrappers (a launch made for any purpose counts;
# callers that need the main path's count reset it first).
LAUNCHES = {"sph_density": 0, "sph_force": 0}

# Threads an SM the kernels' row groups aim for (_row_group). On the H100
# (132 SMs) two threads a row beat one at 65,536 rows (496 threads an SM)
# and lose at 266,112 (2,016), for both kernels. On the first m rows of the
# 266,112-row state (chip_smoke.py's row-group crossing lines) the density
# kernel's two threads a row are ahead up to m = 101,376, this threshold
# (0.0163 against 0.0185 ms device), and behind from 114,048 (0.0213 against
# 0.0195); the force kernel's are ahead at 76,032 (0.0298 against 0.0360)
# and already behind at 88,704 (0.0368 against 0.0353).
_ROW_THREADS_PER_SM = 768

# Candidate elements (rows x 3^dim x cap_p) per chunk of the plain versions:
# bounds their temporaries to tens of MB at any particle count.
_PLAIN_CHUNK = 1 << 21


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Geom(NamedTuple):
    """Slab-padded lane geometry, a pure function of SimConfig (the JAX
    package's ``Geom``; the port's kernels use gz, S_pad, L)."""
    gx: int
    gy: int
    gz: int
    S: int
    S_pad: int
    NYC: int
    PAD: int
    L: int
    T: int      # lane-chunk width
    M: int      # window lane margin (needs gz < M)
    CLW: int    # per-slab window width = T + 2*M


def _pick_tile(S: int, override: int = 0) -> int:
    if override:
        return override
    return 1024 if S >= 2048 else 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cap_pad(cap: int) -> int:
    """Slot rows of the bucket planes: cell_capacity rounded up to 8 (rows
    >= cell_capacity are never written and hold the _FAR fill)."""
    return _round_up(cap, 8)


def _geometry(cfg: SimConfig) -> Geom:
    """flat lane l = PAD + x·S_pad + (y·gz + z), with PAD = S_pad + 2·M dead
    lanes at each end, so every neighbour lane of a real lane is in bounds."""
    dims = cfg.grid_dims
    gx, gy = dims[0], dims[1]
    gz = dims[2] if cfg.dim == 3 else 1
    S = gy * gz
    T = _pick_tile(S, cfg.tile_override)
    M = T // 2
    CLW = T + 2 * M
    if gz > M - 1:
        raise ValueError(
            f"bucket layout needs grid z-dim < {M}; got {gz} — use a "
            "coarser grid")
    S_pad = _round_up(S, T)
    NYC = S_pad // T
    PAD = S_pad + 2 * M
    L = PAD + gx * S_pad + PAD
    return Geom(gx, gy, gz, S, S_pad, NYC, PAD, L, T, M, CLW)


def _lane_offsets(g: Geom, dim: int) -> list[int]:
    """The 3^dim neighbour-cell offsets as flat-lane shifts, x outermost."""
    offs = []
    for off in itertools.product((-1, 0, 1), repeat=dim):
        oz = off[2] if dim == 3 else 0
        offs.append(off[0] * g.S_pad + off[1] * g.gz + oz)
    return offs


def _scatter_planes(srows: torch.Tensor, flat: torch.Tensor, dim: int,
                    cap_p: int, L: int) -> torch.Tensor:
    """Scatter the (n, 2·dim) sorted feature rows into the planes
    (2·dim, cap_p, L): one slot-major scatter per feature, then a stack (the
    JAX package's "stack" build). Position rows fill with _FAR (the kernels'
    distance test then rejects empty slots), velocity rows with 0. The
    capacity-overflow address cap_p·L lands in one extra element that is
    dropped; it is the only address that repeats."""
    idx = flat.long()
    out = []
    for j in range(srows.shape[1]):
        buf = torch.full((cap_p * L + 1,), _FAR if j < dim else 0.0,
                         dtype=srows.dtype, device=srows.device)
        buf[idx] = srows[:, j]
        out.append(buf[:-1].view(cap_p, L))
    return torch.stack(out)


def _build_core(predicted, vel, params, cfg: SimConfig, carry=None,
                time=None):
    """The bucket build, scattering directly into the kernels' layout.

    ``carry`` appends (n, k) f32 columns that ride the sorted row gather but
    are not scattered into planes. ``time`` poses the box for
    container-frame keys.

    Returns (planes (2·dim, cap_p, L), counts (1, L) f32, flat (n,) i32 each
    SORTED row's plane address — cap_p·L for capacity-overflow rows —,
    order (n,) i32 the sort permutation, srows (n, 2·dim + k), overflow ()
    i32)."""
    n, dim = predicted.shape
    h = params.smoothing_radius
    cap = cfg.cell_capacity
    g = _geometry(cfg)
    dev = predicted.device

    kpred = hashing.key_coords(predicted, params, cfg, time)
    origin = hashing.grid_origin(kpred, h)
    # a true division, not a multiply by 1/h: keys must match JAX's bits
    cell = torch.floor((kpred - origin) / h).to(torch.int32)
    hi = torch.tensor(cfg.grid_dims, dtype=torch.int32, device=dev) - 1
    cell = torch.minimum(torch.clamp_min(cell, 0), hi)
    r = cell[:, 1]
    if dim == 3:
        r = r * g.gz + cell[:, 2]
    col = cell[:, 0] * g.S_pad + r                   # slab-strided column

    # stable: ties keep ascending row order, as jax.lax.sort((col, iota))
    sorted_col, order = torch.sort(col, stable=True)
    ranks = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_col[1:] != sorted_col[:-1]
    run_start = torch.cummax(torch.where(first, ranks, 0), dim=0).values
    slot = ranks - run_start
    cap_p = _cap_pad(cap)
    ok = slot < cap
    flat = torch.where(ok, slot * g.L + g.PAD + sorted_col, cap_p * g.L)

    feats = [predicted, vel] + ([carry] if carry is not None else [])
    srows = torch.cat(feats, dim=1)[order]            # ONE row gather

    planes = _scatter_planes(srows[:, :2 * dim], flat, dim, cap_p, g.L)
    # occupied slots per lane, from the position plane (slots fill from 0)
    counts = (planes[0] < _FAR * 0.5).sum(
        dim=0, dtype=predicted.dtype)[None, :]
    overflow = (n - ok.sum()).to(torch.int32)
    return planes, counts, flat, order.to(torch.int32), srows, overflow


def _build_slab_buckets(predicted, vel, params, cfg: SimConfig, time=None):
    """Particle-order build: ``addr`` maps PARTICLE i to its plane address
    (cap_p·L when it overflowed). Returns (planes, counts, addr, overflow)."""
    n = predicted.shape[0]
    planes, counts, flat, order, _, overflow = _build_core(
        predicted, vel, params, cfg, time=time)
    addr = torch.empty(n, dtype=torch.int32, device=predicted.device)
    addr[order.long()] = flat
    return planes, counts, addr, overflow


def build_local_slab_buckets(pred, vel, active, origin, gx_loc: int,
                             my_dev: int, params, cfg_loc: SimConfig):
    """Per-shard build of the domain-decomposed step: like
    ``_build_slab_buckets`` over the shard's slab range of the global grid
    (x clamps into the local range — stragglers between migrations; the
    distance test keeps their pairs exact), with inactive slots sorting last
    and dropped. The halo exchange writes the neighbours' boundary slabs
    into the lanes just inside the pads (``parallel/domain.py``).

    Returns (planes, counts (1, L) local only, addr (n,) i32 — cap_p·L for
    inactive and capacity-overflow rows —, overflow () i32)."""
    n, dim = pred.shape
    h = params.smoothing_radius
    cap = cfg_loc.cell_capacity
    g = _geometry(cfg_loc)

    cell = torch.floor((pred - origin) / h).to(torch.int32)
    cell_x = torch.clamp(cell[:, 0] - my_dev * gx_loc, 0, gx_loc - 1)
    r = torch.clamp(cell[:, 1], 0, g.gy - 1)
    if dim == 3:
        r = r * g.gz + torch.clamp(cell[:, 2], 0, g.gz - 1)
    col = cell_x * g.S_pad + r

    end = gx_loc * g.S_pad
    key = torch.where(active > 0, col, end)          # inactive sort last
    sorted_key, order = torch.sort(key, stable=True)
    ranks = torch.arange(n, dtype=torch.int32, device=pred.device)
    first = torch.ones(n, dtype=torch.bool, device=pred.device)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    run_start = torch.cummax(torch.where(first, ranks, 0), dim=0).values
    slot = ranks - run_start
    cap_p = _cap_pad(cap)
    ok = (slot < cap) & (sorted_key < end)
    flat = torch.where(ok, slot * g.L + g.PAD + sorted_key, cap_p * g.L)

    srows = torch.cat([pred, vel], dim=1)[order]
    planes = _scatter_planes(srows, flat, dim, cap_p, g.L)
    counts = (planes[0] < _FAR * 0.5).sum(dim=0, dtype=pred.dtype)[None, :]
    addr = torch.empty(n, dtype=torch.int32, device=pred.device)
    addr[order] = flat.to(torch.int32)
    overflow = (active.sum() - ok.sum()).to(torch.int32)
    return planes, counts, addr, overflow


def _param_vector(params: SimParams, coeffs: KernelCoeffs) -> torch.Tensor:
    """(1, 16) f32 scalars the kernels read, assembled on the device."""
    vals = [params.smoothing_radius, coeffs.pow2, coeffs.pow2_der,
            coeffs.pow3, coeffs.pow3_der, coeffs.spikey_pow3,
            params.pressure_scalar, params.near_pressure_scalar,
            params.target_density, params.viscosity_strength]
    v = torch.zeros(16, dtype=torch.float32, device=params.device)
    v[:len(vals)] = torch.stack(vals)
    return v[None, :]


def derived_density_planes(den, nden, params: SimParams) -> torch.Tensor:
    """The 6 density-output rows from (den, nden): den, nden, EOS
    half-pressure, near half-pressure, 1/den, 1/nden — what the density
    kernel writes, for the rescue's corrected rows."""
    pa = 0.5 * params.pressure_scalar
    pb = -pa * params.target_density
    npa = 0.5 * params.near_pressure_scalar
    return torch.stack([den, nden, pa * den + pb, npa * nden,
                        torch.reciprocal(den), torch.reciprocal(nden)])


def gather_results(out_c, addr, dropped, params):
    """ONE multi-feature gather brings (den, nden, acc) back to row order;
    dropped rows (sentinel addr) read a clamped element and get fill values
    by a select."""
    dim = out_c.shape[0] - 2
    safe = torch.clamp_max(addr, out_c.shape[1] * out_c.shape[2] - 1).long()
    out = out_c.reshape(2 + dim, -1)[:, safe]          # (2+dim, n)
    den = torch.where(dropped, params.target_density, out[0])
    nden = torch.where(dropped, DENSITY_PADDING, out[1])
    acc = torch.where(dropped[:, None], 0.0, out[2:].T)
    return den, nden, acc


# ---------------------------------------------------------------- kernels --

def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_inputs(cfg, planes, counts, addr, params_vec, dens=None):
    """Validate what the kernels read through raw pointers: dtypes, shapes,
    contiguity, one device. Returns (geometry, cap_p)."""
    g = _geometry(cfg)
    cap_p = _cap_pad(cfg.cell_capacity)
    _check(planes, "planes", torch.float32, (2 * cfg.dim, cap_p, g.L))
    _check(counts, "counts", torch.float32, (1, g.L))
    _check(addr, "addr", torch.int32, (addr.numel(),))
    _check(params_vec, "params_vec", torch.float32, (1, 16))
    ts = [planes, counts, addr, params_vec]
    if dens is not None:
        _check(dens, "dens", torch.float32, (6, cap_p, g.L))
        ts.append(dens)
    if any(t.device != planes.device for t in ts):
        raise ValueError("kernel inputs must share one device")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {planes.device}")
    return g, cap_p


def _launch(name: str, *args) -> None:
    from . import _build
    err = _build.entry("wst_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _row_group(n: int, sms: int) -> int:
    """Threads a row of the density and force kernels (csrc/sph_density.cu,
    csrc/sph_force.cu) for ``n`` rows on a card of ``sms`` SMs: the least of
    1, 2, 4 that gives the launch at least ``_ROW_THREADS_PER_SM`` threads
    an SM, else 4."""
    group = 1
    while group < 4 and n * group < sms * _ROW_THREADS_PER_SM:
        group *= 2
    return group


def run_density(planes, counts, addr, params_vec, cfg: SimConfig):
    """Density pass: (6, cap_p, L) f32 planes at every address in ``addr``
    (see csrc/sph_density.cu). Plain version on the CPU, kernel on CUDA."""
    _check_inputs(cfg, planes, counts, addr, params_vec)
    if planes.device.type == "cpu":
        return density_plain(planes, counts, addr, params_vec, cfg)
    return _density_kernel(planes, counts, addr, params_vec, cfg,
                           _row_group(addr.shape[0],
                                      _sm_count(planes.device.index or 0)))


def _density_kernel(planes, counts, addr, params_vec, cfg: SimConfig,
                    group: int):
    """Launch csrc/sph_density.cu with ``group`` threads a row on checked
    CUDA inputs (run_density picks the group)."""
    g = _geometry(cfg)
    cap_p = _cap_pad(cfg.cell_capacity)
    out = torch.empty((6, cap_p, g.L), dtype=torch.float32,
                      device=planes.device)
    _launch("sph_density", planes.data_ptr(), counts.data_ptr(),
            addr.data_ptr(), addr.shape[0], params_vec.data_ptr(),
            out.data_ptr(), cfg.dim, cap_p, g.L, g.S_pad, g.gz, group,
            planes.device.index or 0,
            torch.cuda.current_stream(planes.device).cuda_stream)
    return out


def run_force(planes, dens, counts, addr, params_vec, cfg: SimConfig):
    """Force pass: (2 + dim, cap_p, L) f32 — den/nden passthrough, then the
    acceleration planes at every address in ``addr`` (see
    csrc/sph_force.cu). Plain version on the CPU, kernel on CUDA."""
    _check_inputs(cfg, planes, counts, addr, params_vec, dens=dens)
    if planes.device.type == "cpu":
        return force_plain(planes, dens, counts, addr, params_vec, cfg)
    return _force_kernel(planes, dens, counts, addr, params_vec, cfg,
                         _row_group(addr.shape[0],
                                    _sm_count(planes.device.index or 0)))


def _force_kernel(planes, dens, counts, addr, params_vec, cfg: SimConfig,
                  group: int):
    """Launch csrc/sph_force.cu with ``group`` threads a row on checked
    CUDA inputs (run_force picks the group)."""
    g = _geometry(cfg)
    cap_p = _cap_pad(cfg.cell_capacity)
    out = torch.empty((2 + cfg.dim, cap_p, g.L), dtype=torch.float32,
                      device=planes.device)
    _launch("sph_force", planes.data_ptr(), dens.data_ptr(),
            counts.data_ptr(), addr.data_ptr(), addr.shape[0],
            params_vec.data_ptr(), out.data_ptr(), cfg.dim, cap_p, g.L,
            g.S_pad, g.gz, group, planes.device.index or 0,
            torch.cuda.current_stream(planes.device).cuda_stream)
    return out


def _candidate_chunks(counts, addr, cfg: SimConfig):
    """Yield (a, cidx, mask) per chunk of occupied rows: a (R,) long plane
    addresses, cidx (R, 3^dim, cap_p) candidate plane addresses, mask the
    occupied candidates (slot < counts of the neighbour lane)."""
    g = _geometry(cfg)
    cap_p = _cap_pad(cfg.cell_capacity)
    dev = addr.device
    occ = addr[addr < cap_p * g.L].long()
    offs = torch.tensor(_lane_offsets(g, cfg.dim), dtype=torch.long,
                        device=dev)
    slots = torch.arange(cap_p, dtype=torch.long, device=dev)
    cnt = counts.reshape(-1)
    rows = max(1, _PLAIN_CHUNK // (len(offs) * cap_p))
    for s in range(0, occ.shape[0], rows):
        a = occ[s:s + rows]
        nl = (a % g.L)[:, None] + offs[None, :]              # (R, K)
        cidx = slots * g.L + nl[..., None]                   # (R, K, C)
        mask = slots < cnt[nl][..., None]
        yield a, cidx, mask


def density_plain(planes, counts, addr, params_vec, cfg: SimConfig):
    """Plain PyTorch version of the density kernel: the same per-row walk,
    vectorised over rows as (rows, 3^dim, cap_p) candidate tiles. Slots not
    in ``addr`` hold NaN (unspecified, as in the kernel)."""
    dim = cfg.dim
    cap_p = _cap_pad(cfg.cell_capacity)
    L = _geometry(cfg).L
    prm = params_vec[0]
    h, pow2, pow3 = prm[_P_H], prm[_P_POW2], prm[_P_POW3]
    P = planes[:dim].reshape(dim, -1)
    out = torch.full((6, cap_p, L), float("nan"), device=planes.device)
    flat_out = out.view(6, -1)
    for a, cidx, mask in _candidate_chunks(counts, addr, cfg):
        d2 = None
        for k in range(dim):
            dk = P[k][cidx] - P[k][a][:, None, None]
            d2 = dk * dk if d2 is None else d2 + dk * dk
        v = torch.where(mask, torch.clamp_min(h - torch.sqrt(d2), 0.0), 0.0)
        v2 = v * v
        den = (v2 * pow2).sum(dim=(1, 2)) + DENSITY_PADDING
        nden = (v2 * v * pow3).sum(dim=(1, 2)) + DENSITY_PADDING
        k_ = prm[_P_PRESSURE]
        flat_out[:, a] = torch.stack([
            den, nden, (k_ * 0.5) * den + (-k_ * prm[_P_TARGET_DENSITY] * 0.5),
            (prm[_P_NEAR_PRESSURE] * 0.5) * nden,
            torch.reciprocal(den), torch.reciprocal(nden)])
    return out


def force_plain(planes, dens, counts, addr, params_vec, cfg: SimConfig):
    """Plain PyTorch version of the force kernel: query-side pair sums over
    (rows, 3^dim, cap_p) candidate tiles, self pair excluded, +y direction
    at d == 0. Slots not in ``addr`` hold NaN."""
    dim = cfg.dim
    cap_p = _cap_pad(cfg.cell_capacity)
    L = _geometry(cfg).L
    prm = params_vec[0]
    h = prm[_P_H]
    h2 = h * h
    pow2_der, pow3_der = prm[_P_POW2_DER], prm[_P_POW3_DER]
    spikey_visc = prm[_P_SPIKEY] * prm[_P_VISCOSITY]
    P = planes[:2 * dim].reshape(2 * dim, -1)
    D = dens.reshape(6, -1)
    out = torch.full((2 + dim, cap_p, L), float("nan"), device=planes.device)
    flat_out = out.view(2 + dim, -1)
    for a, cidx, mask in _candidate_chunks(counts, addr, cfg):
        mask = mask & (cidx != a[:, None, None])             # self pair
        q = P[:, a][..., None, None]                         # (2dim, R, 1, 1)
        qd = D[:, a][..., None, None]
        d = [P[k][cidx] - q[k] for k in range(dim)]
        dist2 = d[0] * d[0]
        for k in range(1, dim):
            dist2 = dist2 + d[k] * d[k]
        sel = mask & (dist2 <= h2)
        inv = torch.rsqrt(torch.clamp_min(dist2, 1e-30))
        v = dist2 * inv - h
        shared_p = qd[2] + D[2][cidx]
        shared_np = qd[3] + D[3][cidx]
        scale = torch.where(sel, qd[4] * (
            shared_p * (v * pow2_der) * D[4][cidx]
            + shared_np * ((v * v) * pow3_der) * D[5][cidx]), 0.0)
        scale_i = scale * inv
        hv = h2 - torch.minimum(dist2, h2)
        w_visc = torch.where(sel, (hv * hv * hv) * spikey_visc, 0.0)
        rows = [D[0][a], D[1][a]]
        for k in range(dim):
            f = d[k] * scale_i + (P[dim + k][cidx] - q[dim + k]) * w_visc
            if k == 1:
                f = f + torch.where(dist2 == 0.0, scale, 0.0)
            rows.append(f.sum(dim=(1, 2)))
        flat_out[:, a] = torch.stack(rows)
    return out


# ----------------------------------------------------------------- passes --

def sph_passes(planes, counts, addr, dropped, overflow, predicted, vel,
               params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig):
    """Density + exact rescue + force + gather-back on built planes.

    The rescue runs only on steps that overflow; whether one did is read on
    the host (one device sync per step when ``rescue_capacity > 0``).
    Returns (den, nden, prs, nprs, acc, unrescued) in the row order of
    ``addr``."""
    from .. import rescue as rescue_mod

    params_vec = _param_vector(params, coeffs)
    dens = run_density(planes, counts, addr, params_vec, cfg)

    n_over = int(overflow) if cfg.rescue_capacity > 0 else 0
    rescue = n_over > 0
    unrescued = overflow
    if rescue:
        small = rescue_mod.small_budget(cfg)
        budget = small if n_over <= small else cfg.rescue_capacity
        safe = torch.clamp_max(addr, dens[0].numel() - 1).long()
        den = torch.where(dropped, params.target_density,
                          dens[0].reshape(-1)[safe])
        nden = torch.where(dropped, DENSITY_PADDING,
                           dens[1].reshape(-1)[safe])
        den_r, nden_r, rescued, unrescued = rescue_mod.density_rescue(
            predicted, dropped, den, nden, params, coeffs, cfg, budget=budget)
        # corrected rows into all 6 planes, so the force pass reads
        # pressures and reciprocals consistent with them
        keep = ~dropped
        dens.view(6, -1)[:, addr[keep].long()] = derived_density_planes(
            den_r, nden_r, params)[:, keep]

    out_c = run_force(planes, dens, counts, addr, params_vec, cfg)
    den, nden, acc = gather_results(out_c, addr, dropped, params)

    if rescue:
        den = torch.where(rescued, den_r, den)
        nden = torch.where(rescued, nden_r, nden)
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    if rescue:
        acc = rescue_mod.force_rescue(predicted, vel, den, nden, prs, nprs,
                                      dropped, acc, params, coeffs, cfg,
                                      budget=budget)
    return den, nden, prs, nprs, acc, unrescued


def bucket_sph(predicted, vel, params: SimParams, coeffs: KernelCoeffs,
               cfg: SimConfig, time=None):
    """Per-particle (den, nden, prs, nprs, acc, unrescued) in the caller's
    row order."""
    L = _geometry(cfg).L
    planes, counts, addr, overflow = _build_slab_buckets(
        predicted, vel, params, cfg, time=time)
    dropped = addr == _cap_pad(cfg.cell_capacity) * L
    return sph_passes(planes, counts, addr, dropped, overflow, predicted,
                      vel, params, coeffs, cfg)


def bucket_sph_sorted(pos, vel, predicted, ids, params: SimParams,
                      coeffs: KernelCoeffs, cfg: SimConfig, time=None):
    """``bucket_sph`` for the sorted-state step: every result comes back in
    THIS step's bucket order with the same-order (pos, vel, ids) rows. pos
    and ids (bit-cast int32 → f32) ride the build's one row gather.

    Returns (den, nden, prs, nprs, acc, unrescued, s_pos, s_vel, s_ids)."""
    dim = cfg.dim
    L = _geometry(cfg).L
    carry = torch.cat([pos, ids.view(torch.float32)[:, None]], dim=1)
    planes, counts, flat, _, srows, overflow = _build_core(
        predicted, vel, params, cfg, carry=carry, time=time)
    dropped = flat == _cap_pad(cfg.cell_capacity) * L
    s_pred = srows[:, :dim]
    s_vel = srows[:, dim:2 * dim]
    s_pos = srows[:, 2 * dim:3 * dim]
    s_ids = srows[:, 3 * dim].contiguous().view(torch.int32)
    den, nden, prs, nprs, acc, unrescued = sph_passes(
        planes, counts, flat, dropped, overflow, s_pred, s_vel, params,
        coeffs, cfg)
    return den, nden, prs, nprs, acc, unrescued, s_pos, s_vel, s_ids
