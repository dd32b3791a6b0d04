"""Bucket-grid SPH on the GPU — the counterpart of
``water_sandbox_tpu/ops/pallas/sph_bucket.py``.

* Build: cell keys and one stable sort carrying the permutation (torch
  ops), then slot ranks, one row gather, the slot-major scatter of the
  feature planes and per-lane occupancy counts (``build.run_build``: one
  kernel, ``csrc/sph_build.cu``, on CUDA; the ATen chain on the CPU). The
  layout is the JAX package's slab-padded ``Geom``: flat lane ``PAD +
  x·S_pad + y·gz + z``, planes ``(2·dim, cap_p, L)`` with ``_FAR`` in empty
  position slots, so planes, counts, addresses and order compare with JAX
  bit for bit.
* Kernels: ``run_density`` (``csrc/sph_density.cu``) and ``run_force``
  (``csrc/sph_force.cu``), hand-written CUDA for Hopper. Each wrapper runs
  its plain PyTorch version (``density_plain`` / ``force_plain``) for CPU
  tensors and launches its kernel for CUDA tensors — there is no fallback
  between the two — and launches through ``_build.launch``, which counts.
* Passes: ``sph_passes`` (density → exact overflow rescue → force →
  gather), ``bucket_sph`` (particle order) and ``bucket_sph_sorted`` (rows
  in this step's bucket order, identity on ``ids``). The rescue's kernels
  (``ops/cuda/rescue.py``) run on every step and gate themselves on the
  device count, and nothing in the step reads the device on the host, so
  ``ops/cuda/graph.py`` captures it as a CUDA graph.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple

import torch

from ...core.params import DENSITY_PADDING, KernelCoeffs, SimConfig, SimParams
from ...runtime import profiling
from .. import hashing
from . import _build

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


def _build_core(predicted, vel, params, cfg: SimConfig, carry=(),
                origin=None, time=None):
    """The bucket build, scattering directly into the kernels' layout: the
    cell keys and their stable sort here, the rest in ``build.run_build``
    (one kernel on CUDA, the ATen chain on the CPU).

    ``carry`` is a sequence of (n, k) f32 column blocks that ride the sorted
    row gather, in order, but are not scattered into planes (the kernel
    reads each where it lies, with no concatenation). ``origin``
    pins the grid anchor instead of deriving it from the data (the
    incremental step keeps it frozen between rebuilds so cell keys stay
    comparable). ``time`` poses the box for container-frame keys.

    Returns (planes (2·dim, cap_p, L), counts (1, L) f32, flat (n,) i32 each
    SORTED row's plane address — cap_p·L for capacity-overflow rows —,
    order (n,) i32 the sort permutation, srows (n, 2·dim + k), overflow ()
    i32, sorted_col (n,) i32 each sorted row's column, non-decreasing: the
    cell order the rescue's kernels walk)."""
    dim = predicted.shape[1]
    h = params.smoothing_radius
    cap = cfg.cell_capacity
    g = _geometry(cfg)

    kpred = hashing.key_coords(predicted, params, cfg, time)
    if origin is None:
        origin = hashing.grid_origin(kpred, h)
    # a true division, not a multiply by 1/h: keys must match JAX's bits
    cell = torch.floor((kpred - origin) / h).to(torch.int32)
    # clamped axis by axis with Python bounds: no host-to-device copy, so
    # the step runs under CUDA-graph capture
    ax = [torch.clamp(cell[:, a], 0, cfg.grid_dims[a] - 1)
          for a in range(dim)]
    r = ax[1]
    if dim == 3:
        r = r * g.gz + ax[2]
    col = ax[0] * g.S_pad + r                        # slab-strided column

    # stable: ties keep ascending row order, as jax.lax.sort((col, iota))
    sorted_col, order = torch.sort(col, stable=True)
    from . import build
    return (*build.run_build(sorted_col, order, predicted, vel, carry, cap,
                             _cap_pad(cap), g.L, g.PAD, build._NO_KEY_BOUND),
            sorted_col)


def _particle_addr(flat, order):
    """The sorted rows' plane addresses ``flat`` back in particle order."""
    addr = torch.empty_like(flat)
    addr[order.long()] = flat
    return addr


def _build_slab_buckets(predicted, vel, params, cfg: SimConfig, origin=None,
                        time=None):
    """Particle-order build: ``addr`` maps PARTICLE i to its plane address
    (cap_p·L when it overflowed). Returns (planes, counts, addr, overflow)."""
    planes, counts, flat, order, _, overflow, _ = _build_core(
        predicted, vel, params, cfg, origin=origin, time=time)
    return planes, counts, _particle_addr(flat, order), overflow


def local_columns(pred, origin, gx_loc: int, my_dev: int, params,
                  cfg_loc: SimConfig) -> torch.Tensor:
    """(n,) i32 each row's column in shard ``my_dev``'s slab of the global
    grid: x clamps into the local range (stragglers between migrations), y
    and z into the grid. The key the shard's build sorts by, and the key of
    the domain rescue's query rows."""
    dim = pred.shape[1]
    g = _geometry(cfg_loc)
    cell = torch.floor((pred - origin) / params.smoothing_radius).to(
        torch.int32)
    cell_x = torch.clamp(cell[:, 0] - my_dev * gx_loc, 0, gx_loc - 1)
    r = torch.clamp(cell[:, 1], 0, g.gy - 1)
    if dim == 3:
        r = r * g.gz + torch.clamp(cell[:, 2], 0, g.gz - 1)
    return cell_x * g.S_pad + r


def build_local_slab_buckets(pred, vel, active, origin, gx_loc: int,
                             my_dev: int, params, cfg_loc: SimConfig):
    """Per-shard build of the domain-decomposed step: like
    ``_build_slab_buckets`` over the shard's slab range of the global grid
    (``local_columns``; the distance test keeps the stragglers' pairs
    exact), with inactive rows keyed at the slab's end, so they sort last
    and take no slot, in ``build.run_build``. The halo exchange
    writes the neighbours' boundary slabs into the lanes just inside the
    pads (``parallel/domain.py``).

    Returns (planes, counts (1, L) local only, addr (n,) i32 — cap_p·L for
    inactive and capacity-overflow rows —, overflow () i32, sorted_key (n,)
    i32 the rows' columns ascending — gx_loc·S_pad for inactive rows, which
    sort last —, order (n,) i32 the row at each position): the last two are
    the order the domain rescue's kernels walk, as ``_build_core``'s
    ``sorted_col`` is the single-device rescue's."""
    cap = cfg_loc.cell_capacity
    g = _geometry(cfg_loc)
    col = local_columns(pred, origin, gx_loc, my_dev, params, cfg_loc)
    end = gx_loc * g.S_pad
    key = torch.where(active > 0, col, end)
    sorted_key, order = torch.sort(key, stable=True)
    from . import build
    planes, counts, flat, order, _, overflow = build.run_build(
        sorted_key, order, pred, vel, (), cap, _cap_pad(cap), g.L, g.PAD, end)
    return (planes, counts, _particle_addr(flat, order), overflow, sorted_key,
            order)


def _param_values(params: SimParams, coeffs: KernelCoeffs) -> tuple:
    """The parameter vector's scalars in slot order, ``_P_H`` first."""
    return (params.smoothing_radius, coeffs.pow2, coeffs.pow2_der,
            coeffs.pow3, coeffs.pow3_der, coeffs.spikey_pow3,
            params.pressure_scalar, params.near_pressure_scalar,
            params.target_density, params.viscosity_strength)


def _param_vector(params: SimParams, coeffs: KernelCoeffs) -> torch.Tensor:
    """(1, 16) f32 scalars the kernels read, assembled on the device: on
    CUDA tensors one kernel (``ops/cuda/coeffs.py::run_param_vector``), on
    the CPU ``param_vector_plain``."""
    if params.device.type != "cuda":
        return param_vector_plain(params, coeffs)
    from . import coeffs as coeffs_k
    return coeffs_k.run_param_vector(_param_values(params, coeffs))


def param_vector_plain(params: SimParams, coeffs: KernelCoeffs):
    """``_param_vector`` as the ATen chain, on any device: zeros past the
    scalars of ``_param_values``."""
    vals = _param_values(params, coeffs)
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
    _build.launch(
        "sph_density", planes.data_ptr(), counts.data_ptr(),
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
    _build.launch(
        "sph_force", planes.data_ptr(), dens.data_ptr(),
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

def gather_density(dens, addr, dropped, params):
    """(den, nden) (n,) from the density planes at ``addr``; dropped rows
    (sentinel addr) read a clamped element and get fill values."""
    safe = torch.clamp_max(addr, dens[0].numel() - 1).long()
    out = dens[:2].reshape(2, -1)[:, safe]
    return (torch.where(dropped, params.target_density, out[0]),
            torch.where(dropped, DENSITY_PADDING, out[1]))


def rescue_density_planes(dens, addr, dropped, overflow, predicted,
                          params: SimParams, coeffs: KernelCoeffs,
                          cfg: SimConfig, params_vec, sorted_col,
                          order=None):
    """The rescue's density half, gated on the device: the selection
    (``ops/rescue.py::rescue_selection``), the cell order its kernels walk
    (``ops/cuda/rescue.py::cell_walk`` over ``sorted_col`` and ``order``,
    the build's sort; ``order`` None where the rows are in that order) and
    R1. Exact densities with the dropped rows included (up to
    ``rescue_capacity``), and the residents' corrected rows written into
    all 6 density planes, so the force pass reads pressures and reciprocals
    consistent with them. Reads nothing on the host: with no overflow R1
    changes nothing. Returns (den, nden, sel, slot, count, walk) — the last
    four for the force half."""
    from .. import rescue as rescue_mod
    from . import rescue as rescue_k
    den, nden = gather_density(dens, addr, dropped, params)
    sel, slot, count = rescue_mod.rescue_selection(
        dropped, overflow, min(cfg.rescue_capacity, dropped.shape[0]))
    walk = rescue_k.cell_walk(sel, count, sorted_col, order)
    rescue_k.rescue_density(predicted, sel, slot, count, addr, den, nden,
                            dens, params, coeffs, params_vec, cfg, walk)
    return den, nden, sel, slot, count, walk


def sph_passes(planes, counts, addr, dropped, overflow, predicted, vel,
               params: SimParams, coeffs: KernelCoeffs, cfg: SimConfig,
               sorted_col, order=None):
    """Density + exact rescue + force + gather-back on built planes.

    With ``rescue_capacity > 0`` both rescue kernels run on every step and
    gate themselves on the device count (JAX's ``lax.cond``): the passes
    read nothing on the host, so the step can be captured as a CUDA graph.
    ``sorted_col`` and ``order`` are the build's sort (``_build_core``),
    which the rescue walks; ``order`` None where the rows are in that
    order. Each phase begins with ``profiling.phase``. Returns (den, nden,
    prs, nprs, acc, unrescued) in the row order of ``addr``."""
    from . import rescue as rescue_k

    profiling.phase("density")
    params_vec = _param_vector(params, coeffs)
    dens = run_density(planes, counts, addr, params_vec, cfg)
    rescue = cfg.rescue_capacity > 0
    if rescue:
        profiling.phase("rescue")
        # the kernels read rows through raw pointers: the sorted step's
        # rows are column views of one gathered block
        predicted, vel = predicted.contiguous(), vel.contiguous()
        den, nden, sel, slot, count, walk = rescue_density_planes(
            dens, addr, dropped, overflow, predicted, params, coeffs, cfg,
            params_vec, sorted_col, order)
        unrescued = overflow - count
    else:
        den, nden = gather_density(dens, addr, dropped, params)
        unrescued = overflow

    profiling.phase("force")
    out_c = run_force(planes, dens, counts, addr, params_vec, cfg)
    acc = gather_results(out_c, addr, dropped, params)[2].contiguous()
    prs = params.pressure_scalar * (den - params.target_density)
    nprs = params.near_pressure_scalar * nden
    if rescue:
        profiling.phase("rescue")
        rescue_k.rescue_force(predicted, vel, den, nden, prs, nprs, sel,
                              slot, count, acc, params, coeffs, params_vec,
                              cfg, walk)
    return den, nden, prs, nprs, acc, unrescued


def bucket_sph(predicted, vel, params: SimParams, coeffs: KernelCoeffs,
               cfg: SimConfig, time=None):
    """Per-particle (den, nden, prs, nprs, acc, unrescued) in the caller's
    row order."""
    L = _geometry(cfg).L
    planes, counts, flat, order, _, overflow, sorted_col = _build_core(
        predicted, vel, params, cfg, time=time)
    addr = _particle_addr(flat, order)
    dropped = addr == _cap_pad(cfg.cell_capacity) * L
    return sph_passes(planes, counts, addr, dropped, overflow, predicted,
                      vel, params, coeffs, cfg, sorted_col, order)


def bucket_sph_sorted(pos, vel, predicted, ids, params: SimParams,
                      coeffs: KernelCoeffs, cfg: SimConfig, time=None):
    """``bucket_sph`` for the sorted-state step: every result comes back in
    THIS step's bucket order with the same-order (pos, vel, ids) rows. pos
    and ids (bit-cast int32 → f32) ride the build's one row gather, as two
    carried blocks.

    Returns (den, nden, prs, nprs, acc, unrescued, s_pos, s_vel, s_ids)."""
    dim = cfg.dim
    L = _geometry(cfg).L
    planes, counts, flat, _, srows, overflow, sorted_col = _build_core(
        predicted, vel, params, cfg,
        carry=(pos, ids.view(torch.float32)[:, None]), time=time)
    dropped = flat == _cap_pad(cfg.cell_capacity) * L
    s_pred = srows[:, :dim]
    s_vel = srows[:, dim:2 * dim]
    s_pos = srows[:, 2 * dim:3 * dim]
    s_ids = srows[:, 3 * dim].contiguous().view(torch.int32)
    # the rows are in the build's order: the rescue walks them as they are
    den, nden, prs, nprs, acc, unrescued = sph_passes(
        planes, counts, flat, dropped, overflow, s_pred, s_vel, params,
        coeffs, cfg, sorted_col)
    return den, nden, prs, nprs, acc, unrescued, s_pos, s_vel, s_ids
