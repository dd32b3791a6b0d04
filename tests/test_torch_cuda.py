"""The port's CUDA kernels on a CUDA device: each kernel against its plain
PyTorch version (the rescue's two kernels and the build's too), one
main-path step on the card against the same step on the CPU (plain
versions), and the step captured as a CUDA graph against the eager step.
Without a CUDA device each test skips (the ``cuda_device`` fixture decides,
at run time). This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bar: rtol = atol = 2e-4 (the kernels sum pairs in another order; the force
kernel uses rsqrtf)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_fixtures import cuda_device  # noqa: F401 (fixture)
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core.params import (DENSITY_PADDING,
                                                 KernelCoeffs, SimConfig)
from water_sandbox_tpu_torch.ops.cuda import _build
from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)


def _launched(*names):
    """The port's launch counts (``_build.LAUNCHES``) of kernels ``names``."""
    return tuple(_build.LAUNCHES[k] for k in names)


def _at(planes, occ):
    return planes.reshape(planes.shape[0], -1)[:, occ].cpu().numpy()


@pytest.mark.parametrize("dim", [2, 3])
def test_kernels_match_plain(cuda_device, dim):
    rng = np.random.default_rng(5)
    pred = ((rng.random((2000, dim)) - 0.5) * 2.5).astype(np.float32)
    vel = rng.standard_normal((2000, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=16)
    planes, counts, addr, _ = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    pv = sb._param_vector(params, coeffs)
    occ = addr[addr < sb._cap_pad(cfg.cell_capacity)
               * sb._geometry(cfg).L].long()
    _build.reset_launches()
    dens = sb.run_density(planes, counts, addr, pv, cfg)
    out = sb.run_force(planes, dens, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    assert _launched("sph_density", "sph_force") == (1, 1)
    dens_p = sb.density_plain(planes, counts, addr, pv, cfg)
    out_p = sb.force_plain(planes, dens, counts, addr, pv, cfg)
    np.testing.assert_allclose(_at(dens, occ), _at(dens_p, occ), **TOL)
    np.testing.assert_allclose(_at(out, occ), _at(out_p, occ), **TOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_force_kernel_matches_plain_with_overflow(cuda_device, dim):
    """Cell capacity 4 on a dense random cloud: overflow sentinel rows in
    addr, full lanes everywhere; the kernel against force_plain."""
    rng = np.random.default_rng(9)
    pred = ((rng.random((3000, dim)) - 0.5) * 2.0).astype(np.float32)
    vel = rng.standard_normal((3000, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=4)
    planes, counts, addr, overflow = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    assert int(overflow) > 0
    pv = sb._param_vector(params, coeffs)
    occ = addr[addr < sb._cap_pad(cfg.cell_capacity)
               * sb._geometry(cfg).L].long()
    dens = sb.density_plain(planes, counts, addr, pv, cfg)
    want = _at(sb.force_plain(planes, dens, counts, addr, pv, cfg), occ)
    got = sb.run_force(planes, dens, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_at(got, occ), want, **TOL)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_density_kernel_groups_match_plain(cuda_device, dim, group):
    """K1 with 1, 2 and 4 threads a row against density_plain on a dense
    random cloud at cell capacity 4 (overflow sentinel rows in addr, full
    lanes everywhere); two launches with the same group give the same bits
    (no atomics, a fixed order of summation)."""
    rng = np.random.default_rng(9)
    pred = ((rng.random((3000, dim)) - 0.5) * 2.0).astype(np.float32)
    vel = rng.standard_normal((3000, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=4)
    planes, counts, addr, overflow = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    assert int(overflow) > 0
    pv = sb._param_vector(params, coeffs)
    occ = addr[addr < sb._cap_pad(cfg.cell_capacity)
               * sb._geometry(cfg).L].long()
    want = _at(sb.density_plain(planes, counts, addr, pv, cfg), occ)
    _build.reset_launches()
    got = sb._density_kernel(planes, counts, addr, pv, cfg, group)
    again = sb._density_kernel(planes, counts, addr, pv, cfg, group)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sph_density"] == 2
    np.testing.assert_allclose(_at(got, occ), want, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(_at(got, occ), _at(again, occ))
    with pytest.raises(RuntimeError, match="CUDA error"):
        sb._density_kernel(planes, counts, addr, pv, cfg, 3)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_density_kernel_and_the_empty_slots_fill(cuda_device, dim, group):
    """What K1 asks of the slots at or above a lane's count. It walks a run
    of three lanes to the run's largest count and loads every slot below it
    unpredicated, so it needs a position there that is farther than h from
    every query: the build's _FAR, or any other far, infinite or NaN value,
    gives density_plain's sums (which mask by the counts); a position next
    to a query in such a slot is counted, and the kernel then leaves
    density_plain. Velocity planes are not read at all."""
    rng = np.random.default_rng(11)
    n = 400 if dim == 2 else 1500
    pred = ((rng.random((n, dim)) - 0.5) * 2.0).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=32)
    planes, counts, addr, overflow = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    assert int(overflow) == 0
    pv = sb._param_vector(params, coeffs)
    occ = addr.long()
    want = _at(sb.density_plain(planes, counts, addr, pv, cfg), occ)
    bar = dict(rtol=2e-4, atol=2e-4 * max(1.0, np.abs(want).max()))
    empty = (torch.arange(planes.shape[1], device=cuda_device)[:, None]
             >= counts)
    assert bool((planes[:dim][:, empty] == sb._FAR).all())

    for fill in (3.0e7, float("inf"), float("nan")):
        other = planes.clone()
        other[:dim][:, empty] = fill
        other[dim:] = float("nan")
        got = sb._density_kernel(other, counts, addr, pv, cfg, group)
        np.testing.assert_allclose(_at(got, occ), want, **bar)

    # every empty slot takes the position of slot 0 of the lane one cell
    # up the run's axis: within h of many queries there
    near = planes.clone()
    up = torch.roll(planes[:dim, 0], 1, dims=-1)[:, None, :].expand(
        dim, planes.shape[1], -1)
    near[:dim][:, empty] = up[:, empty]
    got = _at(sb._density_kernel(near, counts, addr, pv, cfg, group), occ)
    assert (got[0] > want[0] * 1.01).any()


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_force_kernel_dense_block(cuda_device, dim, large):
    """A dense block near cell capacity, at a row count that takes several
    threads a row and at one that takes one (sph_bucket._row_group on
    this card); against force_plain."""
    h = 0.25
    cells = ((24 if large else 4), 72) if dim == 2 else (
        (8 if large else 4), 30, 30)
    cap, per_cell = (32, 60) if dim == 2 else (16, 16)
    rng = np.random.default_rng(4)
    n = per_cell * int(np.prod(cells))
    pred = (rng.random((n, dim)) * np.asarray(cells) * h).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=n, dim=dim, grid_dims=tuple(c + 2 for c in cells),
                    cell_capacity=cap)
    planes, counts, addr, _ = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (sb._row_group(n, sms) == 1) == large
    g = sb._geometry(cfg)
    pv = sb._param_vector(params, coeffs)
    occ = addr[addr < sb._cap_pad(cap) * g.L].long()
    dens = sb.density_plain(planes, counts, addr, pv, cfg)
    want = _at(sb.force_plain(planes, dens, counts, addr, pv, cfg), occ)
    got = sb.run_force(planes, dens, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_at(got, occ), want, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(want).max()))


def test_step_matches_cpu(cuda_device):
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         sorted_state=True,
                                         rescue_capacity=64)
    state = wt.rollout(state, params, cfg, 20)
    _build.reset_launches()
    got = wt.step(state.to(cuda_device), params.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert _launched("sph_density", "sph_force", "sph_build") == (1, 1, 1)
    want = wt.step(state, params, cfg)
    np.testing.assert_array_equal(got.ids.cpu().numpy(), want.ids.numpy())
    for f in ("pos", "vel", "acc", "density", "near_density", "pressure"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), **TOL,
                                   err_msg=f)


def test_incremental_rollout_matches_cpu(cuda_device):
    """The incremental plane-resident rollout on the card against the same
    rollout on the CPU (plain versions), from a particle-order state: the
    kernels walk each lane to its top slot, across holes."""
    from water_sandbox_tpu_torch.ops.cuda import incremental as inc
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         rescue_capacity=64,
                                         incremental_rebuild=4)
    state = wt.step(state, params, cfg)
    _build.reset_launches()
    got = inc.rollout_inc(state.to(cuda_device), params.to(cuda_device), cfg,
                          6)
    torch.cuda.synchronize()
    assert _launched("sph_density", "sph_force") == (6, 6)
    want = inc.rollout_inc(state, params, cfg, 6)
    for f in ("pos", "vel", "acc", "density", "near_density"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), **TOL,
                                   err_msg=f)
    assert float(got.overflow_total) == float(want.overflow_total)


def _sort_case(n, kind):
    rng = np.random.default_rng(n)
    if kind == "random":
        keys = rng.integers(-500, 500, n)
    elif kind == "descending":
        keys = np.arange(n)[::-1] // 3
    elif kind == "all_equal":
        keys = np.full(n, -4)
    else:  # real INT32_MAX keys tie with the padding
        keys = rng.integers(-50, 50, n)
        keys[rng.random(n) < 0.3] = np.iinfo(np.int32).max
    return (torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int32)),
            torch.from_numpy(rng.permutation(n).astype(np.int32)))


@pytest.mark.parametrize("kind", ["random", "descending", "all_equal",
                                  "int32_max"])
@pytest.mark.parametrize("n", [1, 2, 1000, 1024, 8192, 8193, 50000, 65536])
def test_bitonic_sort_matches_plain(cuda_device, n, kind):
    """Keys and values bit-identical, ties included, in one launch: one
    block up to 8,192 pairs, a cluster of up to 8 blocks above."""
    keys, vals = _sort_case(n, kind)
    _build.reset_launches()
    gk, gv = bs.sort_pairs(keys.to(cuda_device), vals.to(cuda_device))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitonic_sort"] == 1
    wk, wv = bs.sort_pairs_plain(keys, vals)
    np.testing.assert_array_equal(gk.cpu().numpy(), wk.numpy())
    np.testing.assert_array_equal(gv.cpu().numpy(), wv.numpy())
    with pytest.raises(ValueError, match="too large"):
        big = torch.zeros(65537, dtype=torch.int32, device=cuda_device)
        bs.sort_pairs(big, big)


def test_domain_kernels_on_halo_filled_planes(cuda_device):
    """K1 and K3 on every shard's halo-filled planes (8 shards of a
    128-particle flow on one device) against their plain versions, and one
    domain step on the card against the same step on the CPU."""
    from water_sandbox_tpu_torch.core.params import Container
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    pts = wt.cube_fluid(8, 4, 4)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(24, 8, 8),
                    cell_capacity=16)
    cfg_loc = domain._local_cfg(cfg, 3)
    g = sb._geometry(cfg_loc)

    def setup(dev):
        params = wt.SimParams.create(dim=3, device=dev, container=(
            Container.create((0.0, 0.0, 0.0), (5.0, 1.8, 1.8), device=dev)))
        mesh = mesh_mod.make_mesh(8, dev)
        states, active = domain.shard_state(
            wt.init_state(pts, vel, device="cpu"), mesh, cfg, params,
            slack=8.0)
        return params, mesh, states, active

    params, mesh, states, active = setup(cuda_device)
    feats, counts, addr, _ = domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * 8, cfg, 3, mesh)
    pv = sb._param_vector(params, KernelCoeffs.from_radius(
        params.smoothing_radius, 3))
    _build.reset_launches()
    dens = [sb.run_density(feats[d], counts[d], addr[d], pv, cfg_loc)
            for d in range(8)]
    dens = domain._exchange_halo_slabs(dens, 3, g.S_pad, g.PAD, mesh)
    out = [sb.run_force(feats[d], dens[d], counts[d], addr[d], pv, cfg_loc)
           for d in range(8)]
    torch.cuda.synchronize()
    assert _launched("sph_density", "sph_force") == (8, 8)
    halo = 0.0
    for d in range(8):
        occ = addr[d][addr[d] < sb._cap_pad(16) * g.L].long()
        halo += float(counts[d][0, g.PAD - g.S_pad:g.PAD].sum())
        dens_p = sb.density_plain(feats[d], counts[d], addr[d], pv, cfg_loc)
        out_p = sb.force_plain(feats[d], dens[d], counts[d], addr[d], pv,
                               cfg_loc)
        np.testing.assert_allclose(_at(dens[d], occ), _at(dens_p, occ),
                                   **TOL)
        np.testing.assert_allclose(_at(out[d], occ), _at(out_p, occ), **TOL)
    assert halo > 0, "no shard had a filled left halo"

    step = domain.make_domain_step(mesh, cfg)
    got, got_act, lost = step(states, active, params)
    params_c, mesh_c, states_c, active_c = setup("cpu")
    want, want_act, _ = domain.make_domain_step(mesh_c, cfg)(
        states_c, active_c, params_c)
    assert float(lost) == 0.0
    for a, b in zip(got_act, want_act):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.pos.cpu().numpy(), b.pos.numpy(), **TOL)


def test_wrappers_refuse_mixed_devices(cuda_device):
    cfg, params, state = wt.scenes.build("mini-3d", device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    planes, counts, addr, _ = sb._build_slab_buckets(
        state.predicted, state.vel, params, cfg)
    pv = sb._param_vector(params, coeffs)
    with pytest.raises(ValueError, match="one device"):
        sb.run_density(planes, counts.cpu(), addr, pv, cfg)


def _same_bits(a, b):
    """Bit for bit (the planes' unwritten slots may hold NaN)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _record_build(monkeypatch):
    """Patch the build's wrapper (``ops/cuda/build.py::run_build``) to keep
    a copy of every call's inputs and outputs, as (inputs, outputs)."""
    from water_sandbox_tpu_torch.ops.cuda import build
    calls = []
    real = build.run_build

    def rec(*args):
        ins = [tuple(_cloned(b) for b in a) if isinstance(a, tuple)
               else _cloned(a) for a in args]
        out = real(*args)
        calls.append((ins, tuple(_cloned(t) for t in out)))
        return out

    monkeypatch.setattr(build, "run_build", rec)
    return calls


def _hold_build(got, args):
    """``_build_core``'s seven outputs, made by the build's kernel, against
    the plain chain (``build_plain``) on the kernel's inputs ``args``, bit
    for bit."""
    from water_sandbox_tpu_torch.ops.cuda import build
    want = (*build.build_plain(*args), args[0])
    for name, a, b in zip(("planes", "counts", "flat", "order", "srows",
                           "overflow", "sorted_col"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _same_bits(a, b), name


@pytest.mark.parametrize("rows", ["plain", "carry", "key bound"])
@pytest.mark.parametrize("cap", [3, 96])
@pytest.mark.parametrize("dim", [2, 3])
def test_build_kernel_matches_plain(cuda_device, monkeypatch, dim, cap,
                                    rows):
    """The build's kernel (csrc/sph_build.cu) against the plain chain on
    the same sort, bit for bit on all seven outputs: 3,001 rows (not a
    multiple of the kernel's 256-row block), at a capacity that overflows
    (runs longer than cap) and one that does not; as the single-device
    build without a carry and with the sorted step's (positions and
    bit-cast ids, two blocks), and as the domain step's per-shard build
    (``build_local_slab_buckets``), whose inactive quarter of the rows is
    keyed at the key bound in one run longer than either capacity, takes
    no slot and is no overflow; then the same keys with one row's position
    NaN, which holds its slot and is left out of its lane's count."""
    from water_sandbox_tpu_torch.ops.cuda import build
    rng = np.random.default_rng(20 + dim + cap)
    n = 3001
    pred = ((rng.random((n, dim)) - 0.5) * 2.0).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    cfg = SimConfig(n=n, dim=dim, grid_dims=(14,) * dim, cell_capacity=cap)
    p, v = (torch.from_numpy(pred).to(cuda_device),
            torch.from_numpy(vel).to(cuda_device))
    blocks = ()
    if rows == "carry":
        ids = torch.from_numpy(rng.permutation(n).astype(np.int32))
        blocks = (p + 0.01, ids.to(cuda_device).view(torch.float32)[:, None])
    calls = _record_build(monkeypatch)
    _build.reset_launches()
    if rows == "key bound":
        active = torch.from_numpy(
            (rng.random(n) >= 0.25).astype(np.float32)).to(cuda_device)
        origin = torch.full((dim,), -1.0, device=cuda_device)
        sb.build_local_slab_buckets(p, v, active, origin, 14, 0, params, cfg)
        got = (*calls[0][1], calls[0][0][0])
        inactive = int((got[6] == calls[0][0][-1]).sum())
        assert inactive == int((active == 0).sum()) > cap
    else:
        got = sb._build_core(p, v, params, cfg, carry=blocks)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sph_build"] == 1
    _hold_build(got, calls[0][0])
    assert (int(got[5]) > 0) == (cap == 3)
    assert int(got[4].shape[1]) == 2 * dim + (dim + 1 if blocks else 0)

    sorted_col, order, _, v_, carry_, *geom = calls[0][0]
    L = sb._geometry(cfg).L
    held = (got[2] < sb._cap_pad(cap) * L).nonzero()[:, 0]
    row = int(order[held[len(held) // 2]])         # a row with a slot
    p_nan = p.clone()
    p_nan[row, 0] = float("nan")
    args = [sorted_col, order, p_nan, v_, carry_, *geom]
    nan_got = build.run_build(*args)
    torch.cuda.synchronize()
    _hold_build((*nan_got, sorted_col), args)
    assert float(nan_got[1].sum()) == float(got[1].sum()) - 1


def test_build_kernel_matches_plain_at_the_settled_flagship(cuda_device,
                                                            monkeypatch):
    """The build's kernel against the plain chain bit for bit at the
    flagship's state after 600 steps, on the call the sorted step makes
    (its inputs and outputs recorded in one eager step): the carry is the
    positions and the bit-cast ids, two blocks."""
    cfg, params, state = wt.scenes.build("moving-container-256k",
                                         device=cuda_device)
    state = wt.rollout(state, params, cfg, 600)
    calls = _record_build(monkeypatch)
    wt.step(state, params, cfg)
    torch.cuda.synchronize()
    assert len(calls) == 1
    args, out = calls[0]
    assert [tuple(b.shape) for b in args[4]] == [(cfg.n, 3), (cfg.n, 1)]
    _hold_build((*out, args[0]), args)
    assert out[0].shape[1:] == (sb._cap_pad(cfg.cell_capacity),
                                sb._geometry(cfg).L)


def _integrate_params(dev, dim, box, field, limit):
    """Parameters of the integrate kernel's cases: a box translating and
    yawing or static, the field active (strength 25) or of strength 0, the
    speed limiter at 3.0 or off (0)."""
    moving = box == "moving"
    container = wt.Container.create(
        (0.3, -0.2, 0.1)[:dim], (6.0, 4.0, 5.0)[:dim],
        velocity=(0.4, 0.1, -0.2)[:dim] if moving else None,
        angular_velocity=0.3 if moving else 0.0,
        angle=0.25 if moving else 0.0, device=dev)
    fld = wt.InteractionField.create((0.5, 0.0, -0.5)[:dim],
                                     25.0 if field == "on" else 0.0, 2.0,
                                     device=dev)
    return wt.SimParams.create(dim=dim, max_speed=3.0 if limit == "on"
                               else 0.0, container=container, field=fld,
                               device=dev)


def _integrate_rows(dev, dim, n, seed):
    """(pos, vel, acc) as the sorted step hands them over: pos and vel
    column slices of a wider block of sorted rows, acc a transposed
    gather. Positions spread to twice the box's size (rows beyond every
    wall, on both sides); row 0 sits on the field's centre (r == 0)."""
    rng = np.random.default_rng(seed)
    block = torch.from_numpy((rng.standard_normal((n, 3 * dim + 1)) * 4.0)
                             .astype(np.float32)).to(dev)
    block[0, 2 * dim:3 * dim] = torch.tensor((0.5, 0.0, -0.5)[:dim])
    acc = torch.from_numpy((rng.standard_normal((dim, n)) * 30.0)
                           .astype(np.float32)).to(dev)
    return block[:, 2 * dim:3 * dim], block[:, dim:2 * dim], acc.T


@pytest.mark.parametrize("limit", ["on", "off"])
@pytest.mark.parametrize("field", ["on", "off"])
@pytest.mark.parametrize("box", ["moving", "static"])
@pytest.mark.parametrize("dim", [2, 3])
def test_integrate_kernel_matches_chain(cuda_device, dim, box, field, limit):
    """The integrate kernel (csrc/sph_integrate.cu) against the ATen chain
    (``integrate_plain``) on the same CUDA tensors, bit for bit on pos, vel
    and predicted: strided inputs as the sorted step passes them and their
    contiguous copies, n = 1 and 3,001 (not a multiple of the 256-row
    block), at two times of the box's pose; one launch a call, contiguous
    (n, dim) outputs."""
    from water_sandbox_tpu_torch.ops import integrate as integ
    params = _integrate_params(cuda_device, dim, box, field, limit)
    half = params.container.half_size.cpu()
    for n in (1, 3001):
        pos, vel, acc = _integrate_rows(cuda_device, dim, n, 30 + dim)
        if n > 1:
            assert not (pos.is_contiguous() or vel.is_contiguous()
                        or acc.is_contiguous())
            rel = pos.cpu() - params.container.center.cpu()
            assert bool(((rel < -2 * half).any(0)
                         & (rel > 2 * half).any(0)).all())
            assert bool((vel.norm(dim=1) > 3.0).any())
        for t in (1.37, 250.0):
            t_new = torch.tensor(t, device=cuda_device)
            want = integ.integrate_plain(pos, vel, acc, params, t_new)
            for rows in ((pos, vel, acc),
                         tuple(x.contiguous() for x in (pos, vel, acc))):
                _build.reset_launches()
                got = integ.integrate(*rows, params, t_new)
                torch.cuda.synchronize()
                assert _build.LAUNCHES["sph_integrate"] == 1
                for name, a, b in zip(("pos", "vel", "predicted"), got,
                                      want):
                    assert a.shape == (n, dim) and a.is_contiguous()
                    assert _same_bits(a, b), (name, n, t)


@pytest.mark.parametrize("scene, steps", [("reference-cube", 100),
                                          ("moving-container-256k", 10)])
def test_captured_step_integrates_as_the_chain(cuda_device, monkeypatch,
                                               scene, steps):
    """A captured StepGraph of the scene, from its start (the cube's 100
    steps fall through its landing), against the same graph captured with
    ``integrate`` patched to the ATen chain: every state field bit for
    bit; the kernel launches once a replay, the chain's graph none."""
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.core.state import FluidState
    from water_sandbox_tpu_torch.ops import integrate as integ
    from water_sandbox_tpu_torch.ops.cuda import graph
    cfg, params, state = wt.scenes.build(scene, device=cuda_device)
    cfg = cfg.resolved()

    def run():
        g = graph.StepGraph(state.clone(), _map_tensors(params, torch.clone),
                            cfg)
        g.run(steps)
        torch.cuda.synchronize()
        return g

    got = run()
    monkeypatch.setattr(integ, "integrate", integ.integrate_plain)
    want = run()
    assert got.per_replay["sph_integrate"] == 1
    assert "sph_integrate" not in want.per_replay
    for f in dataclasses.fields(FluidState):
        assert _same_bits(getattr(got.state, f.name),
                          getattr(want.state, f.name)), f.name
    assert int(got.state.step_count) == steps


def test_integrate_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    """A wrong dtype, mismatched shapes, a dim the kernel has no variant
    for, parameters of another dim and mixed devices raise before any
    launch."""
    from water_sandbox_tpu_torch.ops.cuda import integrate as ik
    params = _integrate_params(cuda_device, 3, "moving", "on", "on")
    pos, vel, acc = _integrate_rows(cuda_device, 3, 64, 0)
    t = torch.tensor(1.0, device=cuda_device)
    wide = torch.zeros((64, 4), device=cuda_device)
    _build.reset_launches()
    for args, match in (
            ((pos.double(), vel, acc, params), "float32"),
            ((pos, vel[:10], acc, params), "differ"),
            ((wide, wide, wide, params), "dim must be 2 or 3"),
            ((pos[:, :2], vel[:, :2], acc[:, :2], params), "parameters"),
            ((pos, vel, acc.cpu(), params), "one device")):
        with pytest.raises(ValueError, match=match):
            ik.run_integrate(*args, t)
    assert _build.LAUNCHES["sph_integrate"] == 0


# Radii of the parameter kernels' bit test beside every scene's own.
_RADII = (0.05, 0.1, 0.25, 0.3317, 0.7, 1.0, 1.5, 2.0)


class _AtenOps(TorchDispatchMode):
    """Records the ATen ops dispatched while it is open."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dim", [2, 3])
def test_parameter_kernels_match_the_chain(cuda_device, dim):
    """The coefficient and parameter-vector kernels (csrc/sph_coeffs.cu)
    against the ATen chains (``coeffs_plain``, ``param_vector_plain``) on
    the same CUDA tensors, bit for bit on the five coefficients and the
    (1, 16) vector: every scene of this dim with its own parameters
    (mini-3d among them) and radii from 0.05 to 2.0. One launch of each a
    call, and no ATen op beside the outputs' allocation and views."""
    from water_sandbox_tpu_torch.core.params import coeffs_plain
    cases = []
    for name in wt.scenes.names():
        cfg, params, _ = wt.scenes.build(name, device=cuda_device)
        if cfg.dim == dim:
            cases.append((name, params))
    assert cases
    cases += [(f"h={h}", wt.SimParams.create(dim=dim, smoothing_radius=h,
                                             device=cuda_device))
              for h in _RADII]
    for label, params in cases:
        h = params.smoothing_radius
        _build.reset_launches()
        with _AtenOps() as rec:
            got = KernelCoeffs.from_radius(h, dim)
            pv = sb._param_vector(params, got)
        torch.cuda.synchronize()
        assert _launched("sph_coeffs", "sph_param_vector") == (1, 1), label
        assert set(rec.ops) <= {"aten.empty.memory_format",
                                "aten.unbind.int"}, (label, rec.ops)
        want = coeffs_plain(h, dim)
        for f in dataclasses.fields(KernelCoeffs):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.shape == () and _same_bits(a, b), (label, f.name)
        pv_plain = sb.param_vector_plain(params, want)
        assert pv.shape == (1, 16) and _same_bits(pv, pv_plain), label


def test_tuned_radius_reaches_the_parameter_kernels_on_replay(cuda_device):
    """Inside a captured StepGraph, ``Simulation.tune(smoothing_radius=...)``
    is read by the parameter kernels on the next replay with no recapture:
    the replays equal eager steps under the tuned radius bit for bit, and
    differ from steps under the old one."""
    from water_sandbox_tpu_torch.core.params import _map_tensors
    cfg, params, state = wt.scenes.build("mini-3d", device=cuda_device)
    sim = wt.Simulation(cfg, _map_tensors(params, torch.clone), state)
    sim.run(2)
    g, plain = sim.graph, sim.graph.graph
    assert g.per_replay["sph_coeffs"] == g.per_replay["sph_param_vector"] == 1
    start = sim.state.clone()
    sim.tune(smoothing_radius=0.24)
    sim.run(2)
    torch.cuda.synchronize()
    assert sim.graph is g and g.graph is plain
    tuned, old = start, start
    for _ in range(2):
        tuned = wt.step(tuned, params.replace(smoothing_radius=0.24), cfg)
        old = wt.step(old, params, cfg)
    for f in ("pos", "vel", "density", "near_density", "acc"):
        assert _same_bits(getattr(sim.state, f), getattr(tuned, f)), f
    assert not torch.equal(sim.state.density, old.density)


def test_flipped_near_derivative_negates_slot_4_on_the_card(cuda_device):
    """``golden.flipped_near_derivative`` reaches the kernels through
    ``from_radius`` on the card as on the CPU: inside it the parameter
    vector's ``pow3_der`` slot (4) is negated, every other slot as before;
    after it the vector is the plain one again."""
    from water_sandbox_tpu_torch import golden
    params = wt.SimParams.create(dim=3, device=cuda_device)
    h = params.smoothing_radius
    before = sb._param_vector(params, KernelCoeffs.from_radius(h, 3))
    with golden.flipped_near_derivative():
        flipped = sb._param_vector(params, KernelCoeffs.from_radius(h, 3))
    after = sb._param_vector(params, KernelCoeffs.from_radius(h, 3))
    torch.cuda.synchronize()
    assert sb._P_POW3_DER == 4 and float(before[0, 4]) > 0
    want = before.clone()
    want[0, 4] = -want[0, 4]
    assert _same_bits(flipped, want) and _same_bits(after, before)


def _crowded_rescue(device, dim):
    """A dense random cloud at cell capacity 4 (hundreds of rows overflow)
    with its density planes, gathered densities and rescue selection, on
    ``device``."""
    from water_sandbox_tpu_torch.ops import rescue
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    rng = np.random.default_rng(11)
    pred = ((rng.random((3000, dim)) - 0.5) * 2.0).astype(np.float32)
    vel = rng.standard_normal((3000, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=4, rescue_capacity=512, chunk=512)
    p, v = (torch.from_numpy(pred).to(device),
            torch.from_numpy(vel).to(device))
    planes, counts, flat, order, _, overflow, scol = sb._build_core(
        p, v, params, cfg)
    addr = sb._particle_addr(flat, order)
    dropped = addr == sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    pv = sb._param_vector(params, coeffs)
    dens = sb.density_plain(planes, counts, addr, pv, cfg)
    den, nden = sb.gather_density(dens, addr, dropped, params)
    sel, slot, count = rescue.rescue_selection(dropped, overflow, 512)
    walk = rk.cell_walk(sel, count, scol, order)
    acc = torch.from_numpy(rng.standard_normal((3000, dim)).astype(
        np.float32)).to(device)
    return (p, v, params, coeffs, cfg, addr, pv, dens, den, nden, sel, slot,
            count, acc, overflow, walk)


@pytest.mark.parametrize("dim", [2, 3])
def test_rescue_kernels_match_plain(cuda_device, dim):
    """R1 and R2 (csrc/sph_rescue.cu) against their plain versions on the
    same CUDA tensors, past the budget of 512 rows (budget exceeded rows
    excluded); two launches give the same bits; with count 0 both leave
    den, nden, the density planes and acc bit-untouched."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    (p, v, params, coeffs, cfg, addr, pv, dens, den, nden, sel, slot, count,
     acc, overflow, walk) = _crowded_rescue(cuda_device, dim)
    assert int(overflow) > 512
    outs = []
    for run in (rk.rescue_density, rk.density_plain, rk.rescue_density):
        d, nd, ds = den.clone(), nden.clone(), dens.clone()
        args = (p, sel, slot, count, addr, d, nd, ds, params, coeffs)
        if run is rk.rescue_density:
            run(*args, pv, cfg, walk)
        else:
            run(*args, cfg)
        outs.append((d, nd, ds))
    torch.cuda.synchronize()
    occ = addr[addr < dens[0].numel()].long()
    for a, b in zip(outs[0], outs[2]):
        assert _same_bits(a, b)
    for a, b in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    np.testing.assert_allclose(_at(outs[0][2], occ), _at(outs[1][2], occ),
                               **TOL)
    d, nd, _ = outs[1]
    prs = params.pressure_scalar * (d - params.target_density)
    nprs = params.near_pressure_scalar * nd
    got, want = acc.clone(), acc.clone()
    _build.reset_launches()
    rk.rescue_force(p, v, d, nd, prs, nprs, sel, slot, count, got, params,
                    coeffs, pv, cfg, walk)
    rk.force_plain(p, v, d, nd, prs, nprs, sel, slot, count, want, params,
                   coeffs, cfg)
    torch.cuda.synchronize()
    assert _launched("sph_rescue_density", "sph_rescue_force") == (0, 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)

    zero = torch.zeros_like(count)
    d, nd, ds, a = den.clone(), nden.clone(), dens.clone(), acc.clone()
    rk.rescue_density(p, sel, slot, zero, addr, d, nd, ds, params, coeffs,
                      pv, cfg, walk)
    rk.rescue_force(p, v, d, nd, prs, nprs, sel, slot, zero, a, params,
                    coeffs, pv, cfg, walk)
    torch.cuda.synchronize()
    for x, y in ((d, den), (nd, nden), (ds, dens), (a, acc)):
        assert _same_bits(x, y)


def _edge_rescue(device, dim, rows, budget):
    """A cloud that overflows its grid on every side (the anchor inside it,
    the grid ending before it; in 3-D gy·gz == S_pad, where an unclamped
    y ± 1 would alias into the next slab) at cell capacity 4, with its
    rescue inputs in ``rows`` order ("sorted": the build's order, the
    sorted step's; "particle": bucket_sph's) and a rescue budget of
    ``budget`` rows ("all": the whole overflow, count == cap)."""
    from water_sandbox_tpu_torch.ops import rescue
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    rng = np.random.default_rng(23)
    box, grid, n = (((1.6, 2.6, 7.5), (6, 8, 32), 6000) if dim == 3
                    else ((2.6, 3.0), (8, 10), 3000))
    pred = (rng.random((n, dim)) * np.asarray(box, np.float32)).astype(
        np.float32)
    params = wt.SimParams.create(dim=dim, device=device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=n, dim=dim, grid_dims=grid, cell_capacity=4,
                    rescue_capacity=n)
    p = torch.from_numpy(pred).to(device)
    v = torch.from_numpy(rng.standard_normal((n, dim)).astype(
        np.float32)).to(device)
    origin = torch.full((dim,), 0.3, device=device)
    planes, counts, flat, order, srows, overflow, scol = sb._build_core(
        p, v, params, cfg, origin=origin)
    if rows == "sorted":
        p, v = srows[:, :dim].contiguous(), srows[:, dim:].contiguous()
        addr, order = flat, None
    else:
        addr = sb._particle_addr(flat, order)
    dropped = addr == sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    pv = sb._param_vector(params, coeffs)
    dens = sb.density_plain(planes, counts, addr, pv, cfg)
    den, nden = sb.gather_density(dens, addr, dropped, params)
    cap = int(overflow) if budget == "all" else budget
    sel, slot, count = rescue.rescue_selection(dropped, overflow, cap)
    assert int(count) == cap
    walk = rk.cell_walk(sel, count, scol, order)
    acc = torch.from_numpy(rng.standard_normal((n, dim)).astype(
        np.float32)).to(device)
    return (p, v, params, coeffs, cfg, addr, pv, dens, den, nden, sel, slot,
            count, acc, walk)


@pytest.mark.parametrize("budget", [1, 300, "all"])
@pytest.mark.parametrize("rows", ["sorted", "particle"])
@pytest.mark.parametrize("dim", [2, 3])
def test_rescue_walk_matches_plain(cuda_device, dim, rows, budget):
    """The cell-list walk of R1 and R2 against their all-pairs plain
    versions with keys clamped at every edge of the grid, on the sorted
    step's rows and in particle order, at 1 rescued row, 300, and the whole
    overflow (count == cap); two launches give the same bits, and count 0
    leaves den, nden, the density planes and acc bit-untouched."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    (p, v, params, coeffs, cfg, addr, pv, dens, den, nden, sel, slot, count,
     acc, walk) = _edge_rescue(cuda_device, dim, rows, budget)
    outs = []
    for run in (rk.rescue_density, rk.rescue_density, rk.density_plain):
        d, nd, ds = den.clone(), nden.clone(), dens.clone()
        args = (p, sel, slot, count, addr, d, nd, ds, params, coeffs)
        if run is rk.rescue_density:
            run(*args, pv, cfg, walk)
        else:
            run(*args, cfg)
        outs.append((d, nd, ds))
    torch.cuda.synchronize()
    occ = addr[addr < dens[0].numel()].long()
    for a, b in zip(outs[0], outs[1]):
        assert _same_bits(a, b)
    for a, b in zip(outs[0][:2], outs[2][:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    np.testing.assert_allclose(_at(outs[0][2], occ), _at(outs[2][2], occ),
                               **TOL)
    d, nd, _ = outs[2]
    prs = params.pressure_scalar * (d - params.target_density)
    nprs = params.near_pressure_scalar * nd
    got, again, want = acc.clone(), acc.clone(), acc.clone()
    for a in (got, again):
        rk.rescue_force(p, v, d, nd, prs, nprs, sel, slot, count, a, params,
                        coeffs, pv, cfg, walk)
    rk.force_plain(p, v, d, nd, prs, nprs, sel, slot, count, want, params,
                   coeffs, cfg)
    torch.cuda.synchronize()
    assert _same_bits(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)

    zero = torch.zeros_like(count)
    d, nd, ds, a = den.clone(), nden.clone(), dens.clone(), acc.clone()
    rk.rescue_density(p, sel, slot, zero, addr, d, nd, ds, params, coeffs,
                      pv, cfg, walk)
    rk.rescue_force(p, v, d, nd, prs, nprs, sel, slot, zero, a, params,
                    coeffs, pv, cfg, walk)
    torch.cuda.synchronize()
    for x, y in ((d, den), (nd, nden), (ds, dens), (a, acc)):
        assert _same_bits(x, y)


def test_captured_rollout_matches_eager(cuda_device):
    """The kernel pipeline's captured step (ops/cuda/graph.py) against the
    eager step on the card, bit for bit over 6 steps with the rescue firing
    past its budget; the eager step runs with no synchronisation (sync
    debug mode "error"); each replay counts one launch of each of the eight
    kernels; a Simulation replays its own graph, and tune takes effect
    without a recapture."""
    cfg, params, state = wt.scenes.build(
        "mini-3d", device=cuda_device, sorted_state=True, cell_capacity=4,
        rescue_capacity=16)
    from water_sandbox_tpu_torch.ops.cuda import graph
    s = wt.step(state, params, cfg)                       # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = state
        for _ in range(6):
            s = wt.step(s, params, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _build.reset_launches()
    got = wt.rollout(state, params, cfg, 6)
    torch.cuda.synchronize()
    for f in ("pos", "vel", "density", "ids", "acc", "overflow_total"):
        assert torch.equal(getattr(got, f), getattr(s, f)), f
    assert float(s.overflow_total) > 0
    assert _launched("sph_density", "sph_force", "sph_build") == (6, 6, 6)
    g = graph.StepGraph(state.clone(), params, cfg)
    g.run(1)
    assert g.per_replay == {"sph_coeffs": 1, "sph_param_vector": 1,
                            "sph_build": 1, "sph_density": 1,
                            "sph_force": 1, "sph_rescue_density": 1,
                            "sph_rescue_force": 1, "sph_integrate": 1}
    sim = wt.Simulation(cfg, params, state)
    sim.run(3)
    sim.tune(viscosity_strength=0.5)
    sim.run(3)
    ref = wt.rollout(wt.rollout(state, params, cfg, 3),
                     params.replace(viscosity_strength=0.5), cfg, 3)
    assert torch.equal(sim.state.pos, ref.pos)


def _cloned(x):
    """A copy of a call's argument: tensors cloned, named tuples of
    tensors (the domain rescue's Rows, Queries) rebuilt from clones."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cloned(e) for e in x))
    return x


def _record_domain_rescue(monkeypatch):
    """Patch D1's and D2's wrappers to keep a copy of every call's inputs
    (then run as before): {"density": [args...], "force": [args...]}."""
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    calls = {"density": [], "force": []}
    for half, name in (("density", "rescue_density"),
                       ("force", "rescue_force")):
        real = getattr(dr, name)

        def rec(*args, _real=real, _half=half):
            calls[_half].append([_cloned(a) for a in args])
            _real(*args)

        monkeypatch.setattr(dr, name, rec)
    return calls


def _domain_cloud(dev, dim, cap):
    """A random cloud on 4 shards of ``dev`` at cell capacity ``cap`` and
    a rescue budget of 64 rows a shard: it reaches past the grid in y (and
    z), so keys clamp at both ends, and every shard has a slab edge."""
    from water_sandbox_tpu_torch.core.params import Container
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    rng = np.random.default_rng(40 + dim)
    n, size, grid = ((3000, (2.5, 1.5, 1.5), (12, 8, 8)) if dim == 3
                     else (1500, (2.5, 1.5), (12, 8)))
    params = wt.SimParams.create(dim=dim, device=dev, container=(
        Container.create((0.0,) * dim, size, device=dev)))
    cfg = SimConfig(n=n, dim=dim, grid_dims=grid, cell_capacity=cap,
                    rescue_capacity=64)
    origin = domain._grid_origin_static(params, cfg).cpu().numpy()
    h = float(params.smoothing_radius)
    spill = np.r_[0.0, [0.2] * (dim - 1)]          # past the grid in y, z
    pts = (origin - spill + rng.random((n, dim))
           * (np.asarray(grid) * h + 2 * spill)).astype(np.float32)
    mesh = mesh_mod.make_mesh(4, dev)
    states, active = domain.shard_state(wt.init_state(pts, device="cpu"),
                                        mesh, cfg, params, slack=2.0)
    return params, cfg, mesh, states, active


def _hold(got, want):
    """rtol 2e-4, atol 2e-4·max(1, max|plain|)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(
        got, want, rtol=2e-4,
        atol=2e-4 * max(1.0, float(np.abs(want).max(initial=0.0))))


@pytest.mark.parametrize("case", ["overflow", "count 0"])
@pytest.mark.parametrize("dim", [2, 3])
def test_domain_rescue_kernels_match_plain(cuda_device, monkeypatch, dim,
                                           case):
    """D1 and D2 (csrc/sph_domain_rescue.cu) against their plain versions
    on the inputs one domain step on the card gives them, shard by shard:
    a cloud whose keys clamp at the grid's y (and z) ends, past the
    rescue's budget (cell capacity 2), and with no overflow at all (cell
    capacity 64: every gate 0, and the kernels change nothing, bit for
    bit)."""
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    from water_sandbox_tpu_torch.parallel import domain
    params, cfg, mesh, states, active = _domain_cloud(
        cuda_device, dim, 2 if case == "overflow" else 64)
    calls = _record_domain_rescue(monkeypatch)
    _build.reset_launches()
    domain.make_domain_step(mesh, cfg)(states, active, params)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert _launched("sph_domain_rescue_density",
                     "sph_domain_rescue_force") == (4, 4)
    gates = [int(a[3].count) for a in calls["density"]]
    assert (min(gates) > 0) if case == "overflow" else (max(gates) == 0)
    for args in calls["density"]:
        pred, walk, addr, q, feats, dens, qden, qnden, p, c, pv, cl = args
        k = [_cloned(a) for a in args]
        dr.rescue_density(*k)
        dr.density_plain(pred, walk, addr, q, feats, dens, qden, qnden, p,
                         c, cl)
        torch.cuda.synchronize()
        if case == "count 0":
            assert _same_bits(k[5], args[5]) and _same_bits(k[6], qden)
            continue
        PL = dens[0].numel()
        res = addr[addr < PL].long()
        for plane in range(6):
            _hold(k[5].view(6, -1)[plane, res], dens.view(6, -1)[plane, res])
        mine = q.valid[:qden.shape[0]]
        _hold(k[6][mine], qden[mine])
        _hold(k[7][mine], qnden[mine])
    for args in calls["force"]:
        k = [_cloned(a) for a in args]
        acc0 = args[12].clone()
        dr.rescue_force(*k)
        dr.force_plain(*args[:15], args[16])
        torch.cuda.synchronize()
        if case == "count 0":
            assert _same_bits(k[12], acc0)
            continue
        _hold(k[12], args[12])
        assert not torch.equal(k[12], acc0)


def test_domain_graph_replays_the_eager_step(cuda_device):
    """The domain step captured as one CUDA graph (ops/cuda/graph.py::
    DomainGraph) on 8 shards of one card, with the cross-shard rescue on
    every step (cell capacity 1), against the eager step: bit for bit
    over 6 steps; a replay counts one launch of K1, K3, D1 and D2 a shard;
    DistributedSimulation replays, and tune needs no recapture."""
    from water_sandbox_tpu_torch.core.params import Container, _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    from water_sandbox_tpu_torch.runtime.distributed import (
        DistributedSimulation)
    pts = wt.cube_fluid(8, 4, 4)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(24, 8, 8),
                    cell_capacity=1, rescue_capacity=512)
    params = wt.SimParams.create(dim=3, device=cuda_device, container=(
        Container.create((0.0, 0.0, 0.0), (5.0, 1.8, 1.8),
                         device=cuda_device)))
    state = wt.init_state(pts, vel, device="cpu")
    mesh = mesh_mod.make_mesh(8, cuda_device)
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg)
    e_states, e_active = states, active
    for _ in range(6):
        e_states, e_active, _ = step(e_states, e_active, params)
    g = graph.DomainGraph(step, [s.clone() for s in states],
                          [a.clone() for a in active],
                          _map_tensors(params, torch.clone), mesh)
    assert g.captures
    _build.reset_launches()
    g.run(6)
    torch.cuda.synchronize()
    assert g.per_replay == {"sph_coeffs": 8, "sph_param_vector": 8,
                            "sph_build": 8, "sph_density": 8, "sph_force": 8,
                            "sph_domain_rescue_density": 8,
                            "sph_domain_rescue_force": 8, "sph_integrate": 8}
    assert _build.LAUNCHES["sph_domain_rescue_density"] == 48
    for a, b in zip(g.states, e_states):
        for f in ("pos", "vel", "density", "ids", "acc"):
            assert _same_bits(getattr(a, f), getattr(b, f)), f
    for a, b in zip(g.active, e_active):
        assert torch.equal(a, b)
    assert float(e_states[0].overflow_total) == 0.0

    sim = DistributedSimulation(cfg, params, state, mesh=mesh, slack=8.0)
    assert sim.execution == "captured"
    sim.run(3)
    sim.tune(viscosity_strength=0.5)
    sim.run(3)
    ref, ref_act = [s.clone() for s in states], [a.clone() for a in active]
    for i in range(6):
        ps = params if i < 3 else params.replace(viscosity_strength=0.5)
        ref, ref_act, _ = step(ref, ref_act, ps)
    for a, b in zip(sim.states, ref):
        assert _same_bits(a.pos, b.pos)
    assert sim.stats()["execution"] == "captured"


def test_plain_domain_rollout_is_captured(cuda_device):
    """The plain pair-block domain step (``use_pallas=False``) reads nothing
    on the host since its occupied-cell walk has a fixed size: its eager
    step raises nothing under sync debug "error", and
    ``make_domain_rollout`` captures it and replays it bit for bit, with
    the cross-shard rescue on every step (cell capacity 1)."""
    from water_sandbox_tpu_torch.core.params import Container
    from water_sandbox_tpu_torch.ops.cuda import graph
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    pts = wt.cube_fluid(8, 4, 4)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(24, 8, 8),
                    cell_capacity=1, rescue_capacity=512)
    params = wt.SimParams.create(dim=3, device=cuda_device, container=(
        Container.create((0.0, 0.0, 0.0), (5.0, 1.8, 1.8),
                         device=cuda_device)))
    state = wt.init_state(pts, vel, device="cpu")
    mesh = mesh_mod.make_mesh(8, cuda_device)
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg, use_pallas=False)
    e_states, e_active = states, active
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            e_states, e_active, _ = step(e_states, e_active, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g = graph.DomainGraph(step, [s.clone() for s in states],
                          [a.clone() for a in active], params, mesh)
    g.run(4)
    torch.cuda.synchronize()
    assert g.graph is not None
    for a, b in zip(g.states, e_states):
        for f in ("pos", "vel", "density", "ids", "acc"):
            assert _same_bits(getattr(a, f), getattr(b, f)), f
    out, _, _ = domain.make_domain_rollout(mesh, cfg, use_pallas=False)(
        states, active, params, 4)
    assert all(_same_bits(a.pos, b.pos) for a, b in zip(out, e_states))


def test_device_if_node_runs_its_body_only_where_pred_holds(cuda_device):
    """graph.device_if under capture: an IF conditional node
    (csrc/graph_if.cu) whose body (a sort, a tensor allocated inside it,
    copies) runs on the replays where the () bool predicate holds and is
    skipped where it is 0; the rest of the graph runs on every replay; the
    body's runs are counted on the device; outside a capture the predicate
    is read on the host. The capture runs on the stream the branches were
    given (torch's streams come round robin from a pool, so the two can
    meet): the body must move to another."""
    from water_sandbox_tpu_torch.ops.cuda import graph
    keys = torch.randint(0, 1 << 20, (4096,), dtype=torch.int32,
                         device=cuda_device)
    out = torch.zeros_like(keys)
    x = torch.zeros(8, device=cuda_device)
    pred = torch.zeros((), dtype=torch.bool, device=cuda_device)
    br = graph.Branches(cuda_device, ("body",))

    def body():
        s = torch.sort(keys).values          # allocated inside the body
        out.copy_(s)
        x.add_(1.0)

    def step():
        x.add_(0.5)
        graph.device_if(pred, body, br, "body")

    br.force = True
    step()                                   # warm-up: the body runs
    br.force = False
    torch.cuda.synchronize()
    x.zero_()
    out.zero_()
    br.fired["body"].zero_()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=br.stream):
        step()
    for p in (False, False, True, False, True):
        pred.fill_(p)
        g.replay()
    torch.cuda.synchronize()
    assert int(br.fired["body"]) == 2
    assert float(x[0]) == 5 * 0.5 + 2
    assert torch.equal(out, torch.sort(keys).values)
    out.zero_()
    pred.fill_(False)
    g.replay()
    torch.cuda.synchronize()
    assert int(out.abs().sum()) == 0 and int(br.fired["body"]) == 2
    step()                                   # eager: pred read, 0
    pred.fill_(True)
    step()                                   # eager: runs
    torch.cuda.synchronize()
    assert int(br.fired["body"]) == 3


def test_captured_incremental_step_equals_eager(cuda_device):
    """IncrementalGraph on the card against the eager incremental steps, bit
    for bit over two runs (7 and 3 steps) at k = 3 and cell capacity 4
    (rebuild and drop steps); the eager steps synchronise nowhere but in
    device_if's reads; K1/K2 launch once a replay, R1/R2 once a drop step
    (the branch's device count)."""
    from water_sandbox_tpu_torch.ops.cuda import graph
    from water_sandbox_tpu_torch.ops.cuda import incremental as inc
    cfg, params, state = wt.scenes.build(
        "mini-3d", device=cuda_device, neighbor_mode="pallas",
        incremental_rebuild=3, cell_capacity=4, rescue_capacity=64)
    cfg = cfg.resolved()
    br = graph.Branches(cuda_device, graph.IncrementalGraph.BRANCHES)
    e = state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for steps in (7, 3):
            cache = inc.build_cache(e.predicted, e.vel, params, cfg)
            for i in range(steps):
                e, cache = inc.step_inc(e, cache, params, cfg,
                                        i == steps - 1, br)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g = graph.IncrementalGraph(state.clone(), params, cfg)
    _build.reset_launches()
    g.run(7)
    g.run(3)
    torch.cuda.synchronize()
    for f in ("pos", "vel", "predicted", "acc", "density", "ids",
              "overflow_total"):
        assert _same_bits(getattr(g.state, f), getattr(e, f)), f
    for a, b in zip(g.cache, cache):
        assert _same_bits(a, b)
    fired = g.fired()
    assert fired == {k: int(v) for k, v in br.fired.items()}
    assert fired["rebuild"] >= 2 and fired["drop"] >= 5
    assert g.per_replay == {"sph_coeffs": 1, "sph_param_vector": 1,
                            "sph_density": 1, "sph_force": 1}
    assert _launched("sph_density", "sph_force") == (10, 10)
    assert _launched("sph_rescue_density",
                     "sph_rescue_force") == (fired["drop"],) * 2


def _bucket_grid_case(dev, cap=3):
    """mini-3d in bucket_grid mode at cell capacity ``cap`` with a rescue
    budget of 64 rows: the rescue fires on every step."""
    cfg, params, state = wt.scenes.build("mini-3d", device=dev,
                                         neighbor_mode="bucket_grid",
                                         sorted_state=False)
    return dataclasses.replace(cfg, cell_capacity=cap,
                               rescue_capacity=64), params, state


def test_bucket_grid_step_is_device_only(cuda_device):
    """The bucket_grid step raises nothing under sync debug "error", its
    StepGraph replays it bit for bit, and its rescue launches R1 and R2
    once a step, not their plain versions (and the integrate kernel and
    the two parameter kernels once a replay)."""
    from water_sandbox_tpu_torch.ops import grid
    from water_sandbox_tpu_torch.ops.cuda import graph
    cfg, params, state = _bucket_grid_case(cuda_device)
    raw = grid.build_bucket_grid(state.predicted, state.vel, params, cfg)
    assert int(raw.overflow) > 0
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = state
        for _ in range(4):
            s = wt.step(s, params, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _launched("sph_rescue_density", "sph_rescue_force") == (4, 4)
    g = graph.StepGraph(state.clone(), params, cfg)
    g.run(4)
    torch.cuda.synchronize()
    assert g.graph is not None
    assert g.per_replay == {"sph_coeffs": 1, "sph_param_vector": 1,
                            "sph_rescue_density": 1, "sph_rescue_force": 1,
                            "sph_integrate": 1}
    for f in ("pos", "vel", "density", "acc", "overflow_total"):
        assert torch.equal(getattr(g.state, f), getattr(s, f)), f
    sim = wt.Simulation(cfg, params, state)
    sim.run(4)
    assert sim.graph.graph is not None and torch.equal(sim.state.pos, s.pos)


def test_bucket_grid_rescue_kernels_match_plain(cuda_device):
    """R1 and R2 on the bucket_grid step's inputs (its column grid, rows in
    particle order, no density planes) against their plain versions."""
    from water_sandbox_tpu_torch.ops import grid, rescue as rescue_mod
    cfg, params, state = _bucket_grid_case(cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    pred, vel = state.predicted.contiguous(), state.vel.contiguous()
    g, scol, order = grid._build(pred, vel, params, cfg)
    den_c, nden_c, _, _ = grid.bucket_density_pass(g, params, coeffs, cfg)
    den = grid._from_cells(den_c, g.addr, params.target_density)
    nden = grid._from_cells(nden_c, g.addr, DENSITY_PADDING)
    nc = grid.num_cells(cfg)
    dropped = g.addr == cfg.cell_capacity * nc
    den_k, nden_k = den.clone(), nden.clone()
    r = grid.rescue_density(pred, dropped, g.overflow, den_k, nden_k, scol,
                            order, params, coeffs, cfg)
    want = rescue_mod.density_rescue_count(pred, r.sel, r.slot, r.count, den,
                                           nden, params, coeffs, cfg)
    assert int(r.count) > 0 and not torch.equal(den_k, den)
    np.testing.assert_allclose(den_k.cpu().numpy(), want[0].cpu().numpy(),
                               **TOL)
    np.testing.assert_allclose(nden_k.cpu().numpy(), want[1].cpu().numpy(),
                               **TOL)
    prs = params.pressure_scalar * (den_k - params.target_density)
    nprs = params.near_pressure_scalar * nden_k
    acc = torch.randn_like(pred)
    acc_k = acc.clone()
    grid.rescue_force(pred, vel, den_k, nden_k, prs, nprs, acc_k, r, params,
                      coeffs, cfg)
    want = rescue_mod.force_rescue_count(pred, vel, den_k, nden_k, prs, nprs,
                                         r.sel, r.slot, r.count, acc, params,
                                         coeffs, cfg)
    np.testing.assert_allclose(acc_k.cpu().numpy(), want.cpu().numpy(),
                               **TOL)


def test_sharded_rollout_captured_equals_eager(cuda_device):
    """The cell-slab-sharded step on 4 shards of the card: a ShardedGraph
    captures it, replays it bit for bit against the eager steps, and both
    repeat the single-device bucket_grid step's positions."""
    from water_sandbox_tpu_torch.ops.cuda import graph
    from water_sandbox_tpu_torch.parallel import gspmd, mesh as mesh_mod
    cfg, params, state = _bucket_grid_case(cuda_device)
    mesh = mesh_mod.make_mesh(4, cuda_device)
    shards = gspmd.shard_state(state, mesh)
    step = gspmd.make_sharded_step(mesh, cfg)
    e = shards
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            e = step(e, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g = graph.ShardedGraph(step, [s.clone() for s in shards], params, mesh)
    g.run(3)
    torch.cuda.synchronize()
    assert g.graph is not None
    for a, b in zip(g.states, e):
        for f in ("pos", "vel", "density", "acc", "overflow_total"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    single = wt.rollout(state, params, cfg, 3)
    got = gspmd.unshard_state(g.states)
    np.testing.assert_allclose(got.pos.cpu().numpy(),
                               single.pos.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float(got.overflow_total) == float(single.overflow_total)


@pytest.mark.parametrize("mode", ["dense", "hash_grid"])
def test_plain_mode_step_is_captured(cuda_device, mode):
    """The dense and hash_grid steps at mini-3d raise nothing under sync
    debug "error", and 10 replays of their StepGraph equal 10 eager steps
    bit for bit, with the coefficient and integrate kernels the hand
    kernels of a replay; a Simulation and rollout replay the same graph."""
    from water_sandbox_tpu_torch.ops.cuda import graph
    cfg, params, state = wt.scenes.build("mini-3d", device=cuda_device,
                                         neighbor_mode=mode)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = wt.step(state, params, cfg)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(9):
        s = wt.step(s, params, cfg)
    g = graph.StepGraph(state.clone(), params, cfg)
    g.run(10)
    torch.cuda.synchronize()
    assert g.graph is not None and g.per_replay == {"sph_coeffs": 1,
                                                    "sph_integrate": 1}
    for f in ("pos", "vel", "predicted", "acc", "density", "near_density",
              "pressure", "near_pressure", "overflow_total", "time"):
        assert _same_bits(getattr(g.state, f), getattr(s, f)), f
    sim = wt.Simulation(cfg, params, state)
    sim.run(10)
    assert sim.graph.graph is not None and _same_bits(sim.state.pos, s.pos)
    assert _same_bits(wt.rollout(state, params, cfg, 10).pos, s.pos)


def _mesh_case(case, dev, serial):
    """(graph over a fresh state, the eager step and its arguments) of the
    domain step on 8 shards at cell capacity 1 (the cross-shard rescue on
    every step) or the sharded step on 4 slabs (R1/R2 on every step), on a
    mesh with a stream a shard or on the serial reference."""
    from water_sandbox_tpu_torch.core.params import Container, _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph
    from water_sandbox_tpu_torch.parallel import domain, gspmd
    from water_sandbox_tpu_torch.parallel import mesh as mesh_mod
    if case == "sharded":
        cfg, params, state = _bucket_grid_case(dev)
        mesh = mesh_mod.make_mesh(4, dev, serial=serial)
        shards = gspmd.shard_state(state, mesh)
        step = gspmd.make_sharded_step(mesh, cfg)
        return mesh, graph.ShardedGraph(step, [s.clone() for s in shards],
                                        params, mesh), step, (shards, params)
    pts = wt.cube_fluid(8, 4, 4)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    cfg = SimConfig(n=pts.shape[0], dim=3, grid_dims=(24, 8, 8),
                    cell_capacity=1, rescue_capacity=512)
    params = wt.SimParams.create(dim=3, device=dev, container=(
        Container.create((0.0, 0.0, 0.0), (5.0, 1.8, 1.8), device=dev)))
    mesh = mesh_mod.make_mesh(8, dev, serial=serial)
    states, active = domain.shard_state(wt.init_state(pts, vel, device="cpu"),
                                        mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg)
    return mesh, graph.DomainGraph(
        step, [s.clone() for s in states], [a.clone() for a in active],
        _map_tensors(params, torch.clone), mesh), step, (states, active,
                                                         params)


@pytest.mark.parametrize("case", ["domain", "sharded"])
def test_concurrent_shards_repeat_the_serial_reference(cuda_device, case):
    """A stream a shard, distinct from each other and from the caller's;
    a step cannot fork from a shard's stream; 6 captured steps (twice, from
    the same state) and 6 eager steps on the concurrent mesh equal 6
    captured steps of the serial reference bit for bit."""
    ref_mesh, ref, _, _ = _mesh_case(case, cuda_device, serial=True)
    assert ref_mesh.streams is None
    ref.run(6)
    mesh, g, step, args = _mesh_case(case, cuda_device, serial=False)
    handles = [s.cuda_stream for s in mesh.streams]
    assert len(set(handles)) == mesh.size
    # "cuda" resolved to its index: a handed-over tensor's device matches
    assert all(d == args[0][0].pos.device for d in mesh.devices)
    assert torch.cuda.current_stream().cuda_stream not in handles
    with torch.cuda.stream(mesh.streams[1]):
        with pytest.raises(RuntimeError, match="shard's stream"):
            with mesh.step():
                pass
    saved = g._save()
    runs = []
    for _ in range(2):
        g._restore(saved)
        g.run(6)
        runs.append([s.clone() for s in g.states])
    eager = args
    for _ in range(6):
        out = step(*eager)
        eager = (out,) + args[1:] if case == "sharded" else (*out[:2],
                                                            args[2])
    runs.append(eager[0])
    torch.cuda.synchronize()
    assert g.graph is not None
    for states in runs:
        for a, b in zip(states, ref.states):
            for f in ("pos", "vel", "density", "acc", "overflow_total"):
                assert _same_bits(getattr(a, f), getattr(b, f)), f


def test_a_host_read_in_the_step_fails_the_capture(cuda_device, monkeypatch):
    """A step that reads the device on the host cannot be captured, and the
    capture raises: nothing falls back to the eager loop. (Last in the
    file: it leaves a failed capture behind.)"""
    from water_sandbox_tpu_torch.ops.cuda import graph
    cfg, params, state = wt.scenes.build("mini-3d", device=cuda_device,
                                         sorted_state=True)
    orig = sb._param_vector

    def reading(params, coeffs):
        float(params.dt)                     # a device-to-host copy
        return orig(params, coeffs)

    g = graph.StepGraph(state.clone(), params, cfg)
    g.run(1)                                 # captures the clean step
    assert g.graph is not None
    monkeypatch.setattr(sb, "_param_vector", reading)
    bad = graph.StepGraph(state.clone(), params, cfg)
    with pytest.raises(RuntimeError):
        bad.run(1)
    assert bad.graph is None
