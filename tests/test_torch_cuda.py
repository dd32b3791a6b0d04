"""The port's CUDA kernels on a CUDA device: each kernel against its plain
PyTorch version, and one main-path step on the card against the same step
on the CPU (plain versions). Without a CUDA device each test skips (the
``cuda_device`` fixture decides, at run time). This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bar: rtol = atol = 2e-4 (the kernels sum pairs in another order; the force
kernel uses rsqrtf)."""

import numpy as np
import pytest
import torch

import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core.params import KernelCoeffs, SimConfig
from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


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
    sb.reset_launches()
    dens = sb.run_density(planes, counts, addr, pv, cfg)
    out = sb.run_force(planes, dens, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == {"sph_density": 1, "sph_force": 1}
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
    sb.reset_launches()
    got = sb._density_kernel(planes, counts, addr, pv, cfg, group)
    again = sb._density_kernel(planes, counts, addr, pv, cfg, group)
    torch.cuda.synchronize()
    assert sb.LAUNCHES["sph_density"] == 2
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
    sb.reset_launches()
    got = wt.step(state.to(cuda_device), params.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == {"sph_density": 1, "sph_force": 1}
    want = wt.step(state, params, cfg)
    np.testing.assert_array_equal(got.ids.cpu().numpy(), want.ids.numpy())
    for f in ("pos", "vel", "acc", "density", "near_density", "pressure"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), **TOL,
                                   err_msg=f)


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
    bs.reset_launches()
    gk, gv = bs.sort_pairs(keys.to(cuda_device), vals.to(cuda_device))
    torch.cuda.synchronize()
    assert bs.LAUNCHES == {"bitonic_sort": 1}
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
    sb.reset_launches()
    dens = [sb.run_density(feats[d], counts[d], addr[d], pv, cfg_loc)
            for d in range(8)]
    dens = domain._exchange_halo_slabs(dens, 3, g.S_pad, g.PAD, mesh)
    out = [sb.run_force(feats[d], dens[d], counts[d], addr[d], pv, cfg_loc)
           for d in range(8)]
    torch.cuda.synchronize()
    assert sb.LAUNCHES == {"sph_density": 8, "sph_force": 8}
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
