"""The port's plain neighbour pipelines (``ops/grid.py``) against the JAX
package's on the same numpy inputs, and against the port's own dense oracle
(the mirrors of tests/test_grid.py).

Bars: the bucket build and the hash table bit-identical to JAX (integer
keys, one stable sort); the SPH results within rtol 2e-4 / atol
2e-4·max(1, max|JAX|) of JAX (the same float32 formulas; XLA fuses and
orders its sums differently); the grid modes against the port's dense
oracle at tests/test_grid.py's own bars."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import Container as JContainer
from water_sandbox_tpu.core.params import KernelCoeffs as JKernelCoeffs
from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.ops import grid as jgrid
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import dense, grid, hashing

RTOL = 2e-4
# cell capacity no test cloud fills (at most 300 particles over at least 8^dim
# cells); smaller than tests/test_grid.py's 32 to keep the pair blocks small
CAP = 12
NAMES = ("den", "nden", "prs", "nprs", "acc", "overflow")


def _close(got, want, name):
    want = np.asarray(want)
    assert np.isfinite(want).all(), name
    np.testing.assert_allclose(
        got.numpy(), want, rtol=RTOL,
        atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def _case(dim=3, n=300, seed=0, spread=3.0, mode="bucket_grid",
          container=None, **cfg_kw):
    rng = np.random.default_rng(seed)
    pred = ((rng.random((n, dim)) - 0.5) * spread).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    jparams = JSimParams.create(dim=dim, **(
        {"container": container} if container is not None else {}))
    jcfg = JSimConfig(**{**dict(
        n=n, dim=dim, neighbor_mode=mode, grid_dims=(16,) * dim,
        cell_capacity=CAP, chunk=64, max_run=64), **cfg_kw})
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    cfg = wt.SimConfig(**dataclasses.asdict(jcfg))
    jc = JKernelCoeffs.from_radius(jparams.smoothing_radius, dim)
    tc = wt.KernelCoeffs.from_radius(params.smoothing_radius, dim)
    return pred, vel, jparams, jcfg, jc, params, cfg, tc


@pytest.mark.parametrize("dim,frame,cap", [
    (3, "world", CAP), (3, "world", 2), (2, "world", 3),
    (3, "container", 2)])
def test_build_bucket_grid_bit_identical(dim, frame, cap):
    """Planes, mask, addr, origin and overflow, with and without
    capacity-overflow sentinels, in the world and the container frame."""
    box = JContainer.create(
        (0.1, 0.0, -0.1)[:dim], (4.0, 4.0, 4.0)[:dim],
        velocity=(0.5, 0.0, 0.0)[:dim], angular_velocity=0.4, angle=0.3)
    pred, vel, jparams, jcfg, _, params, cfg, _ = _case(
        dim=dim, seed=cap, container=box, cell_capacity=cap,
        grid_frame=frame)
    t = np.float32(0.9)
    want = jgrid.build_bucket_grid(jnp.asarray(pred), jnp.asarray(vel),
                                   jparams, jcfg, time=jnp.asarray(t))
    got = grid.build_bucket_grid(torch.from_numpy(pred),
                                 torch.from_numpy(vel), params, cfg,
                                 time=torch.tensor(t))
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (int(got.overflow) > 0) == (cap < CAP)
    nc = grid.num_cells(cfg)
    assert int((got.addr == cap * nc).sum()) == int(got.overflow)


def test_stable_sort_sets_the_slots():
    """Every particle in one cell: slots follow input row order (jnp.argsort
    is stable; torch's is not unless asked)."""
    _, _, _, _, _, params, cfg, _ = _case(n=20, cell_capacity=32,
                                          grid_dims=(8, 8, 8))
    pred = torch.full((20, 3), 0.01) + torch.arange(20)[:, None] * 1e-4
    pred = pred.flip(0).contiguous()
    g = grid.build_bucket_grid(pred, torch.zeros_like(pred), params, cfg)
    nc = grid.num_cells(cfg)
    assert (g.addr // nc).tolist() == list(range(20))


@pytest.mark.parametrize("dim,cap,rescue,n,spread", [
    (3, CAP, 0, 300, 2.0), (2, CAP, 0, 300, 2.0), (3, 2, 0, 300, 2.0),
    (3, 2, 16, 300, 2.0), (3, 1, 512, 300, 2.0), (3, 1, 512, 600, 1.2),
    (2, 2, 512, 600, 1.5)])
def test_bucket_sph_matches_jax(dim, cap, rescue, n, spread):
    """No overflow; overflow counted with the rescue off; a budget smaller
    than the overflow (the rest stays counted); the rescue's small tier (at
    most 256 dropped) and its full tier (the denser clouds of 600)."""
    pred, vel, jparams, jcfg, jc, params, cfg, tc = _case(
        dim=dim, n=n, seed=dim + cap, spread=spread, cell_capacity=cap,
        rescue_capacity=rescue)
    want = jgrid.bucket_sph(jnp.asarray(pred), jnp.asarray(vel), jparams, jc,
                            jcfg)
    got = grid.bucket_sph(torch.from_numpy(pred), torch.from_numpy(vel),
                          params, tc, cfg)
    raw = int(grid.build_bucket_grid(torch.from_numpy(pred),
                                     torch.from_numpy(vel), params,
                                     cfg).overflow)
    assert (raw > 0) == (cap < CAP)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)
    assert int(got[5]) == int(want[5]) == (max(raw - rescue, 0))
    if rescue == 512:
        assert (raw > 256) == (n == 600), "small tier at 300, full at 600"


@pytest.mark.parametrize("dim,table,max_run", [(3, 0, 64), (2, 0, 64),
                                               (3, 41, 64), (3, 0, 2)])
def test_hash_grid_matches_jax(dim, table, max_run):
    """The hashed table bit-identical and hash_sph within the bar: table
    size n (the reference's), a small table full of collisions, and a run
    bound that truncates."""
    pred, vel, jparams, jcfg, jc, params, cfg, tc = _case(
        dim=dim, seed=7 + dim, mode="hash_grid", spread=2.0,
        hash_table_size=table, max_run=max_run)
    jg = jgrid.build_hash_grid(jnp.asarray(pred), jparams, jcfg)
    tg = grid.build_hash_grid(torch.from_numpy(pred), params, cfg)
    for f in dataclasses.fields(tg):
        a, b = getattr(tg, f.name).numpy(), np.asarray(getattr(jg, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (int(tg.overflow) > 0) == (max_run == 2)
    want = jgrid.hash_sph(jnp.asarray(pred), jnp.asarray(vel), jparams, jc,
                          jcfg)
    got = grid.hash_sph(torch.from_numpy(pred), torch.from_numpy(vel),
                        params, tc, cfg)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("dim", [2, 3])
def test_bucket_grid_matches_dense(dim):
    pred, vel, _, _, _, params, cfg, tc = _case(dim=dim)
    pred, vel = torch.from_numpy(pred), torch.from_numpy(vel)
    d, nd, p, np_, acc, overflow = grid.bucket_sph(pred, vel, params, tc,
                                                   cfg)
    assert int(overflow) == 0
    d_ref, nd_ref, p_ref, np_ref = dense.density_pass(pred, params, tc)
    np.testing.assert_allclose(d.numpy(), d_ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(nd.numpy(), nd_ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(p.numpy(), p_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    acc_ref = dense.force_pass(pred, vel, d_ref, nd_ref, p_ref, np_ref,
                               params, tc)
    np.testing.assert_allclose(acc.numpy(), acc_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_hash_grid_matches_weighted_dense(dim):
    """hash_grid keeps the reference's multi-count: a pair counted once per
    colliding offset, as the oracle weighted by reference_pair_weights."""
    pred, vel, _, _, _, params, cfg, tc = _case(dim=dim, seed=1,
                                                mode="hash_grid",
                                                hash_table_size=7,
                                                max_run=128)
    pred, vel = torch.from_numpy(pred), torch.from_numpy(vel)
    w = hashing.reference_pair_weights(pred, params.smoothing_radius,
                                       cfg.table_size)
    assert int(w.max()) > 1
    d, nd, p, np_, acc, ovf = grid.hash_sph(pred, vel, params, tc, cfg)
    assert int(ovf) == 0
    d_ref, nd_ref, p_ref, np_ref = dense.density_pass(pred, params, tc,
                                                      pair_weight=w)
    np.testing.assert_allclose(d.numpy(), d_ref.numpy(), rtol=1e-5)
    np.testing.assert_allclose(nd.numpy(), nd_ref.numpy(), rtol=1e-5)
    acc_ref = dense.force_pass(pred, vel, d_ref, nd_ref, p_ref, np_ref,
                               params, tc, pair_weight=w)
    np.testing.assert_allclose(
        acc.numpy(), acc_ref.numpy(), rtol=2e-4,
        atol=2e-4 * max(1.0, float(acc_ref.abs().max())))


def test_overflow_counted_and_wraparound_masked():
    _, _, _, _, _, params, cfg, tc = _case(n=100, cell_capacity=8)
    pred = torch.zeros((100, 3)) + 0.01
    out = grid.bucket_sph(pred, torch.zeros_like(pred), params, tc, cfg)
    assert int(out[5]) == 100 - 8
    assert all(bool(torch.isfinite(x).all()) for x in out[:5])
    # particles pinned to opposite grid borders must not meet through the
    # roll's wraparound: each sees only itself
    cfg2 = dataclasses.replace(cfg, n=2, grid_dims=(68, 4, 4),
                               cell_capacity=4)
    pred = torch.tensor([[-7.9, 0.0, 0.0], [7.9, 0.0, 0.0]])
    d, _, _, _, acc, _ = grid.bucket_sph(pred, torch.zeros_like(pred),
                                         params, tc, cfg2)
    h = float(params.smoothing_radius)
    np.testing.assert_allclose(d.numpy(), h * h * float(tc.pow2) + 1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(acc.numpy(), 0.0, atol=1e-6)


def test_roll_shifts_match_jax():
    for dims in ((16, 16), (7, 5, 6), (68, 40, 40)):
        assert grid._roll_shifts(dims) == jgrid._py_roll_shifts(dims)


def test_container_frame_is_refused_where_jax_ignores_it():
    """The JAX package's dense and hash_grid modes never read grid_frame;
    the port refuses the combination, and honours the frame in bucket_grid,
    where JAX does: the keys follow the box, the physics does not change."""
    for mode in ("dense", "hash_grid"):
        with pytest.raises(ValueError, match="container"):
            wt.SimConfig(n=8, dim=3, neighbor_mode=mode,
                         grid_frame="container")
    box = JContainer.create((0.5, 0.0, 0.0), (6.0, 6.0, 6.0),
                            angular_velocity=0.7, angle=0.4)
    pred, vel, _, _, _, params, cfg, tc = _case(container=box, seed=4)
    pred, vel = torch.from_numpy(pred), torch.from_numpy(vel)
    cfg_c = dataclasses.replace(cfg, grid_frame="container")
    t = torch.tensor(0.7)
    world = grid.bucket_sph(pred, vel, params, tc, cfg, time=t)
    body = grid.bucket_sph(pred, vel, params, tc, cfg_c, time=t)
    assert not torch.equal(
        grid.build_bucket_grid(pred, vel, params, cfg, time=t).addr,
        grid.build_bucket_grid(pred, vel, params, cfg_c, time=t).addr)
    for name, a, b in zip(NAMES, body, world):
        _close(a, b.numpy(), name)
    with pytest.raises(ValueError, match="sim time"):
        grid.bucket_sph(pred, vel, params, tc, cfg_c)
