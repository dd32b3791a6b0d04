"""The port's SPH passes on the CPU (plain kernel versions) against the JAX
package's XLA bucket pipeline (``grid.bucket_sph``): particle order,
sorted order, the container-frame grid, and the exact overflow rescue at
cell capacity 4. Bar: rtol = atol = 2e-4 (other summation orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from water_sandbox_tpu.core.params import Container as JContainer
from water_sandbox_tpu.core.params import KernelCoeffs as JKernelCoeffs
from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.ops import grid as jgrid
from water_sandbox_tpu.ops import rescue as jrescue
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.core.params import KernelCoeffs, SimConfig
from water_sandbox_tpu_torch.ops import rescue
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("den", "nden", "prs", "nprs", "acc")


def _case(dim, n=300, seed=0, spread=2.0, container=None, **cfg_kw):
    rng = np.random.default_rng(seed)
    pred = ((rng.random((n, dim)) - 0.5) * spread).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    jparams = JSimParams.create(dim=dim, container=container)
    jcfg = JSimConfig(n=n, dim=dim, neighbor_mode="pallas", **cfg_kw)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)],
        device="cpu")
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    return pred, vel, jparams, jcfg, params, cfg


def _jax_ref(pred, vel, jparams, jcfg):
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, jcfg.dim)
    return jgrid.bucket_sph(jnp.asarray(pred), jnp.asarray(vel), jparams,
                            jcoeffs, jcfg)


def _coeffs(params, cfg):
    return KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)


@pytest.mark.parametrize("dim", [2, 3])
def test_bucket_sph_matches_jax(dim):
    pred, vel, jparams, jcfg, params, cfg = _case(
        dim, grid_dims=(12,) * dim, cell_capacity=16)
    want = _jax_ref(pred, vel, jparams, jcfg)
    got = sb.bucket_sph(torch.from_numpy(pred), torch.from_numpy(vel),
                        params, _coeffs(params, cfg), cfg)
    assert int(got[5]) == int(want[5]) == 0
    for name, a, b in zip(NAMES, got[:5], want[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("frame", ["world", "container"])
def test_bucket_sph_sorted_matches_jax(frame):
    """Sorted-order results, mapped back through s_ids, equal the
    particle-order reference; s_pos/s_vel are the same rows permuted."""
    box = JContainer.create((0.3, -0.1, 0.2), (2.6, 2.6, 2.6),
                            velocity=(0.5, 0.0, 0.0), angular_velocity=0.4,
                            angle=0.3)
    pred, vel, jparams, jcfg, params, cfg = _case(
        3, container=box, grid_dims=(14, 14, 14), cell_capacity=16,
        sorted_state=True, grid_frame=frame)
    n = pred.shape[0]
    t = np.float32(1.7)
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, 3)
    jworld = dataclasses.replace(jcfg, sorted_state=False,
                                 grid_frame="world")
    want = jgrid.bucket_sph(jnp.asarray(pred), jnp.asarray(vel), jparams,
                            jcoeffs, jworld)
    rng = np.random.default_rng(9)
    ids = rng.permutation(n).astype(np.int32)
    pos = pred - np.float32(0.02)
    out = sb.bucket_sph_sorted(
        torch.from_numpy(pos), torch.from_numpy(vel), torch.from_numpy(pred),
        torch.from_numpy(ids), params, _coeffs(params, cfg), cfg,
        time=torch.tensor(t))
    s_ids = out[8].numpy()
    assert out[8].dtype == torch.int32
    assert sorted(s_ids.tolist()) == sorted(ids.tolist())
    # row r of every output belongs to the particle whose input row held
    # id s_ids[r]
    row_of = np.empty(n, np.int64)
    row_of[ids] = np.arange(n)
    rows = row_of[s_ids]
    np.testing.assert_array_equal(out[6].numpy(), pos[rows])
    np.testing.assert_array_equal(out[7].numpy(), vel[rows])
    assert int(out[5]) == 0
    for name, a, b in zip(NAMES, out[:5], want[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[rows], **TOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def crowded():
    """A 2-D blob whose cells hold far more than cell capacity 4."""
    return _case(2, n=500, seed=4, spread=1.2, grid_dims=(12, 12),
                 cell_capacity=4, rescue_capacity=512, chunk=128)


def test_rescue_matches_jax(crowded):
    pred, vel, jparams, jcfg, params, cfg = crowded
    raw = sb._build_core(torch.from_numpy(pred), torch.from_numpy(vel),
                         params, cfg)[5]
    assert int(raw) > 256, "must overflow past the small rescue tier"
    want = _jax_ref(pred, vel, jparams, jcfg)
    got = sb.bucket_sph(torch.from_numpy(pred), torch.from_numpy(vel),
                        params, _coeffs(params, cfg), cfg)
    assert int(got[5]) == int(want[5]) == 0
    for name, a, b in zip(NAMES, got[:5], want[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_rescue_small_tier_and_budget_exceeded(crowded):
    pred, vel, jparams, jcfg, params, cfg = crowded
    for kw in (dict(cell_capacity=8), dict(rescue_capacity=64)):
        jc = dataclasses.replace(jcfg, **kw)
        c = dataclasses.replace(cfg, **kw)
        want = _jax_ref(pred, vel, jparams, jc)
        got = sb.bucket_sph(torch.from_numpy(pred), torch.from_numpy(vel),
                            params, _coeffs(params, c), c)
        assert int(got[5]) == int(want[5])
        for name, a, b in zip(NAMES, got[:5], want[:5]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                       err_msg=f"{kw} {name}")
    assert int(got[5]) > 0, "budget 64 must leave particles unrescued"


def test_rescue_functions_match_jax(crowded):
    pred, vel, jparams, jcfg, params, cfg = crowded
    n = pred.shape[0]
    rng = np.random.default_rng(6)
    dropped = rng.random(n) < 0.1
    den = (rng.random(n) * 100 + 50).astype(np.float32)
    nden = (rng.random(n) * 300 + 50).astype(np.float32)
    acc = rng.standard_normal((n, 2)).astype(np.float32)
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, 2)
    coeffs = _coeffs(params, cfg)
    T = torch.from_numpy

    jo = jrescue.dropped_selection(jnp.asarray(dropped), 40)
    to = rescue.dropped_selection(T(dropped), 40)
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jd = jrescue.density_rescue(jnp.asarray(pred), jnp.asarray(dropped),
                                jnp.asarray(den), jnp.asarray(nden), jparams,
                                jcoeffs, jcfg, budget=40)
    td = rescue.density_rescue(T(pred), T(dropped), T(den), T(nden), params,
                               coeffs, cfg, budget=40)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    prs, nprs = den * 22.0 - 220.0, nden * 2.0
    ja = jrescue.force_rescue(
        jnp.asarray(pred), jnp.asarray(vel), jd[0], jd[1], jnp.asarray(prs),
        jnp.asarray(nprs), jnp.asarray(dropped), jnp.asarray(acc), jparams,
        jcoeffs, jcfg, budget=40)
    ta = rescue.force_rescue(T(pred), T(vel), td[0], td[1], T(prs), T(nprs),
                             T(dropped), T(acc), params, coeffs, cfg,
                             budget=40)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    assert rescue.small_budget(cfg) == jrescue.small_budget(jcfg) == 256
