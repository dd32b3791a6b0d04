"""The port's configuration layer against the JAX package: kernel
coefficients, every scene's configuration, parameters and initial state
(equal in float32), the smoothing kernels, SimConfig's validation, and the
carry-across of parameters and state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import water_sandbox_tpu as wj
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu.ops import kernels as jkernels
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import kernels as tkernels


@pytest.mark.parametrize("h", [0.25, 0.1, 0.3317])
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_coeffs_match_jax(dim, h):
    jc = jax.jit(lambda r: wj.KernelCoeffs.from_radius(r, dim))(
        jnp.float32(h))
    tc = wt.KernelCoeffs.from_radius(torch.tensor(h), dim)
    for f in dataclasses.fields(tc):
        np.testing.assert_array_equal(getattr(tc, f.name).numpy(),
                                      np.asarray(getattr(jc, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("name", wj.scenes.names())
def test_scene_matches_jax(name):
    jcfg, jparams, jstate = wj.scenes.build(name)
    cfg, params, state = wt.scenes.build(name, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    tleaves = convert.params_to_numpy(params)
    assert len(jleaves) == len(tleaves) == 19
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tfields = convert.state_to_numpy(state)
    for f in dataclasses.fields(jstate):
        want = np.asarray(getattr(jstate, f.name))
        got = tfields[f.name]
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_lattice_rest_density_matches_jax():
    for dim in (2, 3):
        assert (wt.scenes.lattice_rest_density(0.1, 0.25, dim)
                == wj.scenes.lattice_rest_density(0.1, 0.25, dim))


def test_smoothing_kernels_match_jax():
    rng = np.random.default_rng(1)
    d = rng.random(200).astype(np.float32) * 0.3
    h = np.float32(0.25)
    jc = wj.KernelCoeffs.from_radius(jnp.float32(h), 3)
    tc = wt.KernelCoeffs.from_radius(torch.tensor(h), 3)
    for name in ("w_density", "w_near", "dw_density", "dw_near",
                 "w_viscosity"):
        np.testing.assert_allclose(
            getattr(tkernels, name)(torch.from_numpy(d), torch.tensor(h),
                                    tc).numpy(),
            np.asarray(getattr(jkernels, name)(jnp.asarray(d),
                                               jnp.float32(h), jc)),
            rtol=1e-6, atol=1e-6, err_msg=name)


def test_config_modes_and_probe_fields():
    base = dict(n=64, dim=3, grid_dims=(8, 8, 8))
    assert wt.SimConfig(**base).resolved().neighbor_mode == "pallas"
    assert (wt.SimConfig(**base, sorted_state=True).resolved().sorted_state)
    for mode in ("dense", "bucket_grid", "hash_grid"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            wt.SimConfig(**base, neighbor_mode=mode)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        wt.SimConfig(**base, incremental_rebuild=4)
    for field, value in (("build_scatter", "cellmajor"),
                         ("density_gate", ("slab", 4)),
                         ("force_gate", ("qrow3", 8)),
                         ("dma_prefetch", False), ("flush_gated", False)):
        with pytest.raises(ValueError, match=field):
            wt.SimConfig(**base, **{field: value})
    # the JAX package's own refusals carry over
    with pytest.raises(ValueError, match="sorted_state"):
        wt.SimConfig(**base, neighbor_mode="pallas", sorted_state=True,
                     incremental_rebuild=4)
    with pytest.raises(ValueError, match="tile_override"):
        wt.SimConfig(**base, tile_override=300)
    with pytest.raises(ValueError, match="grid_dims"):
        wt.SimConfig(n=64, dim=3)
    # tile_override stays: it shapes the flagship's plane layout
    assert wt.SimConfig(**base, tile_override=1024).tile_override == 1024


def test_params_carry_across_and_replace():
    jp = wj.SimParams.create(
        dim=3, max_speed=7.0,
        container=wj.Container.create((0.1, 0.2, 0.3), (4.0, 5.0, 6.0),
                                      velocity=(0.3, 0.0, -0.1),
                                      angular_velocity=0.05, angle=0.2),
        field=wj.InteractionField.create((1.0, 0.0, -1.0), 12.0, 2.5))
    tp = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jp)])
    assert float(tp.container.angular_velocity) == np.float32(0.05)
    assert float(tp.field.radius) == 2.5 and tp.dim == 3
    for a, b in zip(convert.params_to_numpy(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tp2 = tp.replace(pressure_scalar=50.0)
    assert float(tp2.pressure_scalar) == 50.0
    assert float(tp.pressure_scalar) == 22.0
    with pytest.raises(ValueError, match="more SimParams leaves"):
        convert.params_from_numpy(convert.params_to_numpy(tp) + [1.0])

    js = wj.init_state(jnp.asarray(np.random.default_rng(0).random(
        (10, 3), dtype=np.float32)))
    ts = convert.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)})
    assert ts.ids.dtype == torch.int32 and ts.step_count.dtype == torch.int32
    assert ts.overflow.dtype == torch.int32
    assert ts.overflow_total.dtype == torch.float32
    np.testing.assert_array_equal(ts.predicted.numpy(),
                                  np.asarray(js.predicted))
