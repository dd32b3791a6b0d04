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
        cfg = wt.SimConfig(**base, neighbor_mode=mode)
        assert cfg.resolved() is cfg and cfg.table_size == 64
    # only the modes with a bounded grid need its dims, as in the JAX package
    assert wt.SimConfig(n=64, neighbor_mode="dense").grid_dims == ()
    assert wt.SimConfig(n=64, neighbor_mode="hash_grid",
                        hash_table_size=31).table_size == 31
    with pytest.raises(ValueError, match="grid_dims"):
        wt.SimConfig(n=64, neighbor_mode="bucket_grid")
    # the JAX package ignores the container frame in these two modes; the
    # port refuses it
    for mode in ("dense", "hash_grid"):
        with pytest.raises(ValueError, match="container"):
            wt.SimConfig(**base, neighbor_mode=mode, grid_frame="container")
    assert wt.SimConfig(**base, neighbor_mode="bucket_grid",
                        grid_frame="container").grid_frame == "container"
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
        [np.asarray(x) for x in jax.tree.leaves(jp)],
        device="cpu")
    assert float(tp.container.angular_velocity) == np.float32(0.05)
    assert float(tp.field.radius) == 2.5 and tp.dim == 3
    for a, b in zip(convert.params_to_numpy(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tp2 = tp.replace(pressure_scalar=50.0)
    assert float(tp2.pressure_scalar) == 50.0
    assert float(tp.pressure_scalar) == 22.0
    with pytest.raises(ValueError, match="more SimParams leaves"):
        convert.params_from_numpy(convert.params_to_numpy(tp) + [1.0],
                                  device="cpu")

    js = wj.init_state(jnp.asarray(np.random.default_rng(0).random(
        (10, 3), dtype=np.float32)))
    ts = convert.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}, device="cpu")
    assert ts.ids.dtype == torch.int32 and ts.step_count.dtype == torch.int32
    assert ts.overflow.dtype == torch.int32
    assert ts.overflow_total.dtype == torch.float32
    np.testing.assert_array_equal(ts.predicted.numpy(),
                                  np.asarray(js.predicted))


def _saved_checkpoint(tmp_path):
    from water_sandbox_tpu_torch.runtime import checkpoint
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state, params, cfg)
    return checkpoint, path


_PTS = np.zeros((4, 3), np.float32)
# name -> (call taking device kwargs, the tensor whose device is checked)
_CONSTRUCTORS = {
    "init_state": (lambda tmp, **kw: wt.init_state(_PTS, **kw),
                   lambda r: r.pos),
    "SimParams.create": (lambda tmp, **kw: wt.SimParams.create(dim=3, **kw),
                         lambda r: r.container.center),
    "Container.create": (lambda tmp, **kw: wt.Container.create(**kw),
                         lambda r: r.half_size),
    "InteractionField.inactive": (
        lambda tmp, **kw: wt.InteractionField.inactive(3, **kw),
        lambda r: r.position),
    "InteractionField.create": (
        lambda tmp, **kw: wt.InteractionField.create((0.0, 0.0, 0.0), 1.0,
                                                     2.0, **kw),
        lambda r: r.radius),
    "checkpoint.load": (
        lambda tmp, **kw: (lambda ck, path: ck.load(path, **kw))(
            *_saved_checkpoint(tmp)),
        lambda r: r[0].pos),
    "convert.params_from_numpy": (
        lambda tmp, **kw: convert.params_from_numpy(
            convert.params_to_numpy(wt.SimParams.create(dim=3, device="cpu")),
            **kw),
        lambda r: r.field.strength),
    "convert.state_from_numpy": (
        lambda tmp, **kw: convert.state_from_numpy(
            convert.state_to_numpy(wt.init_state(_PTS, device="cpu")), **kw),
        lambda r: r.ids),
}


@pytest.mark.parametrize("name", sorted(_CONSTRUCTORS))
def test_constructors_need_cuda_unless_asked_for_the_cpu(name, tmp_path,
                                                        monkeypatch):
    """Every constructor and loader of the port puts its tensors on the
    card by default: without a CUDA device the default raises and names
    device='cpu', and with device="cpu" it works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, tensor = _CONSTRUCTORS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(tmp_path)
    assert tensor(call(tmp_path, device="cpu")).device.type == "cpu"


def test_simparams_create_moves_container_and_field_to_its_device():
    box = wt.Container.create((0.0, 0.0, 0.0), (2.0, 2.0, 2.0), device="cpu")
    p = wt.SimParams.create(dim=3, container=box, device="cpu")
    assert p.container.half_size.device == p.dt.device == torch.device("cpu")
