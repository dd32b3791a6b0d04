"""The port's rasterizer, terminal frames and offline renderer
(``viz/raster.py``, ``viz/live.py::render_frame``, ``viz/render.py``)
against the JAX package's on the same seeded inputs.

Bars: the images within rtol 1e-5 / atol 1e-5·max|JAX image| (the same
float32 splat; the four scatter-adds sum each pixel in another order); the
text renderings of one image identical."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import Container as JContainer
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.viz import live as jlive
from water_sandbox_tpu.viz import raster as jraster
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.io.export import TrajectoryWriter
from water_sandbox_tpu_torch.viz import live, raster, render

RTOL = 1e-5
N = 4096
W, H = 64, 36


def _close(got, want, name):
    want = np.asarray(want)
    assert want.max() > 0, name
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=name)


def _case(dim):
    """N seeded particles in a moved, off-center box (some outside it, so
    the clipping is exercised), as a JAX-side namespace and port tensors."""
    rng = np.random.default_rng(dim)
    box = JContainer.create((0.5, -0.25, 0.3)[:dim], (6.0, 4.0, 3.0)[:dim])
    jparams = JSimParams.create(dim=dim, container=box)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    arrays = dict(
        pos=((rng.random((N, dim)) - 0.5) * np.array([7.0, 5.0, 3.0][:dim])
             + np.array([0.5, -0.25, 0.3][:dim])).astype(np.float32),
        vel=rng.standard_normal((N, dim)).astype(np.float32),
        density=rng.uniform(5.0, 30.0, N).astype(np.float32))
    jstate = types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    state = types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jstate, jparams, state, params


@pytest.mark.parametrize("dim,z_slab", [(2, None), (3, None), (3, 0.5)])
def test_raster_images_match_jax(dim, z_slab):
    jstate, jparams, state, params = _case(dim)
    lo, hi = np.array([-2.0, -1.5], np.float32), np.array([3.0, 2.0],
                                                          np.float32)
    vals = np.linspace(0.5, 2.0, N, dtype=np.float32)
    want = jraster.raster2d(jstate.pos, jnp.asarray(vals),
                            (jnp.asarray(lo), jnp.asarray(hi)), W, H)
    got = raster.raster2d(state.pos, torch.from_numpy(vals),
                          (torch.from_numpy(lo), torch.from_numpy(hi)), W, H)
    assert got.shape == (H, W) and got.dtype == torch.float32
    _close(got, want, "raster2d")

    want = jraster.density_image(jstate, jparams, W, H, z_slab=z_slab)
    got = raster.density_image(state, params, W, H, z_slab=z_slab)
    _close(got, want, "density_image")
    if z_slab is not None:
        full = raster.density_image(state, params, W, H)
        assert float(got.sum()) < 0.5 * float(full.sum())

    _close(raster.speed_image(state, params, W, H),
           jraster.speed_image(jstate, jparams, W, H), "speed_image")


def test_text_renderings_match_jax():
    """ascii_preview and the live frame (plain and ANSI) of one image."""
    jstate, jparams, _, _ = _case(3)
    img = np.asarray(jraster.density_image(jstate, jparams, 40, 12))
    timg = torch.from_numpy(img.copy())
    assert raster.ascii_preview(timg) == jraster.ascii_preview(img)
    assert len(raster.ascii_preview(timg).splitlines()) == 12
    for color in (False, True):
        assert live.render_frame(timg, color) == jlive.render_frame(img,
                                                                    color)


@pytest.fixture(scope="module")
def sim():
    return wt.Simulation.from_scene("mini-3d", neighbor_mode="dense",
                                    device="cpu")


def test_density_image_of_a_sim(sim):
    sim.run(2)
    img = raster.density_image(sim.state, sim.params, 64, 36)
    assert img.shape == (36, 64) and float(img.sum()) > 0
    # mass is where the cube is (the middle of the image)
    assert float(img[:, 24:40].sum()) > float(img[:, :16].sum())
    assert raster.speed_image(sim.state, sim.params, 32, 18).shape == (18,
                                                                       32)


def test_render_frame_and_gif(sim, tmp_path):
    """tests/test_distributed_runner.py's PNG/GIF render on a port sim."""
    w = TrajectoryWriter(str(tmp_path / "t.npz"))
    for _ in range(3):
        sim.run(2)
        w.add_frame(sim.positions(), float(sim.state.time))
    traj = w.write()

    png = render.render_frame(sim.positions(), sim.velocities(), sim.params,
                              str(tmp_path / "frame.png"))
    assert os.path.getsize(png) > 1000

    gif = render.render_trajectory_gif(traj, str(tmp_path / "anim.gif"),
                                       sim.params, fps=5)
    assert os.path.getsize(gif) > 1000
