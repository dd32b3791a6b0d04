"""The port's integrator and cell-key coordinates against the JAX package,
with a translating, yawing container, an active interaction field and the
speed limiter on. Bar: rtol 1e-6, atol 1e-5 (a float32 ulp at |x| ≈ 8 is
about 1e-6, and torch's and XLA's sin/cos may differ by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import water_sandbox_tpu as wj
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu.ops import hashing as jhashing
from water_sandbox_tpu.ops import integrate as jintegrate
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import hashing as thashing
from water_sandbox_tpu_torch.ops import integrate as tintegrate

TOL = dict(rtol=1e-6, atol=1e-5)


def _params(dim, max_speed=3.0):
    size = (6.0, 4.0, 5.0)[:dim]
    jp = wj.SimParams.create(
        dim=dim, max_speed=max_speed,
        container=wj.Container.create((0.3, -0.2, 0.1)[:dim], size,
                                      velocity=(0.4, 0.1, -0.2)[:dim],
                                      angular_velocity=0.3, angle=0.25),
        field=wj.InteractionField.create((0.5, 0.0, -0.5)[:dim], 25.0, 2.0))
    tp = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jp)],
        device="cpu")
    return jp, tp


def _rows(dim, n=400, seed=0, scale=4.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, dim)) * scale).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("dim", [2, 3])
def test_integrate_matches_jax(dim):
    jp, tp = _params(dim)
    pos, vel, acc = _rows(dim)
    t_new = np.float32(1.37)
    want = jax.jit(jintegrate.integrate)(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc), jp,
        jnp.asarray(t_new))
    got = tintegrate.integrate(torch.from_numpy(pos), torch.from_numpy(vel),
                               torch.from_numpy(acc), tp,
                               torch.tensor(t_new))
    for name, a, b in zip(("pos", "vel", "predicted"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # the speed limiter acted on this input (rows that hit no wall keep
    # |v| == max_speed; wall hits add the moving wall's velocity)
    speed = np.linalg.norm(got[1].numpy(), axis=1)
    assert np.isclose(speed, 3.0, rtol=1e-5).sum() > 10


@pytest.mark.parametrize("dim", [2, 3])
def test_field_and_rotation_match_jax(dim):
    jp, tp = _params(dim)
    pos = _rows(dim)[0]
    np.testing.assert_allclose(
        tintegrate.field_acceleration(torch.from_numpy(pos),
                                      tp.field).numpy(),
        np.asarray(jintegrate.field_acceleration(jnp.asarray(pos),
                                                 jp.field)), **TOL)
    for inverse in (False, True):
        np.testing.assert_allclose(
            tintegrate._rotate_yaw(torch.from_numpy(pos), torch.tensor(0.7),
                                   inverse).numpy(),
            np.asarray(jintegrate._rotate_yaw(jnp.asarray(pos),
                                              jnp.float32(0.7), inverse)),
            **TOL)


@pytest.mark.parametrize("frame", ["world", "container"])
def test_key_coords_and_cells_match_jax(frame):
    jp, tp = _params(3)
    pred = _rows(3)[0]
    jcfg = wj.SimConfig(n=400, dim=3, neighbor_mode="pallas",
                        grid_dims=(40, 40, 40), grid_frame=frame)
    tcfg = wt.SimConfig(n=400, dim=3, grid_dims=(40, 40, 40),
                        grid_frame=frame)
    t = np.float32(2.5)
    want = jhashing.key_coords(jnp.asarray(pred), jp, jcfg, jnp.asarray(t))
    got = thashing.key_coords(torch.from_numpy(pred), tp, tcfg,
                              torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if frame == "container":
        with pytest.raises(ValueError, match="time"):
            thashing.key_coords(torch.from_numpy(pred), tp, tcfg, None)
    h = np.float32(0.25)
    np.testing.assert_array_equal(
        thashing.get_cell(torch.from_numpy(pred), torch.tensor(h)).numpy(),
        np.asarray(jhashing.get_cell(jnp.asarray(pred), jnp.float32(h))))
    np.testing.assert_array_equal(
        thashing.grid_origin(torch.from_numpy(pred), torch.tensor(h)).numpy(),
        np.asarray(jhashing.grid_origin(jnp.asarray(pred), jnp.float32(h))))
    assert (thashing.default_grid_dims((16.0, 9.0, 9.0), 0.25)
            == jhashing.default_grid_dims((16.0, 9.0, 9.0), 0.25))


def test_static_box_clamps_and_damps():
    """A static box reduces to the reference's per-axis clamp with the
    velocity flipped and damped."""
    tp = wt.SimParams.create(dim=2, device="cpu", container=(
        wt.Container.create((0.0, 0.0), (2.0, 2.0), device="cpu")))
    pos = torch.tensor([[1.5, 0.0], [0.0, -3.0], [0.2, 0.3]])
    vel = torch.tensor([[1.0, 0.0], [0.0, -2.0], [0.5, 0.5]])
    p, v = tintegrate.collide_container(pos, vel, tp.container,
                                        tp.particle_radius,
                                        tp.collision_damping,
                                        torch.tensor(0.0))
    np.testing.assert_allclose(p.numpy(), [[0.9, 0.0], [0.0, -0.9],
                                           [0.2, 0.3]], atol=1e-6)
    np.testing.assert_allclose(v.numpy(), [[-0.95, 0.0], [0.0, 1.9],
                                           [0.5, 0.5]], atol=1e-6)
