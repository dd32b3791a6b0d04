"""The plain neighbour modes "dense" and "hash_grid" as the port runs every
mode since they joined ``ops/cuda/graph.py::CAPTURED_MODES``: ``rollout``,
``trajectory`` and ``Simulation.run`` step a ``StepGraph`` (on the CPU,
eager steps into its buffers; on the card, replays of the captured step),
held against the JAX package's jitted ``rollout`` and ``trajectory``
(``lax.scan`` in one compiled program) on ``mini-3d`` and on a seeded 2-D
cloud; ``grid_frame="container"`` with a moving, yawing box, which both
modes ignore as the JAX package does; the step with every host read and
every host-to-device copy of the step's own making refused; and the +y
direction of a coincident pair. Bar: tests/test_torch_step.py's, rtol =
atol = 2e-4 particle by particle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_step import TOL, _compare

import water_sandbox_tpu as wj
from water_sandbox_tpu.core.params import Container as JContainer
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch import bench
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import kernels
from water_sandbox_tpu_torch.ops.cuda import graph

MODES = ("dense", "hash_grid")


def _cloud(dim, mode, n=256, seed=0, container=None, **cfg_kw):
    """A seeded cloud of ``n`` particles (about 20 neighbours each) in
    both packages: ((jcfg, jparams, jstate), (cfg, params, state))."""
    rng = np.random.default_rng(seed)
    pts = ((rng.random((n, dim)) - 0.5) * 1.6).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    jparams = wj.SimParams.create(dim=dim, **(
        {"container": container} if container is not None else {}))
    jcfg = wj.SimConfig(n=n, dim=dim, neighbor_mode=mode, chunk=64,
                        **cfg_kw)
    jstate = wj.init_state(jnp.asarray(pts), jnp.asarray(vel))
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    cfg = wt.SimConfig(**dataclasses.asdict(jcfg))
    state = wt.init_state(pts, vel, device="cpu")
    return (jcfg, jparams, jstate), (cfg, params, state)


def _case(scene, mode):
    if scene == "mini-3d":
        return (wj.scenes.build(scene, neighbor_mode=mode),
                wt.scenes.build(scene, device="cpu", neighbor_mode=mode))
    return _cloud(2, mode)


@pytest.mark.parametrize("mode", MODES)
def test_simulation_runs_its_step_graph_like_a_step_loop(mode):
    """A Simulation in either mode owns a StepGraph; run(2) then run(3)
    steps its buffers as five calls of step do, bit for bit."""
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode=mode)
    sim = wt.Simulation(cfg, params, state)
    assert type(sim.graph) is graph.StepGraph and not sim.graph.captures
    assert bench.fingerprint(sim)["step"] == "eager"     # the CPU
    sim.run(2)
    sim.run(3)
    s = state
    for _ in range(5):
        s = wt.step(s, params, cfg)
    assert float(s.acc.abs().max()) > 1.0
    for f in dataclasses.fields(s):
        assert torch.equal(getattr(sim.state, f.name), getattr(s, f.name)), \
            f.name


@pytest.mark.parametrize("scene", ["mini-3d", "cloud-2d"])
@pytest.mark.parametrize("mode", MODES)
def test_rollout_and_trajectory_match_jax(mode, scene):
    """4 steps of ``rollout`` and of ``trajectory`` (a frame every 2 steps)
    against the JAX package's jitted ones; hash_grid at the reference's
    table size n."""
    (jcfg, jparams, jstate), (cfg, params, state) = _case(scene, mode)
    # JAX's rollout donates its state: hand it a copy
    _compare(wt.rollout(state, params, cfg, 4),
             wj.rollout(jax.tree.map(jnp.array, jstate), jparams, jcfg, 4),
             same_rows=True)
    final, frames = wt.trajectory(state, params, cfg, 4, 2)
    jfinal, jframes = wj.trajectory(jstate, jparams, jcfg, 4, 2)
    assert frames.shape == (2, cfg.n, cfg.dim) == tuple(jframes.shape)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), **TOL)
    _compare(final, jfinal, same_rows=True)
    assert float(np.abs(np.asarray(jfinal.acc)).max()) > 1.0


@pytest.mark.parametrize("mode", MODES)
def test_container_frame_with_a_moving_box_matches_jax(mode):
    """``grid_frame="container"`` in a translating, yawing box that the
    cloud fills to its walls: accepted, ignored by the neighbour search
    (world hash keys, all pairs), the box still moving the walls; 4 steps
    against the JAX package's, which never reads the field in these
    modes."""
    box = JContainer.create((0.1, 0.0, -0.1), (1.8, 1.8, 1.8),
                            velocity=(0.5, 0.0, 0.0), angular_velocity=0.4,
                            angle=0.3)
    (jcfg, jparams, jstate), (cfg, params, state) = _cloud(
        3, mode, container=box, grid_frame="container")
    assert cfg.grid_frame == jcfg.grid_frame == "container"
    got = wt.rollout(state, params, cfg, 4)
    _compare(got, wj.rollout(jstate, jparams, jcfg, 4), same_rows=True)
    # the moving walls took part: the world-frame box at rest differs
    still = wt.rollout(state, dataclasses.replace(
        params, container=wt.Container.create(
            (0.1, 0.0, -0.1), (1.8, 1.8, 1.8), device="cpu")),
        dataclasses.replace(cfg, grid_frame="world"), 4)
    assert not torch.equal(got.pos, still.pos)


@pytest.mark.parametrize("mode", MODES)
def test_step_makes_no_host_read_or_host_copy(monkeypatch, mode):
    """One step while every way a tensor reaches a Python value raises, and
    so does every way the step could copy host data into a tensor: a
    tensor made from Python data (``torch.tensor``) or a Python number
    written into one by item assignment. On the card each of them is a
    synchronisation or a host-to-device copy, which a CUDA graph capture
    refuses."""
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode=mode)
    want = wt.step(state, params, cfg)

    def refuse(*a, **k):
        raise AssertionError("a host read or host copy in the step")

    setitem = torch.Tensor.__setitem__

    def tensor_values_only(self, index, value):
        if not isinstance(value, torch.Tensor):
            refuse()
        setitem(self, index, value)

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__setitem__", tensor_values_only)
    monkeypatch.setattr(torch, "tensor", refuse)
    got = wt.step(state, params, cfg)
    monkeypatch.undo()
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name


@pytest.mark.parametrize("dim,want", [(2, [0.0, 1.0]), (3, [0.0, 1.0, 0.0])])
def test_up_direction_is_plus_y(dim, want):
    up = kernels.up_direction(dim, torch.float32, "cpu")
    assert up.dtype == torch.float32 and up.tolist() == want
    assert jnp.zeros(dim).at[1].set(1.0).tolist() == want
