"""One step of the port against one step of the JAX package from a common
state, compared particle by particle through ``ids``: the sorted-state
step against the JAX sorted-state Pallas step (interpret mode), and the
particle-order step against the JAX XLA bucket step; then ``mini-3d``
rollouts in the three plain neighbour modes against the JAX package's, and
``trajectory``. Bar: rtol = atol = 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

import water_sandbox_tpu as wj
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert

TOL = dict(rtol=2e-4, atol=2e-4)
PER_PARTICLE = ("pos", "vel", "predicted", "acc", "density", "near_density",
                "pressure", "near_pressure")


def _common(n=96, seed=0, **cfg_kw):
    rng = np.random.default_rng(seed)
    pts = ((rng.random((n, 3)) - 0.5) * 1.6).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    jparams = wj.SimParams.create(dim=3)
    jstate = wj.init_state(jnp.asarray(pts), jnp.asarray(vel))
    jcfg = wj.SimConfig(n=n, dim=3, grid_dims=(8, 8, 8), cell_capacity=8,
                        **cfg_kw)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)],
        device="cpu")
    state = wt.init_state(pts, vel, device="cpu")
    cfg = wt.SimConfig(**dataclasses.asdict(jcfg))
    return jparams, jstate, jcfg, params, state, cfg


def _by_id(fields, ids):
    out = {}
    for k in PER_PARTICLE:
        o = np.empty_like(fields[k])
        o[ids] = fields[k]
        out[k] = o
    return out


def _compare(got, want, same_rows):
    g = convert.state_to_numpy(got)
    w = {f.name: np.asarray(getattr(want, f.name))
         for f in dataclasses.fields(want)}
    if same_rows:
        np.testing.assert_array_equal(g["ids"], w["ids"])
    assert sorted(g["ids"].tolist()) == list(range(g["ids"].shape[0]))
    gi, wi = _by_id(g, g["ids"]), _by_id(w, w["ids"])
    for k in PER_PARTICLE:
        np.testing.assert_allclose(gi[k], wi[k], **TOL, err_msg=k)
    for k in ("step_count", "overflow", "overflow_total"):
        assert g[k] == w[k], k
    np.testing.assert_allclose(g["time"], w["time"], rtol=1e-7)


def test_sorted_step_matches_jax():
    jparams, jstate, jcfg, params, state, cfg = _common(
        neighbor_mode="pallas", sorted_state=True, rescue_capacity=64)
    want = jax.jit(wj.step, static_argnums=2)(jstate, jparams, jcfg)
    got = wt.step(state, params, cfg)
    # same keys, same stable sort: the rows come back in the same order
    _compare(got, want, same_rows=True)


def test_particle_order_step_matches_jax_xla():
    jparams, jstate, jcfg, params, state, cfg = _common(
        n=300, seed=3, neighbor_mode="pallas", rescue_capacity=64)
    want = wj.rollout(jstate, jparams,
                      dataclasses.replace(jcfg, neighbor_mode="bucket_grid"),
                      2)
    got = wt.rollout(state, params, cfg, 2)
    np.testing.assert_array_equal(got.ids.numpy(), np.arange(300))
    _compare(got, want, same_rows=True)


def test_rollout_counts_steps_and_keeps_ids():
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         sorted_state=True)
    s = wt.rollout(state, params, cfg, 3)
    assert int(s.step_count) == 3
    assert float(s.time) == pytest.approx(3 / 60, rel=1e-6)
    assert sorted(s.ids.tolist()) == list(range(cfg.n))
    assert s.ids.dtype == torch.int32 and s.step_count.dtype == torch.int32
    assert float(s.overflow_total) == 0.0


@pytest.mark.parametrize("mode", ["dense", "bucket_grid", "hash_grid"])
def test_mini_3d_rollout_matches_jax(mode):
    """4 steps of mini-3d (512 particles) in each plain neighbour mode, the
    same mode on both sides; hash_grid with the reference's table size n;
    a (20, 16, 16) grid at cell capacity 8 keeps bucket_grid's pair blocks
    small (the scene's own grid spans the whole default container)."""
    kw = dict(neighbor_mode=mode, grid_dims=(20, 16, 16), cell_capacity=8)
    jcfg, jparams, jstate = wj.scenes.build("mini-3d", **kw)
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu", **kw)
    assert cfg.resolved().neighbor_mode == mode
    want = wj.rollout(jstate, jparams, jcfg, 4)
    got = wt.rollout(state, params, cfg, 4)
    assert float(np.abs(np.asarray(want.acc)).max()) > 1.0
    _compare(got, want, same_rows=True)


def test_trajectory_stacks_positions_and_rejects_a_remainder():
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode="dense")
    jcfg, jparams, jstate = wj.scenes.build("mini-3d", neighbor_mode="dense")
    final, frames = wt.trajectory(state, params, cfg, 4, 2)
    jfinal, jframes = wj.trajectory(jstate, jparams, jcfg, 4, 2)
    assert frames.shape == (2, cfg.n, 3) == tuple(jframes.shape)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), **TOL)
    np.testing.assert_array_equal(frames[-1].numpy(), final.pos.numpy())
    assert int(final.step_count) == 4
    with pytest.raises(ValueError, match="divisible"):
        wt.trajectory(state, params, cfg, 7, 2)
    # the kernel pipeline records too ("auto" means it in the port)
    cfg_k, params_k, state_k = wt.scenes.build("mini-3d", device="cpu")
    _, frames_k = wt.trajectory(state_k, params_k, cfg_k, 2)
    _, frames_d = wt.trajectory(state, params, cfg, 2)
    np.testing.assert_allclose(frames_k.numpy(), frames_d.numpy(), **TOL)


def test_rollout_and_trajectory_step_the_buffers_like_a_step_loop():
    """The kernel pipeline's rollout and trajectory run ops/cuda/graph.py's
    StepGraph (on the CPU: eager steps into its buffers): bit for bit a
    loop of step, with the device-gated rescue firing past its budget; the
    caller's state stays as it was."""
    from water_sandbox_tpu_torch.ops.cuda import graph
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         sorted_state=True, cell_capacity=4,
                                         rescue_capacity=16)
    s, frames = state, []
    for _ in range(4):
        s = wt.step(s, params, cfg)
        frames.append(s.pos)
    assert float(s.overflow_total) > 0
    got = wt.rollout(state, params, cfg, 4)
    for f in dataclasses.fields(s):
        assert torch.equal(getattr(got, f.name), getattr(s, f.name)), f.name
    final, rec = wt.trajectory(state, params, cfg, 4, 2)
    assert torch.equal(rec, torch.stack(frames[1::2]))
    assert torch.equal(final.vel, s.vel)
    assert int(state.step_count) == 0
    # every mode's rebuild step; the incremental step is IncrementalGraph's
    with pytest.raises(ValueError, match="rebuild step"):
        graph.StepGraph(state, params,
                        dataclasses.replace(cfg, sorted_state=False,
                                            incremental_rebuild=4))
