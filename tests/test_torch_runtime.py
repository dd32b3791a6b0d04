"""The port's runtime: checkpoints in the JAX package's npz format read in
both directions (one step compared after each load), and the Simulation
API — run/pause/reset, live tuning, id-ordered observation, stats."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

import water_sandbox_tpu as wj
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu.runtime import checkpoint as jcheckpoint
from water_sandbox_tpu_torch.runtime import checkpoint as tcheckpoint
from water_sandbox_tpu_torch.runtime.runner import SimPhase

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_state_after(steps):
    cfg, params, state = wj.scenes.build("mini-3d", grid_dims=(20, 16, 16))
    params = params.replace(pressure_scalar=30.0)
    xla = dataclasses.replace(cfg, neighbor_mode="bucket_grid")
    return cfg, params, wj.rollout(state, params, xla, steps)


def _by_id(pos, ids):
    out = np.empty_like(pos)
    out[np.asarray(ids)] = np.asarray(pos)
    return out


def test_jax_checkpoint_loads_in_port(tmp_path):
    jcfg, jparams, jstate = _jax_state_after(3)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jstate, jparams, jcfg)
    state, params, cfg = tcheckpoint.load(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert float(params.pressure_scalar) == 30.0
    assert int(state.step_count) == 3 and state.ids.dtype == torch.int32
    np.testing.assert_array_equal(state.vel.numpy(), np.asarray(jstate.vel))
    want = wj.step(jstate, jparams,
                   dataclasses.replace(jcfg, neighbor_mode="bucket_grid"))
    got = wt.step(state, params, cfg)
    np.testing.assert_allclose(_by_id(got.pos.numpy(), got.ids),
                               _by_id(want.pos, want.ids), **TOL)
    np.testing.assert_allclose(got.density.numpy(), np.asarray(want.density),
                               **TOL)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         sorted_state=True,
                                         grid_dims=(20, 16, 16))
    params = params.replace(viscosity_strength=0.3)
    state = wt.rollout(state, params, cfg, 3)
    path = str(tmp_path / "port.npz")
    tcheckpoint.save(path, state, params, cfg)
    jstate, jparams, jcfg = jcheckpoint.load(path)
    assert jcfg.sorted_state and jcfg.grid_dims == (20, 16, 16)
    assert float(jparams.viscosity_strength) == np.float32(0.3)
    np.testing.assert_array_equal(np.asarray(jstate.ids), state.ids.numpy())
    want = wj.step(jstate, jparams,
                   dataclasses.replace(jcfg, neighbor_mode="bucket_grid",
                                       sorted_state=False))
    got = wt.step(state, params, cfg)
    np.testing.assert_allclose(_by_id(got.pos.numpy(), got.ids),
                               _by_id(want.pos, want.ids), **TOL)
    # and back into the port unchanged
    s2, p2, c2 = tcheckpoint.load(path, device="cpu")
    assert c2 == cfg
    for f in dataclasses.fields(s2):
        np.testing.assert_array_equal(getattr(s2, f.name).numpy(),
                                      getattr(state, f.name).numpy())


def _mini():
    return wt.Simulation.from_scene("mini-3d", device="cpu")


def test_run_pause_resume_reset():
    sim = _mini()
    assert sim.phase is SimPhase.READY and sim.cfg.neighbor_mode == "pallas"
    sim.run(3)
    assert int(sim.state.step_count) == 3
    sim.pause()
    sim.run(5)
    assert int(sim.state.step_count) == 3
    sim.pause()
    sim.run(2)
    p0 = sim.positions()
    sim.reset()
    assert int(sim.state.step_count) == 0 and sim.phase is SimPhase.READY
    sim.run(5)
    np.testing.assert_array_equal(sim.positions(), p0)


def test_tune_and_gravity():
    sim = _mini()
    sim.gravity_off()
    sim.tune(pressure_scalar=0.0, near_pressure_scalar=0.0,
             viscosity_strength=0.0)
    sim.run(2)
    assert np.abs(sim.velocities()).max() < 1e-6
    sim.gravity_on()
    sim.run(2)
    assert np.abs(sim.velocities()).max() > 0
    sim.tune(field={"position": (0.0, 0.0, 0.0), "strength": 30.0,
                    "radius": 5.0}, container={"velocity": (0.1, 0, 0)})
    assert float(sim.params.field.strength) == 30.0
    assert sim.params.container.velocity.tolist() == pytest.approx(
        [0.1, 0.0, 0.0])
    sim.run(1)
    assert np.isfinite(sim.positions()).all()


def test_sorted_state_observation_is_in_id_order():
    sim = wt.Simulation.from_scene("reference-cube", device="cpu")
    assert sim.cfg.sorted_state
    sim2 = wt.Simulation(*wt.scenes.build("mini-3d", device="cpu",
                                            sorted_state=True))
    sim2.run(3)
    ids = sim2.state.ids.numpy()
    assert not (ids == np.arange(ids.size)).all(), "rows were re-permuted"
    expect = np.empty_like(sim2.state.pos.numpy())
    expect[ids] = sim2.state.pos.numpy()
    np.testing.assert_array_equal(sim2.positions(), expect)
    snap = sim2.snapshot()
    assert snap["pos"].shape == (512, 3) and snap["ids"].dtype == np.int32


def test_stats_and_warmup_window():
    sim = _mini()
    sim.run(3)
    st = sim.stats()
    assert st["steps_timed"] == 0 and st["warmup_wall_s"] > 0
    sim.run(3)
    st = sim.stats()
    assert st["step"] == 6 and st["steps_timed"] == 3
    assert st["particle_steps_per_s"] > 0 and st["kinetic_energy"] > 0
    assert st["mean_density"] > 0


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The entry points default to the card and raise without one; they
    never fall back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        wt.Simulation.from_scene("mini-3d")
    with pytest.raises(RuntimeError, match="CUDA"):
        wt.scenes.build("mini-3d")
    assert wt.Simulation.from_scene("mini-3d", device="cpu").device == \
        torch.device("cpu")


def _rescuing(**kw):
    """mini-3d in the kernel pipeline, sorted, at cell capacity 4 with a
    rescue budget of 16: the rescue fires and runs past its budget on every
    step (the plain versions of its kernels, on the CPU)."""
    return wt.scenes.build("mini-3d", device="cpu", sorted_state=True,
                           cell_capacity=4, rescue_capacity=16, **kw)


def _equal_states(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_runs_step_the_buffers_as_one_rollout():
    """run(3) then run(4) equals rollout(7) bit for bit; the Simulation
    steps its own buffers in place and leaves the caller's tensors as they
    were."""
    cfg, params, state = _rescuing()
    sim = wt.Simulation(cfg, params, state)
    assert sim.graph is not None and not sim.graph.captures
    ptrs = [getattr(sim.state, f.name).data_ptr()
            for f in dataclasses.fields(sim.state)]
    sim.run(3)
    sim.run(4)
    _equal_states(sim.state, wt.rollout(state, params, cfg, 7))
    assert ptrs == [getattr(sim.state, f.name).data_ptr()
                    for f in dataclasses.fields(sim.state)]
    assert int(state.step_count) == 0 and int(sim.state.step_count) == 7
    assert float(sim.state.overflow_total) > 0, "the budget must overflow"


def test_tune_takes_effect_on_the_next_step():
    """tune(viscosity_strength=...) and tune(field={...}) copy into the
    parameter buffers: the next steps equal a fresh Simulation built with
    those parameters from the same state, and the caller's params stay."""
    cfg, params, state = _rescuing()
    sim = wt.Simulation(cfg, params, state)
    sim.run(2)
    mid = sim.state.clone()
    buf = sim.params.field.position
    sim.tune(viscosity_strength=0.3,
             field={"position": (0.1, -0.2, 0.0), "strength": -20.0,
                    "radius": 1.5})
    assert sim.params.field.position is buf
    sim.run(2)
    tuned = dataclasses.replace(
        params.replace(viscosity_strength=0.3),
        field=wt.InteractionField.create((0.1, -0.2, 0.0), -20.0, 1.5,
                                         device="cpu"))
    fresh = wt.Simulation(cfg, tuned, mid)
    fresh.run(2)
    _equal_states(sim.state, fresh.state)
    assert float(params.viscosity_strength) != 0.3
    assert float(params.field.strength) == 0.0
    with pytest.raises(TypeError, match="no field"):
        sim.tune(viscosity=0.2)
    with pytest.raises(ValueError, match="shape"):
        sim.tune(gravity=[0.0, 1.0])


def test_reset_copies_the_initial_state_back():
    cfg, params, state = _rescuing()
    sim = wt.Simulation(cfg, params, state)
    sim.run(3)
    first = sim.state.clone()
    sim.reset()
    _equal_states(sim.state, state)
    sim.run(3)
    _equal_states(sim.state, first)


@pytest.mark.parametrize("action", ["reset", "tune"])
def test_reset_and_tune_wait_for_a_running_step(action):
    """reset() or tune() from a second thread while run() steps waits for
    the step, as the viewer's request handlers do against its stepping
    thread: after it, the state is the whole reset, or the step taken with
    the old parameters and the new ones in place, never a mix."""
    cfg, params, state = _rescuing()
    sim = wt.Simulation(cfg, params, state)
    entered, go = threading.Event(), threading.Event()
    advance = sim.graph._advance

    def held_step():
        entered.set()
        go.wait(30)
        advance()

    sim.graph._advance = held_step
    stepper = threading.Thread(target=sim.run, args=(1,))
    stepper.start()
    assert entered.wait(30)
    other = threading.Thread(
        target=sim.reset if action == "reset"
        else lambda: sim.tune(viscosity_strength=0.3))
    other.start()
    other.join(0.3)
    blocked = other.is_alive()
    go.set()
    stepper.join(30)
    other.join(30)
    assert blocked, f"{action} ran while a step held the Simulation"
    if action == "reset":
        _equal_states(sim.state, state)
        assert sim.phase is SimPhase.READY
    else:
        _equal_states(sim.state, wt.rollout(state, params, cfg, 1))
        assert float(sim.params.viscosity_strength) == pytest.approx(0.3)
