"""The port's tracing (``runtime/profiling.py``): the kernel pipeline step's
phase spans and markers, the runtime's host spans and the rescued-rows
counter.

On the CPU: the eager steps' ``wst.phase.*`` spans in the step's order,
every program span of FUNCTION scope, no span made without a profiler, the
reads' copy before their reorder, and the counter against the rows the
build left beyond capacity. On the card (the ``cuda_device`` fixture skips
here): the second graph, with six markers, captured and replayed only for
profiled runs; a profiled run's markers, six a step in order and no
program span among the device events; the same bits with the markers on
and off. This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from _torch_fixtures import cuda_device  # noqa: F401 (fixture)
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
from water_sandbox_tpu_torch.runtime import profiling

STEP = ["build", "density", "rescue", "force", "rescue", "integrate"]
FUNCTION_SCOPE = 0   # torch's RecordScope::FUNCTION (USER_SCOPE is 7)


def _mini(device="cpu", **kw) -> wt.Simulation:
    return wt.Simulation.from_scene("mini-3d", device=device, **kw)


def _wst_events(prof) -> list:
    return sorted((e for e in prof.events() if e.name.startswith("wst.")),
                  key=lambda e: e.time_range.start)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("sorted_state", [False, True])
@pytest.mark.parametrize("rescue", [64, 0])
def test_eager_steps_mark_their_phases_in_order(sorted_state, rescue):
    sim = _mini(sorted_state=sorted_state, rescue_capacity=rescue)
    with _cpu_profile() as prof:
        sim.run(2)
    events = _wst_events(prof)
    phases = [e.name.removeprefix("wst.phase.") for e in events
              if e.name.startswith("wst.phase.")]
    want = STEP if rescue else [p for p in STEP if p != "rescue"]
    assert phases == want * 2
    run = [e for e in events if e.name == "wst.run"]
    assert len(run) == 1
    inner = [e for e in events if e.name.startswith("wst.phase.")]
    # each phase lies inside the run and ends before the next begins
    for a, b in zip(inner, inner[1:]):
        assert a.time_range.end <= b.time_range.start
    assert all(run[0].time_range.start <= e.time_range.start
               and e.time_range.end <= run[0].time_range.end for e in inner)


@pytest.mark.parametrize("mode", ["dense", "bucket_grid"])
def test_only_the_kernel_pipeline_step_is_marked(mode):
    sim = _mini(neighbor_mode=mode, rescue_capacity=16)
    with _cpu_profile() as prof:
        sim.run(1)
    names = [e.name for e in _wst_events(prof)]
    assert "wst.run" in names
    assert not [n for n in names if n.startswith("wst.phase.")]


def test_the_domain_step_spans_its_migration():
    """The eager domain step's migration is a ``wst.phase.migrate`` span of
    FUNCTION scope inside ``wst.run``, once a step."""
    sim = wt.DistributedSimulation.from_scene("mini-3d", n_shards=2,
                                              device="cpu")
    with _cpu_profile() as prof:
        sim.run(2)
    events = _wst_events(prof)
    run, = [e for e in events if e.name == "wst.run"]
    spans = [e for e in events if e.name == "wst.phase.migrate"]
    assert len(spans) == 2
    assert all(e.scope == FUNCTION_SCOPE
               and run.time_range.start <= e.time_range.start
               and e.time_range.end <= run.time_range.end for e in spans)


def test_program_spans_are_of_function_scope():
    sim = _mini(rescue_capacity=16)
    sim.run(1)
    with _cpu_profile() as prof:
        sim.run(1)
        sim.tune(viscosity_strength=0.01)
        sim.positions()
        sim.velocities()
        sim.stats()
        sim.reset()
    events = _wst_events(prof)
    names = {e.name for e in events}
    assert {"wst.run", "wst.tune", "wst.read.copy", "wst.read.reorder",
            "wst.stats", "wst.reset", "wst.phase.build"} <= names
    assert all(e.scope == FUNCTION_SCOPE for e in events), {
        (e.name, e.scope) for e in events if e.scope != FUNCTION_SCOPE}


def test_no_span_is_made_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} made with no profiler")
    monkeypatch.setattr(profiling, "_Span", refuse)
    sim = _mini(rescue_capacity=16)
    sim.run(2)
    sim.positions()
    sim.velocities()
    sim.stats()
    sim.tune(viscosity_strength=0.01)
    sim.reset()
    wt.step(sim.state, sim.params, sim.cfg)
    assert not profiling.recording()


@pytest.mark.parametrize("read", ["positions", "velocities"])
def test_reads_copy_before_they_reorder(read):
    sim = _mini(sorted_state=True)
    sim.run(2)
    with _cpu_profile() as prof:
        got = getattr(sim, read)()
    names = [e.name for e in _wst_events(prof)]
    assert names == ["wst.read.copy", "wst.read.reorder"]
    rows = (sim.state.pos if read == "positions" else sim.state.vel).numpy()
    want = np.empty_like(rows)
    want[sim.state.ids.numpy()] = rows
    np.testing.assert_array_equal(got, want)


def test_a_phase_span_closes_with_its_step():
    """An eager phase span lasts until the next phase or the end of the
    step; outside a step ``phase`` does nothing."""
    with _cpu_profile() as prof:
        profiling.phase("build")
        with profiling.phases():
            profiling.phase("build")
            profiling.phase("density")
        profiling.phase("force")
    names = [e.name for e in _wst_events(prof)]
    assert names == ["wst.phase.build", "wst.phase.density"]
    assert profiling._PHASES.open is None


@pytest.mark.parametrize("sorted_state", [False, True])
def test_rescued_rows_count_the_rows_beyond_capacity_less_the_unrescued(
        sorted_state):
    """mini-3d at cell capacity 2 drops rows every step, more than the
    budget of 24: the counter sums, over the steps, the rows the build
    left beyond capacity less those the rescue did not take in."""
    sim = _mini(sorted_state=sorted_state, cell_capacity=2,
                rescue_capacity=24)
    want, unrescued = 0, 0
    for _ in range(3):
        s = sim.state
        beyond = sb._build_core(s.predicted, s.vel, sim.params, sim.cfg,
                                time=s.time)[5]
        sim.run(1)
        want += int(beyond) - int(sim.state.overflow)
        unrescued += int(sim.state.overflow)
    assert unrescued > 0 and want > 0
    assert int(sim.graph.rescued) == want == 3 * 24
    assert sim.stats()["rescued_rows"] == want
    sim.reset()
    assert sim.stats()["rescued_rows"] == 0


def test_rescued_rows_stay_zero_without_overflow():
    sim = _mini(rescue_capacity=16)
    sim.run(2)
    assert int(sim.state.overflow_total) == 0
    assert sim.stats()["rescued_rows"] == 0


# ------------------------------------------------------------- the card --

def _captured(device, steps: int = 1):
    sim = _mini(device, rescue_capacity=64)
    sim.run(steps)
    return sim


def test_only_the_profiled_runs_replay_a_graph_with_markers(cuda_device):
    sim = _captured(cuda_device)
    g = sim.graph
    assert isinstance(g, graph_mod.StepGraph) and g.marked
    assert g.traced is not None and g.markers == STEP
    plain, traced = g.graph, g.traced
    launches = dict(g.per_replay)
    with _cpu_profile():
        sim.run(1)
    assert g.graph is plain and g.traced is traced
    assert g.per_replay == launches
    for mode in ("dense", "bucket_grid"):
        other = _mini(cuda_device, neighbor_mode=mode, rescue_capacity=16)
        with _cpu_profile():
            other.run(1)
        assert other.graph.traced is None and other.graph.markers == []


def test_profiled_replays_show_six_markers_a_step(cuda_device):
    sim = _captured(cuda_device, steps=2)
    with profiling.traced() as prof:
        sim.run(10)
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [e.name.removeprefix("wst_phase_") for e in dev
             if e.name.startswith("wst_phase_")]
    # a profiler session after others in one process can lose its first
    # device events (PERF.md §7): only the head of the first replay may lack
    lost = len(STEP) * 10 - len(marks)
    assert 0 <= lost < len(STEP) and marks == (STEP * 10)[lost:], marks[:8]
    assert not [e.name for e in dev if e.name.startswith("wst.")]
    host = {e.name for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA}
    assert "wst.run" in host


def test_markers_leave_the_state_as_it_was(cuda_device):
    on, off = _captured(cuda_device), _captured(cuda_device)
    with _cpu_profile():
        on.run(50)
    off.run(50)
    torch.cuda.synchronize()
    assert on.graph.markers == off.graph.markers == STEP
    for name in ("pos", "vel", "predicted", "acc", "density", "ids"):
        assert torch.equal(getattr(on.state, name), getattr(off.state, name))
