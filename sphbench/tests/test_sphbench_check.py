"""The yardstick on the CPU at small sizes: the roofline arithmetic, the
traffic's schedule, the plain reference against the port's CPU path, the
lower-precision control, and whole runs with the timed path broken
underneath, which the check has to call not correct."""

import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sphbench import cell as cell_mod, check, drive, inputs, roofline
from sphbench.copies import true_pairs
from sphbench.reference import sph

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return json.loads((ROOT / "sphbench" / name).read_text())


# ------------------------------------------------------------- roofline --

def test_roofline_on_a_lattice_whose_pairs_are_known():
    """A k^3 lattice at spacing 0.2 with h = 0.25 has exactly its axis
    neighbours within h: n self pairs and 2 * 3 k^2 (k - 1) others."""
    k = 6
    ax = torch.arange(k, dtype=torch.float32) * 0.2
    pts = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    pts = pts.reshape(-1, 3)
    n = k**3
    pairs = true_pairs(pts, torch.tensor(0.25))
    assert pairs == n + 6 * k * k * (k - 1)
    others = pairs - n
    ops, nbytes = roofline.density_work(n, pairs)
    assert ops == others / 2 * 12 + others * 2 + n * 6
    assert nbytes == 20 * n
    ops, nbytes = roofline.force_work(n, pairs)
    assert ops == others / 2 * 27 + others * 13 + n * 9
    assert nbytes == 44 * n
    name = "NVIDIA H100 80GB HBM3"
    # byte-bound: 44 n bytes at 3.35 TB/s, over a pass of 1 ms
    share = roofline.share((1.0, 44.0 * n), 1e-3, name)
    assert share == pytest.approx(100 * 44.0 * n / 3.35e12 / 1e-3)
    assert roofline.share((67e12 * 1e-3, 1.0), 1e-3, name) == pytest.approx(
        100.0)
    assert roofline.share((1.0, 1.0), 1e-3, "cpu") is None


# -------------------------------------------------------------- traffic --

def test_the_frames_schedule_repeats_for_a_seed():
    tr = _load("traffic/frames60.json")
    frames = 1200
    a = drive.plan(tr, 2**31 + 99, frames)
    assert a == drive.plan(tr, 2**31 + 99, frames)
    assert a != drive.plan(tr, 2**31 + 98, frames)
    assert a.resets == frozenset({600})
    assert sorted(a.keys) == list(range(30, frames, 60))
    seq = [a.keys[f] for f in sorted(a.keys)]
    for b in range(0, len(seq) - len(seq) % 6, 6):
        block = "".join(seq[b:b + 6])
        assert sorted(block) == sorted("qwaser")
        for first, second in tr["key_pairs"]:
            assert block.index(first) < block.index(second)
    assert len(a.samples) == tr["samples"] == len(set(a.samples))
    assert any(f % 600 == 0 for f in a.samples)
    lo, hi = tr["landing"]
    assert sum(lo <= f % 600 < hi for f in a.samples) >= 2
    assert any(f in a.keys for f in a.samples)


def test_the_start_state_repeats_for_a_seed():
    conf = _load("configs/reference-cube.json")
    a = inputs.start_positions(conf, 2**31 + 5, "cpu")
    assert torch.equal(a, inputs.start_positions(conf, 2**31 + 5, "cpu"))
    b = inputs.start_positions(conf, 2**31 + 6, "cpu")
    assert not torch.equal(a, b)
    lattice = inputs.start_positions(dict(conf, jitter=0.0), 1, "cpu")
    assert float((a - lattice).abs().max()) <= 0.01 * 0.2 * 1.0001


# ------------------------------------------------------------ reference --

def _small(name):
    """The configuration at a test's size: an 8^3 lattice in a 4 m box
    (the moving box keeps its motion), with a grid to fit."""
    conf = _load(f"configs/{name}.json")
    conf.update(n=512, lattice=[8, 8, 8])
    conf["container"]["size"] = [4.0, 4.0, 4.0]
    conf["sim_config"]["grid_dims"] = [20, 20, 20]
    return conf


@pytest.mark.parametrize("name", ["moving-container-256k", "reference-cube"])
def test_the_reference_agrees_with_the_ports_cpu_path(name):
    """Steps of the port's pipeline on the CPU (its kernels' plain
    versions) from a jittered lattice, each held against the float64
    reference from the same state, under the cell limits; the bfloat16
    control on the same states fails them."""
    conf = _small(name)
    limits = _load("limits/flagship.settled.json")
    sim = inputs.simulation(conf, inputs.start_positions(conf, 7, "cpu"),
                            name)
    prm, box = inputs.params(conf), inputs.box(conf)
    worst, worst_low = {}, {}
    for done in range(12):
        pre = check.by_id(sim.state)
        sim.run(1)
        got = check.by_id(sim.state)
        if done not in (0, 5, 11):
            continue
        args = (pre["pos"].astype(np.float32), pre["vel"].astype(np.float32),
                prm, box, done)
        ref = check._np(sph.step(*args, torch.float64))
        low = check._np(sph.step(*args, torch.bfloat16))
        for out, w in ((got, worst), (dict(low, step=done + 1.0,
                                          time=float(low["time"])),
                                     worst_low)):
            for k, v in check._gaps(out, ref, prm, done + 1).items():
                w[k] = max(w.get(k, 0.0), v)
    held = {k: limits[k] for k in worst}
    assert check.judge(worst, held)[0], worst
    assert not check.judge(worst_low, held)[0], worst_low


# ------------------------------------------------------- runs, faults --

# cube.frames60 waits under PERF.md's Open questions (its frame tail
# follows the host's speed, not the program's); its files stay under
# sphbench/, and these tests drive the open loop through them.
PARKED = {"cube.frames60": ("reference-cube", "frames60",
                            [{"name": "frame_ms_p95", "unit": "ms"},
                             {"name": "setup_s", "unit": "s"}])}

# The upstream cube dropped again and again: the closed loop with a reset
# every 300 steps, its traffic here and its limits the cube's numbers of
# the closed loop (no cell runs it yet).
DROP = {"loop": "closed", "settle_steps": 50, "chunk": 50,
        "reset_every": 300, "landing": [65, 85], "samples": 6,
        "trace_from_chunk": 0, "trace_chunks": 6}
CLOSED_NUMBERS = ("start", "params", "clock", "density", "acc", "pos", "vel")


def _load_cell(workload):
    if workload == "cube.drop":
        limits = _load("limits/cube.frames60.json")
        return cell_mod.Cell(
            workload, 1, _load("configs/reference-cube.json"), dict(DROP),
            {k: limits[k] for k in CLOSED_NUMBERS},
            [{"name": "ms_per_step", "unit": "ms"},
             {"name": "setup_s", "unit": "s"}], [])
    if workload not in PARKED:
        return cell_mod.load(workload, ROOT)
    config, traffic, e2e = PARKED[workload]
    return cell_mod.Cell(workload, 1, _load(f"configs/{config}.json"),
                         _load(f"traffic/{traffic}.json"),
                         _load(f"limits/{workload}.json"), e2e, [])


# The drop at a test's size: the cube lands near step 12 of a 20-step drop
# (lowered 1 m in the box), with cells of capacity 3, so the rescue takes
# rows in at the start and in the landing.
SMALL_DROP = {"settle_steps": 5, "chunk": 5, "reset_every": 20,
              "landing": [10, 15], "trace_from_chunk": 0, "trace_chunks": 4}


def _cell(workload):
    """The workload's cell at a test's size, with its own limits."""
    c = _load_cell(workload)
    conf = _small(c.config["name"])
    tr = copy.deepcopy(c.traffic)
    if tr["loop"] == "open":
        tr.update(reset_every=20, landing=[5, 10], key_every=6, key_phase=3,
                  trace_from_frame=4, trace_frames=3)
    elif "reset_every" in tr:
        tr.update(SMALL_DROP)
        conf["lattice_center"] = [0.0, -1.0, 0.0]
        conf["sim_config"]["cell_capacity"] = 3
    else:
        tr.update(settle_steps=5, chunk=5)
    return cell_mod.Cell(c.name, c.chips, conf, tr, c.limits, c.end_to_end,
                         c.per_layer)


def _run(workload, seconds=0.5, control=False):
    from sphbench.run import run_cell
    return run_cell(_cell(workload), 2**31 + 17, seconds, False, "cpu",
                    time.perf_counter(), control=control)


@pytest.mark.parametrize("workload", ["flagship.settled", "cube.frames60",
                                      "cube.drop"])
def test_a_sound_run_is_correct_and_its_control_is_not(workload):
    out = _run(workload, control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert [k for k in out if not k.startswith("_")][-1] == "checks"
    assert out["_control_correct"] is False, out["_control"]
    names = {m["name"] for m in _cell(workload).end_to_end}
    assert set(out["metrics"]) <= names and "setup_s" in out["metrics"]


def _unchanged(real):
    def step(state, params, cfg):
        return state.clone()
    return step


def _half(real):
    """Half of the particles (odd ids) left out: their rows come back as
    they went in."""
    def step(state, params, cfg):
        new = real(state, params, cfg)
        keep = (state.ids % 2 == 1)
        old_row = torch.empty_like(state.ids, dtype=torch.long)
        old_row[state.ids.long()] = torch.arange(state.ids.shape[0])
        rows = old_row[new.ids.long()]
        sel = keep[rows]
        out = {}
        for f in ("pos", "vel", "predicted", "acc", "density",
                  "near_density", "pressure", "near_pressure"):
            a, b = getattr(new, f), getattr(state, f)[rows]
            m = sel.view(-1, *([1] * (a.dim() - 1)))
            out[f] = torch.where(m, b, a)
        import dataclasses
        return dataclasses.replace(new, **out)
    return step


def _altered(real):
    """One particle's position altered where the step produces it."""
    def step(state, params, cfg):
        new = real(state, params, cfg)
        new.pos[0, 0] += 0.1
        return new
    return step


def _in_landing(real, broken):
    """The step broken only in the small drop's landing."""
    lo, hi = SMALL_DROP["landing"]

    def step(state, params, cfg):
        if lo <= int(state.step_count) < hi:
            return broken(state, params, cfg)
        return real(state, params, cfg)
    return step


@pytest.mark.parametrize("workload", ["flagship.settled", "cube.frames60",
                                      "cube.drop"])
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged, half of the particles left out, an answer altered where it
    is produced; in the drop, only inside its landing. (The cells run on
    one chip: no exchange between chips to leave out.)"""
    from water_sandbox_tpu_torch.ops import step as step_mod
    broken = fault(step_mod.step)
    if workload == "cube.drop":
        broken = _in_landing(step_mod.step, broken)
    monkeypatch.setattr(step_mod, "step", broken)
    out = _run(workload)
    assert not out["correct"], out["checks"]


def test_a_reset_that_does_nothing_is_not_correct(monkeypatch):
    from water_sandbox_tpu_torch.runtime.runner import Simulation
    monkeypatch.setattr(Simulation, "reset", lambda self: self)
    out = _run("cube.drop")
    assert not out["correct"], out["checks"]


# --------------------------------------------------------- the drop loop --

class _Clock:
    """A host clock that moves only when the fake program steps."""
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class _Program:
    """Stands in for ``Simulation`` in the closed loop's schedule: each step
    moves the clock by ``step_s`` and adds ``rows`` to the rescue's
    counter, and step ``lost`` after a reset leaves a row uncomputed; a
    reset zeroes the step count, the counter and ``overflow_total``."""

    def __init__(self, clock, step_s, rows=0, lost=None):
        from water_sandbox_tpu_torch.core.state import init_state
        self.clock, self.step_s, self.rows = clock, step_s, rows
        self.lost = lost
        self.device = torch.device("cpu")
        self.state = init_state(torch.zeros(4, 3), device="cpu")
        self.params = type("P", (), dict(dict.fromkeys(inputs.PARAM_NAMES,
                                                       0.0),
                                         gravity=[0.0, -9.8, 0.0]))()
        self.graph = type("G", (), {})()
        self.graph.rescued = torch.zeros((), dtype=torch.int64)

    def run(self, n, block=True):
        done = int(self.state.step_count)
        self.clock.t += n * self.step_s
        self.state.step_count.add_(n)
        self.graph.rescued.add_(self.rows * n)
        if self.lost is not None and done <= self.lost < done + n:
            self.state.overflow_total.add_(1.0)

    def reset(self):
        self.state.step_count.zero_()
        self.state.overflow_total.zero_()
        self.graph.rescued.zero_()


def _schedule(tr, seed, step_s, trace=False, rows=0, lost=None,
              monkeypatch=None):
    clock = _Clock()
    monkeypatch.setattr(drive, "time", clock)
    sim = _Program(clock, step_s, rows, lost)
    if "reset_every" in tr:
        sim.reset()
    run = drive.Run(loop="closed", n=4, device_name="cpu")
    drive.closed(sim, tr, 20.0, seed, trace, run,
                 drive.Snapshots(sim.state, 2 * tr["samples"] + 2))
    return run


@pytest.mark.parametrize("trace", [False, True])
def test_the_settled_loop_samples_the_same_steps_as_before(trace,
                                                           monkeypatch):
    """flagship.settled's traffic, at 0.88 ms a step on a clock that moves
    only with the steps: the chunks and steps of its samples, as the loop
    took them before it could reset."""
    run = _schedule(_load("traffic/settled.json"), 2**31 + 17, 0.88e-3,
                    trace, monkeypatch=monkeypatch)
    assert [(sm.index, sm.steps_done) for sm in run.samples] == [
        (16, 1400), (158, 8500), (171, 9150), (258, 13500)]
    assert run.steps == 22750 and run.resets == 0
    assert run.traced_steps == (100 if trace else 0)


@pytest.mark.parametrize("trace", [False, True])
def test_a_drop_is_sampled_at_its_first_step_and_in_its_landing(trace,
                                                               monkeypatch):
    """The drop's traffic at 0.4 ms a step: each sample lies at its drawn
    step of a drop, none in the traced drops; the steps since the reset
    are the program's own count; the rescued rows are every step's."""
    run = _schedule(DROP, 2**31 + 31, 0.4e-3, trace, rows=3,
                    monkeypatch=monkeypatch)
    every, chunk = DROP["reset_every"], DROP["chunk"]
    done = [sm.steps_done for sm in run.samples]
    assert sorted(done) == sorted(drive.drop_steps(DROP, 2**31 + 31))
    lo, hi = DROP["landing"]
    assert 0 in done and sum(lo <= d < hi for d in done) >= 2
    assert len(done) == DROP["samples"] == len(set(done))
    traced = DROP["trace_chunks"] * chunk if trace else 0
    for sm in run.samples:
        assert int(sm.pre.step_count) == sm.steps_done
        assert int(sm.post.step_count) == sm.steps_done + 1
        assert sm.index * chunk % every <= sm.steps_done
        assert sm.steps_done < sm.index * chunk % every + chunk
        assert sm.index * chunk >= traced
    assert run.steps % every == 0 and run.resets == run.steps // every - 1
    assert run.rescued_rows == 3 * run.steps
    assert run.traced_steps == traced


@pytest.mark.parametrize("lost", [10, 70])
def test_a_row_left_uncomputed_fails_in_every_drop(lost, monkeypatch):
    """A reset puts ``overflow_total`` back to the start's: the check takes
    its baseline again, so each drop's lost row fails its chunk, in the
    drop's first chunk too."""
    run = _schedule(DROP, 2**31 + 37, 0.4e-3, lost=lost,
                    monkeypatch=monkeypatch)
    assert run.resets > 10
    assert run.failed == DROP["chunk"] * (run.resets + 1)


@pytest.mark.parametrize("bad", [
    {"reset_every": 310},                     # not whole chunks of 50
    {"trace_chunks": 3},                      # half a drop traced
    {"trace_from_chunk": 2},                  # traced from inside a drop
    {"landing": [280, 320]},                  # beyond the drop
    {"samples": 400, "reset_every": 350}])    # more samples than steps
def test_a_drop_that_is_not_whole_chunks_or_traced_in_whole_drops_is_refused(
        bad):
    c = _load_cell("cube.drop")
    tr = dict(c.traffic, **bad)
    with pytest.raises(ValueError):
        drive.setup(cell_mod.Cell(c.name, 1, c.config, tr, c.limits,
                                  c.end_to_end, []), 1, "cpu")
    drive.check_traffic(c.traffic)


def test_a_drop_run_counts_its_rescued_rows_and_reads_nothing_in_the_window(
        monkeypatch):
    """At a cell capacity that overflows: the run's rescued rows are the
    per-step counts of the window's steps summed across its resets; its
    samples hold a first step after a reset and two landing steps, each
    with the steps since the reset; and ``drive.closed`` reads no tensor
    on the host before its final synchronisation."""
    from sphbench.run import run_cell
    from water_sandbox_tpu_torch.ops import step as step_mod
    from water_sandbox_tpu_torch.ops.cuda import rescue
    real, counts, at = step_mod.step, [], []

    def step(state, params, cfg):
        before = int(rescue._COUNTER.rows)
        at.append(int(state.step_count))
        new = real(state, params, cfg)
        counts.append(int(rescue._COUNTER.rows) - before)
        return new
    monkeypatch.setattr(step_mod, "step", step)
    reads, synced = [], []
    for name in ("item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, _orig=orig, _name=name):
            f = sys._getframe(1)
            if f.f_code.co_filename == drive.__file__ and not synced:
                reads.append((_name, f.f_code.co_name, f.f_lineno))
            return _orig(self, *a)
        monkeypatch.setattr(torch.Tensor, name, read)
    real_closed, real_sync, runs = drive.closed, drive._sync, []

    def closed(sim, tr, seconds, seed, trace, run, snaps):
        reads.clear()
        synced.clear()
        runs.append(run)
        real_closed(sim, tr, seconds, seed, trace, run, snaps)

    def sync(sim):
        real_sync(sim)
        synced.append(True)
    monkeypatch.setattr(drive, "closed", closed)
    monkeypatch.setattr(drive, "_sync", sync)
    c = _cell("cube.drop")
    out = run_cell(c, 2**31 + 29, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert reads == []
    # set-up's steps, then the window's
    window = counts[-out["attempted"]:]
    assert len(counts) == c.traffic["settle_steps"] + out["attempted"]
    assert out["attempted"] >= 2 * c.traffic["reset_every"]
    every = c.traffic["reset_every"]
    # the window starts at a drop and resets every ``every`` steps
    assert at[-len(window):] == [k % every for k in range(len(window))]
    drops = [sum(window[k:k + every]) for k in range(0, len(window), every)]
    assert all(d > 0 for d in drops), drops
    run, = runs
    assert run.rescued_rows == sum(window)
    assert run.resets == len(drops) - 1
    done = [sm.steps_done for sm in run.samples]
    lo, hi = c.traffic["landing"]
    assert 0 in done and sum(lo <= d < hi for d in done) >= 2
    assert len(done) == c.traffic["samples"] == len(set(done))
    for sm in run.samples:
        assert int(sm.pre.step_count) == sm.steps_done
        assert int(sm.post.step_count) == sm.steps_done + 1


def test_an_altered_readback_is_not_correct(monkeypatch):
    from water_sandbox_tpu_torch.runtime.runner import Simulation
    real = Simulation.positions

    def positions(self):
        out = real(self)
        out[3, 1] += 0.01
        return out
    monkeypatch.setattr(Simulation, "positions", positions)
    out = _run("cube.frames60")
    assert not out["correct"]
    got = out["checks"]["readback_pos"]
    assert got["value"] > got["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cells run at full size there")
    return "cuda:0"


@pytest.mark.parametrize("workload", ["flagship.settled", "cube.frames60",
                                      "cube.drop"])
def test_on_the_card_the_cell_is_correct_and_its_control_is_not(card,
                                                                 workload):
    from sphbench.run import run_cell
    c = _load_cell(workload)
    out = run_cell(c, 2**31 + 23, 3.0, False, card, time.perf_counter(),
                   control=True)
    assert out["correct"], out["checks"]
    assert out["_control_correct"] is False, out["_control"]
