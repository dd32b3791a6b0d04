"""The harness driving the port's ``DistributedSimulation``: the
configuration ``sharded-1m`` (the million-particle scene on four shards of
one card) and its cell ``sharded-1m.steps``, the adapter ``sharded.py``,
and the reader ``shard_overlap``.

The port's migration moves a particle's positions, velocity and id to its
new shard but not the density, pressures and acceleration the step
computed for it: the state after a step holds another slot's values for
each particle that migrated in it, and the check reads that as a wrong
density. Until the program carries them, the cell waits outside
``BENCHMARK.json`` (PERF.md, Open questions), and the runs here that are
to come out correct step through ``carrying``, the port's migration with
those fields carried after it: the stand-in for the repair. At the tests'
size (512 particles on two shards, the cube falling onto the floor)
particles cross the shards' boundary on most steps."""

import dataclasses
import functools
import json
import math
import time
from pathlib import Path

import pytest
import torch

from sphbench import cell as cell_mod, check, drive, sharded
from sphbench.copies import fingerprint
from sphbench.run import run_cell
from sphbench.tests import test_sphbench_check as HARNESS
from sphbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "sharded-1m.steps"
CONFIG = "sharded-1m"
PER_LAYER = {"device_idle_share", "kernels_per_step", "library_ms_per_step",
             "shard_overlap"}
# The cell's entries as BENCHMARK.json is to hold them once the program
# carries a migrated particle's fields.
PARKED = {"name": CELL, "config": CONFIG, "traffic": "settled", "chips": 1,
          "why": "domain step (per-shard build on B, K1/K3, D1/D2 at count "
                 "0, halo and migration, I and P a shard) replayed from step "
                 "600 on four streams"}
PARKED_CONFIG = {"name": CONFIG, "file": f"sphbench/configs/{CONFIG}.json",
                 "reduced": [],
                 "why": "the domain-decomposed step: 1,015,920 particles in a "
                        "static 100x10x18 box on 4 shards of one card, a "
                        "stream a shard"}
SHARD_OVERLAP = {"name": "shard_overlap", "unit": "x", "better": "higher",
                 "source": "device_trace", "layer": "domain step",
                 "moves": "ms_per_step", "workloads": [CELL]}
CARRIED = ("acc", "density", "near_density", "pressure", "near_pressure")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return json.loads((ROOT / "sphbench" / name).read_text())


def _metrics(names):
    bench = cell_mod.benchmark(ROOT)
    return [m for m in bench["end_to_end"] + bench["per_layer"]
            if m["name"] in names]


def _cell():
    """The cell from its files: as BENCHMARK.json names it where it does,
    else from its parked entry."""
    bench = cell_mod.benchmark(ROOT)
    if any(w["name"] == CELL for w in bench["workloads"]):
        return cell_mod.load(CELL, ROOT)
    e2e = _metrics({"ms_per_step", "setup_s"})
    per_layer = _metrics(PER_LAYER - {"shard_overlap"}) + [SHARD_OVERLAP]
    return cell_mod.Cell(CELL, PARKED["chips"],
                         _load(f"configs/{CONFIG}.json"),
                         _load(f"traffic/{PARKED['traffic']}.json"),
                         _load(f"limits/{CELL}.json"), e2e, per_layer)


def carrying(real):
    """``parallel/domain.py::_migrate`` with the fields the step computed
    for each particle (``CARRIED``) taken along to the slot it lands in,
    looked up by id among the rows that were active before the move."""
    def migrate(states, active, params, cfg, gx_loc, mesh, mig_cap):
        moved, act, lost = real(states, active, params, cfg, gx_loc, mesh,
                                mig_cap)
        n = cfg.n
        tables = {}
        for f in CARRIED:
            like = getattr(states[0], f)
            t = torch.zeros((n + 1,) + tuple(like.shape[1:]),
                            dtype=like.dtype, device=like.device)
            for s, a in zip(states, active):
                t[torch.where(a > 0, s.ids.long(), n)] = getattr(s, f)
            tables[f] = t
        out = []
        for s, a in zip(moved, act):
            rows = torch.where(a > 0, s.ids.long(), n)
            new = {}
            for f, t in tables.items():
                x = getattr(s, f)
                keep = (a > 0).reshape((-1,) + (1,) * (x.dim() - 1))
                new[f] = torch.where(keep, t[rows], x)
            out.append(dataclasses.replace(s, **new))
        return out, act, lost
    return migrate


def carry(monkeypatch):
    """Step through ``carrying``, on a mesh whose shards share the
    caller's stream (the lookup reads every shard's rows)."""
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    monkeypatch.setattr(domain, "_migrate", carrying(domain._migrate))
    monkeypatch.setattr(mesh_mod, "make_mesh",
                        functools.partial(mesh_mod.make_mesh, serial=True))


# ------------------------------------------------------------- the cell --

def test_the_cell_loads_from_its_files_on_one_card_with_nothing_cut():
    c = _cell()
    conf = _load(f"configs/{CONFIG}.json")
    assert c.config == conf and conf["reduced"] == []
    assert c.chips == 1
    assert conf["runtime"] == {"kind": "distributed", "n_shards": 4,
                               "slack": 2.0, "mig_cap": 1024}
    assert c.traffic == _load("traffic/settled.json")
    drive.check_traffic(c.traffic)
    sharded.refuse(c.traffic)


def test_its_parked_entries_keep_the_benchmark_s_rules():
    """The entries that will add the cell, by the rules the layout tests
    hold BENCHMARK.json to."""
    from sphbench.tests import test_sphbench_layout as LAYOUT
    conf = _load(f"configs/{CONFIG}.json")
    names = [CELL, CONFIG, PARKED["traffic"], SHARD_OVERLAP["name"]]
    assert all(LAYOUT.NAME.match(n) for n in names)
    assert LAYOUT.UNIT.match(SHARD_OVERLAP["unit"])
    for text in (PARKED["why"], PARKED_CONFIG["why"], conf["source"],
                 SHARD_OVERLAP["layer"]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert PARKED_CONFIG["reduced"] == conf["reduced"] == []
    assert (ROOT / PARKED_CONFIG["file"]).is_file()


def test_its_configuration_is_the_ports_sharded_1m():
    """Built through ``water_sandbox_tpu_torch/models/scenes.py``: the
    lattice, the grid, the capacities, the box and every parameter."""
    from sphbench import inputs
    from water_sandbox_tpu_torch.models import scenes

    conf = _load(f"configs/{CONFIG}.json")
    cfg, prm, state = scenes.build(CONFIG, device="cpu")
    assert cfg.n == conf["n"] == 1015920
    lattice = inputs.start_positions(dict(conf, jitter=0.0), 1, "cpu")
    assert torch.equal(lattice, state.pos)
    for k, v in conf["sim_config"].items():
        want = getattr(cfg, k)
        assert (list(want) if isinstance(want, tuple) else want) == v, k
    for k in inputs.PARAM_NAMES:
        assert float(getattr(prm, k)) == inputs.params(conf)[k], k
    assert [float(x) for x in prm.gravity] == inputs.params(conf)["gravity"]
    box = inputs.box(conf)
    c = prm.container
    assert [float(x) for x in c.center] == box["center"]
    assert [2 * float(x) for x in c.half_size] == box["size"]
    assert [float(x) for x in c.velocity] == box["velocity"]
    assert float(c.angular_velocity) == box["angular_velocity"]
    assert float(prm.field.strength) == 0.0


def test_its_limits_hold_the_closed_loop_numbers_and_it_reports_its_metrics():
    c = _cell()
    assert set(c.limits) == set(HARNESS.CLOSED_NUMBERS)
    assert {m["name"] for m in c.end_to_end} == {"ms_per_step", "setup_s"}
    assert {m["name"] for m in c.per_layer} == PER_LAYER
    for m in c.end_to_end + c.per_layer:
        assert callable(cell_mod.reader(m["name"], ROOT))
    assert not any(m["name"].startswith("phase.") or "roofline" in m["name"]
                   or m["name"] == "replay_gap_us" for m in c.per_layer)


# ------------------------------------------------------ runs on the CPU --

SMALL = {"settle_steps": 5, "chunk": 5}


def _small(samples=4):
    """The cell at a test's size: the harness tests' 512-particle cube in a
    4 m box, on two shards, with a rescue budget the CPU sweeps quickly."""
    c = _cell()
    conf = HARNESS._small(CONFIG)
    conf["runtime"] = dict(conf["runtime"], n_shards=2)
    conf["sim_config"]["rescue_capacity"] = 16
    return dataclasses.replace(
        c, config=conf, traffic=dict(c.traffic, samples=samples, **SMALL))


def _run(cell, seed=2**31 + 53, control=False):
    return run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter(),
                    control=control)


def test_a_small_two_shard_run_is_correct_and_its_control_is_not(
        monkeypatch):
    carry(monkeypatch)
    runs = []
    real = drive.closed

    def closed(sim, tr, seconds, seed, trace, run, snaps):
        real(sim, tr, seconds, seed, trace, run, snaps)
        runs.append(sim)
    monkeypatch.setattr(drive, "closed", closed)
    out = _run(_small(), control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["_control_correct"] is False, out["_control"]
    assert set(out["metrics"]) == {"ms_per_step", "setup_s"}
    sim, = runs
    assert isinstance(sim, sharded.Sharded) and sim.n_shards == 2
    assert sum(sim.shard_counts()) == 512
    got = fingerprint(sim)
    assert (got["n_shards"], got["step"]) == (2, "eager")
    assert "sph_domain_rescue" in got["kernels"]


def _dropping(real):
    """The migration, with the particle in shard 0's first active slot
    dropped from ``active`` on every step."""
    def migrate(*args):
        states, act, lost = real(*args)
        a = act[0].clone()
        first = torch.argmax((a > 0).to(torch.int32))
        a[first] = 0.0
        return states, [a] + list(act[1:]), lost
    return migrate


def test_a_particle_dropped_from_active_reads_infinite(monkeypatch):
    from water_sandbox_tpu_torch.parallel import domain
    carry(monkeypatch)
    monkeypatch.setattr(domain, "_migrate", _dropping(domain._migrate))
    out = _run(_small(samples=2))
    assert not out["correct"]
    assert out["checks"]["density"]["value"] == math.inf


def test_a_dense_snapshot_short_of_a_particle_is_no_permutation():
    from water_sandbox_tpu_torch.core.state import init_state
    half = [init_state(torch.rand(3, 3), device="cpu") for _ in range(2)]
    half[1] = dataclasses.replace(half[1], ids=half[1].ids + 3)
    active = [torch.ones(3), torch.tensor([1.0, 0.0, 1.0])]
    s = sharded.dense(sharded.Snap(half, active), 6)
    assert s.ids.shape[0] == 6 and check.by_id(s) is None
    s = sharded.dense(sharded.Snap(half, [torch.ones(3)] * 2), 6)
    assert torch.equal(s.ids, torch.arange(6, dtype=torch.int32))
    assert torch.equal(s.pos[3:], half[1].pos)


def _unchanged(real):
    def step(states, active, params):
        zero = torch.zeros((), device=states[0].pos.device)
        return [s.clone() for s in states], [a.clone() for a in active], zero
    return step


def _half(real):
    """Every other shard's rows come back as they went in."""
    def step(states, active, params):
        new, act, lost = real(states, active, params)
        return ([n if d % 2 else s.clone()
                 for d, (s, n) in enumerate(zip(states, new))],
                [n if d % 2 else a.clone()
                 for d, (a, n) in enumerate(zip(active, act))], lost)
    return step


def _altered(real):
    """One particle's position altered where the step produces it."""
    def step(states, active, params):
        new, act, lost = real(states, active, params)
        new[0].pos[0, 0] += 0.1
        return new, act, lost
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, "exchange"])
def test_a_broken_domain_step_is_not_correct(fault, monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged, half of the shards left out, an answer altered where it is
    produced, and the halo exchange between the shards left out."""
    from water_sandbox_tpu_torch.parallel import domain
    carry(monkeypatch)
    if fault == "exchange":
        monkeypatch.setattr(domain, "_exchange_halo_slabs",
                            lambda planes, *a: planes)
    else:
        real = domain.make_domain_step
        monkeypatch.setattr(domain, "make_domain_step",
                            lambda *a, **k: fault(real(*a, **k)))
    out = _run(_small())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("bad", [{"reset_every": 300}, {"loop": "open"}])
def test_traffic_that_resets_or_runs_the_open_loop_is_refused(bad):
    c = _cell()
    with pytest.raises(ValueError, match="no reset"):
        drive.setup(dataclasses.replace(c, traffic=dict(c.traffic, **bad)),
                    1, "cpu")


def test_an_unknown_runtime_is_refused():
    from sphbench import inputs
    conf = _small().config
    conf["runtime"] = dict(conf["runtime"], kind="replicas")
    with pytest.raises(ValueError, match="unknown runtime"):
        inputs.simulation(conf, inputs.start_positions(conf, 1, "cpu"), "x")


# -------------------------------------------------------- shard_overlap --

def _overlap(device, steps=1):
    run = drive.Run(loop="closed", n=4, device_name="cpu",
                    trace=Trace(device, [], steps))
    return cell_mod.reader("shard_overlap", ROOT)(run)


def test_shard_overlap_reads_how_far_the_device_work_overlaps():
    serial = [("k1", 0.0, 10.0), ("k2", 10.0, 15.0), ("k3", 20.0, 30.0)]
    assert _overlap(serial) == 1.0
    assert _overlap([("k", 0.0, 10.0), ("k", 0.0, 10.0)]) == 2.0
    # the phase markers are not work
    assert _overlap(serial + [("wst_phase_build", 0.0, 30.0)]) == 1.0
    assert _overlap([]) is None
    run = drive.Run(loop="closed", n=4, device_name="cpu")
    assert cell_mod.reader("shard_overlap", ROOT)(run) is None


# ---------------------------------------------------------- on the card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell runs at full size there")
    return "cuda:0"


def test_on_the_card_the_cell_is_correct_and_its_control_is_not(
        card, monkeypatch):
    carry(monkeypatch)
    out = run_cell(_cell(), 2**31 + 59, 3.0, False, card,
                   time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert out["_control_correct"] is False, out["_control"]
