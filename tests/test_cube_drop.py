"""The benchmark cell ``cube.drop``: the upstream sandbox's cube
(``reference-cube``) dropped into its box and reset every 300 steps.

The cell is loaded from its files as the benchmark loads it; its traffic
is the drop that ``sphbench/tests/test_sphbench_check.py`` drives, so the
two cannot part. At that file's test size (512 particles lowered 1 m,
cell capacity 3) a run through ``sphbench.run.run_cell`` on the CPU is
held to the float64 reference, its bfloat16 control is not, and the new
reader of the rescue's counter reads the run's rows a drop."""

import dataclasses
import json
import time
from pathlib import Path

import pytest

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from sphbench import cell as cell_mod, drive
from sphbench.run import run_cell
# the harness's own tests: their DROP, SMALL_DROP, CLOSED_NUMBERS, _small
from sphbench.tests import test_sphbench_check as HARNESS

ROOT = Path(__file__).resolve().parents[1]
CELL = "cube.drop"
READER = "rescued_rows_per_drop"
# the cell's per-layer metrics: those the flagship reports but the two
# rooflines (their pair count is too rough over a drop), and the rows a drop
PER_LAYER = {"device_idle_share", "kernels_per_step", "library_ms_per_step",
             "phase.build_ms", "phase.density_ms", "phase.rescue_ms",
             "phase.force_ms", "phase.integrate_ms", "replay_gap_us", READER}


def test_the_cell_is_the_upstream_scene_on_one_card():
    c = cell_mod.load(CELL, ROOT)
    conf = json.loads((ROOT / "sphbench/configs/reference-cube.json")
                      .read_text())
    assert c.config == conf and conf["reduced"] == []
    assert c.chips == 1
    assert set(c.limits) == set(HARNESS.CLOSED_NUMBERS)
    bench = cell_mod.benchmark(ROOT)
    entry, = (x for x in bench["configs"] if x["name"] == "reference-cube")
    assert entry["file"] == "sphbench/configs/reference-cube.json"
    assert entry["reduced"] == [] and entry["source"] == conf["source"]


def test_its_traffic_is_the_drop_the_harness_tests_drive():
    c = cell_mod.load(CELL, ROOT)
    assert c.traffic == HARNESS.DROP
    drive.check_traffic(c.traffic)


def test_it_reports_the_rows_a_drop_and_no_roofline():
    c = cell_mod.load(CELL, ROOT)
    assert {m["name"] for m in c.end_to_end} == {"ms_per_step", "setup_s"}
    assert {m["name"] for m in c.per_layer} == PER_LAYER
    m, = (m for m in c.per_layer if m["name"] == READER)
    assert (m["unit"], m["better"], m["layer"], m["moves"],
            m["source"]) == ("rows/drop", "lower", "rescue", "ms_per_step",
                             "program_counter")


def _small_drop():
    """The loaded cell at the harness tests' drop size."""
    c = cell_mod.load(CELL, ROOT)
    conf = HARNESS._small(c.config["name"])
    conf["lattice_center"] = [0.0, -1.0, 0.0]
    conf["sim_config"]["cell_capacity"] = 3
    return dataclasses.replace(c, config=conf,
                               traffic=dict(c.traffic, **HARNESS.SMALL_DROP))


def test_a_small_drop_is_correct_its_control_is_not_and_rows_are_rescued(
        monkeypatch):
    real, runs = drive.closed, []

    def closed(sim, tr, seconds, seed, trace, run, snaps):
        runs.append(run)
        real(sim, tr, seconds, seed, trace, run, snaps)
    monkeypatch.setattr(drive, "closed", closed)
    out = run_cell(_small_drop(), 2**31 + 43, 0.5, False, "cpu",
                   time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["_control_correct"] is False, out["_control"]
    assert set(out["metrics"]) == {"ms_per_step", "setup_s"}
    run, = runs
    assert run.resets >= 1
    got = cell_mod.reader(READER, ROOT)(run)
    assert got > 0 and got == run.rescued_rows / (run.resets + 1)


@pytest.mark.parametrize("rows, resets, want", [
    (None, 0, None), (30, 2, 10.0), (0, 0, 0.0)])
def test_the_reader_reads_the_rows_over_the_drops(rows, resets, want):
    """None without a count (the open loop's runs keep none)."""
    run = drive.Run(loop="closed", n=4, device_name="cpu", rescued_rows=rows,
                    resets=resets)
    assert cell_mod.reader(READER, ROOT)(run) == want
