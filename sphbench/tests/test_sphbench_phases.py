"""The phase readers (``sphbench/phases.py``, ``metrics/phase.*_ms.py``,
``metrics/replay_gap_us.py``) on synthetic traces: the partition adds up
to the window over the steps, the rescue's two segments are summed, a
step without a rescue reads 0.0 there, and a trace with no marker reads
None. The readers of the step's kernels (``kernels_per_step``,
``library_ms_per_step``) leave the markers out."""

from pathlib import Path

import pytest

from sphbench import cell as cell_mod, phases
from sphbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
READERS = ["phase.build_ms", "phase.density_ms", "phase.rescue_ms",
           "phase.force_ms", "phase.integrate_ms", "replay_gap_us"]

# one step: (name, length us, idle us before it); markers last 1 us
STEP = [("wst_phase_build", 1.0, 0.0), ("cummax_scan", 600.0, 0.5),
        ("cat_copy", 150.0, 0.5),
        ("wst_phase_density", 1.0, 0.5), ("sph_density_kernel", 32.0, 0.5),
        ("wst_phase_rescue", 1.0, 0.5), ("gather", 4.0, 0.5),
        ("rescue_density_kernel", 2.0, 0.5),
        ("wst_phase_force", 1.0, 0.5), ("sph_force_kernel", 102.0, 0.5),
        ("gather_results", 20.0, 0.5),
        ("wst_phase_rescue", 1.0, 0.5), ("rescue_force_kernel", 2.0, 0.5),
        ("wst_phase_integrate", 1.0, 0.5), ("integrate", 60.0, 0.5),
        ("copy_back", 30.0, 0.5)]
GAP = 7.0


class Run:
    def __init__(self, trace):
        self.trace = trace


def _trace(steps: int, step=STEP, gap=GAP, t0=1000.0) -> Trace:
    dev, t = [], t0
    for k in range(steps):
        if k:
            t += gap
        for name, length, idle in step:
            t += idle
            dev.append((name, t, t + length))
            t += length
    # the profiler's order is not the start order
    dev.reverse()
    return Trace(device=dev, host=[("wst.run", t0 - 50, t + 50)],
                 steps=steps)


def _segment(step, first: str, until: str) -> float:
    """us from marker ``first`` to marker ``until`` in one step."""
    t, at = 0.0, {}
    for name, length, idle in step:
        t += idle
        at.setdefault(name, []).append(t)
        t += length
    return at[until][0] - at[first][0]


def _read(trace) -> dict:
    return {m: cell_mod.reader(m, ROOT)(Run(trace)) for m in READERS}


@pytest.mark.parametrize("steps", [1, 100])
def test_the_phases_and_the_gap_add_up_to_the_window(steps):
    tr = _trace(steps)
    got = _read(tr)
    assert all(v is not None and v >= 0 for v in got.values()), got
    total = (sum(got[m] for m in READERS[:5]) * 1e3
             + got["replay_gap_us"])
    assert total == pytest.approx(tr.window_us / steps, rel=1e-12)
    assert got["phase.density_ms"] * 1e3 == pytest.approx(
        _segment(STEP, "wst_phase_density", "wst_phase_rescue"))
    assert got["phase.build_ms"] * 1e3 == pytest.approx(
        _segment(STEP, "wst_phase_build", "wst_phase_density"))
    assert got["replay_gap_us"] == pytest.approx(GAP * (steps - 1) / steps)


def test_the_two_rescue_segments_are_summed():
    got = _read(_trace(3))
    first = 1.0 + 0.5 + 4.0 + 0.5 + 2.0 + 0.5     # to the force marker
    second = 1.0 + 0.5 + 2.0 + 0.5                # to the integrate marker
    assert got["phase.rescue_ms"] * 1e3 == pytest.approx(first + second)
    last = 1.0 + 0.5 + 60.0 + 0.5 + 30.0          # to the step's last end
    assert got["phase.integrate_ms"] * 1e3 == pytest.approx(last)


def test_a_step_without_a_rescue_reads_zero_there():
    step = [e for e in STEP if "rescue" not in e[0]]
    tr = _trace(4, step=step)
    got = _read(tr)
    assert got["phase.rescue_ms"] == 0.0
    assert all(got[m] > 0 for m in READERS if m != "phase.rescue_ms")
    total = (sum(got[m] for m in READERS[:5]) * 1e3
             + got["replay_gap_us"])
    assert total == pytest.approx(tr.window_us / 4, rel=1e-12)


def test_a_window_with_no_marker_reads_none():
    unmarked = [e for e in STEP if not e[0].startswith("wst_phase_")]
    assert set(_read(_trace(5, step=unmarked)).values()) == {None}
    assert set(_read(None).values()) == {None}
    assert set(_read(Trace(device=[], host=[], steps=0)).values()) == {None}


def test_markers_are_found_by_prefix_whatever_follows_the_phase():
    step = [(n + "()" if n.startswith("wst_phase_") else n, a, b)
            for n, a, b in STEP]
    assert _read(_trace(2, step=step)) == _read(_trace(2))
    assert phases.split(_trace(2))["steps"] == 2


def test_the_markers_are_neither_kernels_of_the_step_nor_library_time():
    """Of a step with six markers, a memcpy, a set, the build kernel and
    the port's other kernels, ``kernels_per_step`` counts the kernels that
    are no marker, and ``library_ms_per_step`` the time of what is neither
    a marker nor one of the port's kernels."""
    step = STEP + [("void wst::sph_build_kernel<3>(int const*)", 28.0, 0.5),
                   ("Memcpy DtoD (Device -> Device)", 9.0, 0.5),
                   ("Memset (Device)", 2.0, 0.5)]
    tr = _trace(3, step=step)
    marks = [e for e in step if e[0].startswith(phases.PREFIX)]
    assert len(marks) == 6
    kernels = cell_mod.reader("kernels_per_step", ROOT)(Run(tr))
    assert kernels == len(step) - len(marks) - 2 == 11
    library = cell_mod.reader("library_ms_per_step", ROOT)(Run(tr))
    aten = ("cummax_scan", "cat_copy", "gather", "gather_results",
            "integrate", "copy_back", "Memcpy DtoD (Device -> Device)",
            "Memset (Device)")
    want = sum(length for name, length, _ in step if name in aten)
    assert want == 600 + 150 + 4 + 20 + 60 + 30 + 9 + 2
    assert library * 1e3 == pytest.approx(want)
