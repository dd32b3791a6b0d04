"""phase.force_ms: device ms a step of the captured step's force phase: the
force kernel (K2), the gather of its results and the pressures, from the
program's wst_phase_force marker to the next marker (sphbench/phases.py),
over the traced window's steps. None where the trace holds no phase marker."""

from sphbench import phases


def read(run):
    return phases.phase_ms(run, "force")
