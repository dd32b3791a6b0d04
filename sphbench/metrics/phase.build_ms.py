"""phase.build_ms: device ms a step of the captured step's build phase: the
build (the cell keys, the sort, the slot ranks' cummax, the row gather, the
plane scatter and fill, the counts), from the program's wst_phase_build
marker to the next marker (sphbench/phases.py), over the traced window's
steps. None where the trace holds no phase marker."""

from sphbench import phases


def read(run):
    return phases.phase_ms(run, "build")
