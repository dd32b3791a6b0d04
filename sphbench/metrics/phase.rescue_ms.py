"""phase.rescue_ms: device ms a step of the captured step's rescue phase: the
rescue (the density gather, the selection, the cell walk and R1; then R2:
its two segments summed, 0.0 where the step has no rescue budget), from the
program's wst_phase_rescue marker to the next marker (sphbench/phases.py),
over the traced window's steps. None where the trace holds no phase marker."""

from sphbench import phases


def read(run):
    return phases.phase_ms(run, "rescue")
