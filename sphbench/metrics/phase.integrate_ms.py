"""phase.integrate_ms: device ms a step of the captured step's integrate
phase: integration, the box's collision, the next state and the copy back
into the state buffers, from the program's wst_phase_integrate marker to
the next marker (sphbench/phases.py), over the traced window's steps. None
where the trace holds no phase marker."""

from sphbench import phases


def read(run):
    return phases.phase_ms(run, "integrate")
