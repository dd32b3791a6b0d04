"""phase.density_ms: device ms a step of the captured step's density phase:
the density kernel (K1) and its parameter vector, from the program's
wst_phase_density marker to the next marker (sphbench/phases.py), over the
traced window's steps. None where the trace holds no phase marker."""

from sphbench import phases


def read(run):
    return phases.phase_ms(run, "density")
