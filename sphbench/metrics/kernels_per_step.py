"""kernels_per_step: device kernels (not copies or sets) in the traced
window, over the steps it ran: what one replay of the captured step
launches. The program's empty phase markers (``wst_phase_*``, launched
only while a profiler records, sphbench/phases.py) are not counted."""

from sphbench import phases


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.device:
        return None
    return sum(not e[0].startswith(phases.PREFIX)
               for e in tr.kernels()) / tr.steps
