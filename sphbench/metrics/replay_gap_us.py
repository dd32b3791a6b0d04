"""replay_gap_us: device us a step between the end of one replay's last
phase (its latest event) and the next replay's build marker, the gaps
summed over the traced window and divided by its steps (the last step
has none), so that the five phases plus the gap make up the window over
the steps (sphbench/phases.py). None where the trace holds no phase
marker."""

from sphbench import phases


def read(run):
    s = phases.split(run.trace)
    if s is None:
        return None
    return s["gap_us"] / s["steps"]
