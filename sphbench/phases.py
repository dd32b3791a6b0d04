"""The captured step's phases, read from the program's phase markers in
the device trace.

The program launches an empty kernel named ``wst_phase_<phase>`` at the
head of each phase of its step while a profiler records (build, density,
rescue, force, rescue, integrate; no rescue without a rescue budget).
``split`` partitions the traced window by them:

1. the device events are sorted by start;
2. each ``wst_phase_build`` marker opens a step;
3. a phase lasts from its marker's start to the next marker's start;
4. a step's last phase ends at the latest end among the events before the
   next ``wst_phase_build`` marker (the last step's: among all events);
5. from there to that marker is the replay gap;
6. the steps are the ``build`` markers counted;
7. a phase marked twice in a step (the rescue) sums its segments.

When the window starts with a build marker, the phases and the gaps add up
to the window. A trace with no build marker gives None.
"""

from __future__ import annotations

import re

PREFIX = "wst_phase_"
PHASES = ("build", "density", "rescue", "force", "integrate")
_NAME = re.compile(re.escape(PREFIX) + r"([a-z]+)")


def _phase(name: str):
    m = _NAME.match(name)
    return m.group(1) if m else None


def split(tr):
    """``{"steps": n, "<phase>_us": summed over the steps, ...,
    "gap_us": summed}`` from the markers of ``tr`` (a ``trace.Trace``), or
    None when it holds no build marker."""
    if tr is None or not tr.device:
        return None
    ev = sorted(tr.device, key=lambda e: e[1])
    marks = []                       # (index in ev, phase, start)
    for i, (name, a, _) in enumerate(ev):
        p = _phase(name)
        if p is not None:
            marks.append((i, p, a))
    steps = sum(1 for m in marks if m[1] == "build")
    if not steps:
        return None
    # the latest end among ev[:k], for every k
    reach, hi = [], float("-inf")
    for _, _, b in ev:
        hi = max(hi, b)
        reach.append(hi)
    out = {f"{p}_us": 0.0 for p in PHASES}
    out["gap_us"] = 0.0
    for k, (i, p, a) in enumerate(marks):
        nxt = marks[k + 1] if k + 1 < len(marks) else None
        if nxt is not None and nxt[1] != "build":
            end = nxt[2]
        else:
            end = reach[(nxt[0] if nxt else len(ev)) - 1]
            if nxt is not None:
                out["gap_us"] += nxt[2] - end
        out.setdefault(f"{p}_us", 0.0)
        out[f"{p}_us"] += end - a
    out["steps"] = steps
    return out


def phase_ms(run, phase: str):
    """Device ms a step of ``phase`` (0.0 where the step has no such
    marker), or None without markers."""
    s = split(run.trace)
    if s is None:
        return None
    return s[f"{phase}_us"] / 1e3 / s["steps"]
