"""shard_overlap: how far the device's work overlaps in the traced window:
the summed durations of every device event but the program's phase markers
(``wst_phase_*``, sphbench/phases.py), over the union of their intervals
(trace.Trace.busy_us). 1.0 where one stream ran at a time; with a stream a
shard, at most the shard count where every shard's work overlaps."""

from sphbench import phases
from sphbench.trace import Trace


def read(run):
    tr = run.trace
    if tr is None:
        return None
    work = Trace([e for e in tr.device if not e[0].startswith(phases.PREFIX)],
                 [], tr.steps)
    union = work.busy_us()
    if not union:
        return None
    return sum(b - a for _, a, b in work.device) / union
