"""frame.readback_ms_p50: the median of the harness's span around each
frame's reads (Simulation.positions, velocities, stats; host clock), over
the frames outside the traced span."""

import statistics


def read(run):
    spans = run.spans.get("readback_ms")
    return statistics.median(spans) if spans else None
