"""frame.step_ms_p50: the median of the harness's span around each
frame's Simulation.run and its synchronisation (host clock), over the
frames outside the traced span."""

import statistics


def read(run):
    spans = run.spans.get("step_ms")
    return statistics.median(spans) if spans else None
