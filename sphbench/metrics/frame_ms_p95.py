"""frame_ms_p95: the 95th percentile over every frame of the open loop's
window, each frame timed from its due time on the frame clock to the
moment its reads are on the host (host clock)."""

import statistics


def read(run):
    if run.loop != "open" or len(run.frame_ms) < 2:
        return None
    return statistics.quantiles(run.frame_ms, n=100, method="inclusive")[94]
