"""Profiling hooks — the counterpart of
``water_sandbox_tpu/runtime/profiling.py``: a device trace of any
simulation span through ``torch.profiler``, written as a Chrome trace
(chrome://tracing, Perfetto), and a host-side section timer for coarse
breakdowns.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


# The profiler places the card's events on the host's clock by a
# conversion that can put a span's first kernels a few milliseconds before
# the profiler's own start, and the trace drops what lies before its start:
# a trace of back-to-back graph replays then lacks its first replays. Idle
# host time on both sides of the span, with the card synchronised, keeps
# every event of the span inside the trace.
TRACE_MARGIN_S = 0.1


@contextlib.contextmanager
def traced(activities=None):
    """``torch.profiler.profile`` over the enclosed span (host activity,
    and the card's when a CUDA device is present, unless ``activities``
    says otherwise), with the card synchronised and ``TRACE_MARGIN_S`` of
    idle time before and after the span. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if activities is None:
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(TRACE_MARGIN_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed span with ``traced``: host activity, and the
    card's kernels and copies when a CUDA device is present. Writes
    ``<logdir>/trace.json`` (Chrome trace format) on exit and yields the
    profiler, whose ``key_averages()`` sums the span by operator:

        with profiling.device_trace("traces"):
            sim.run(100)
    """
    os.makedirs(logdir, exist_ok=True)
    with traced() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SectionTimer:
    """Host-side wall-clock sections with a device sync at each boundary:
    ``sync`` if given, else ``torch.cuda.synchronize`` when a CUDA device is
    present, else nothing."""

    def __init__(self, sync=None):
        self.sections: dict[str, float] = {}
        if sync is None and torch.cuda.is_available():
            sync = torch.cuda.synchronize
        self._sync = sync or (lambda: None)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.sections[name] = (self.sections.get(name, 0.0)
                                   + time.perf_counter() - t0)

    def summary(self) -> dict:
        return dict(sorted(self.sections.items(), key=lambda kv: -kv[1]))
