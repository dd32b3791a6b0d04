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


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed span with torch.profiler: host activity, and the
    card's kernels and copies when a CUDA device is present. Writes
    ``<logdir>/trace.json`` (Chrome trace format) on exit and yields the
    profiler, whose ``key_averages()`` sums the span by operator:

        with profiling.device_trace("traces"):
            sim.run(100)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
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
