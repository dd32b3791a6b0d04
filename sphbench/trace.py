"""The device trace of a run's traced span, and its reduction.

``traced`` is a frozen copy of ``water_sandbox_tpu_torch/runtime/
profiling.py::traced``, margins included: the profiler places the card's
events on the host's clock by a conversion that can put a span's first
kernels a few milliseconds before the profiler's own start, and the trace
drops what lies before its start, so idle host time on both sides of the
span, with the card synchronised, keeps every event of the span inside the
trace.

Because the two clocks can sit milliseconds apart, the traced window is
read on the device's clock: from the first device event's start to the
last one's end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

TRACE_MARGIN_S = 0.1


@contextlib.contextmanager
def traced(activities=None):
    """``torch.profiler.profile`` over the enclosed span (host activity,
    and the card's when a CUDA device is present), with the card
    synchronised and ``TRACE_MARGIN_S`` of idle time before and after the
    span. Yields the profiler."""
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


@dataclasses.dataclass
class Trace:
    """What a metric reads of a traced span: device events and host events
    as (name, start_us, end_us), and the steps the span ran."""
    device: list
    host: list
    steps: int

    @property
    def window_us(self) -> float:
        if not self.device:
            return 0.0
        return (max(e[2] for e in self.device)
                - min(e[1] for e in self.device))

    def busy_us(self) -> float:
        """The time in which at least one device event ran."""
        iv = sorted((a, b) for _, a, b in self.device)
        if not iv:
            return 0.0
        busy, (lo, hi) = 0.0, iv[0]
        for a, b in iv[1:]:
            if a > hi:
                busy += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        return busy + hi - lo

    def gaps(self) -> list:
        """Idle stretches of the device in the window, (start_us, end_us)."""
        iv = sorted((a, b) for _, a, b in self.device)
        out, hi = [], iv[0][1] if iv else 0.0
        for a, b in iv[1:]:
            if a > hi:
                out.append((hi, a))
            hi = max(hi, b)
        return out

    def kernels(self) -> list:
        return [e for e in self.device
                if not e[0].lower().startswith(("memcpy", "memset"))]

    def device_us_by_name(self) -> dict:
        out: dict = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + b - a
        return out


# The prefix of the harness's own labels (record_function), which the
# profiler also shows on the device's timeline as annotations.
LABEL = "sphbench."


def reduce(prof, steps: int) -> Trace:
    """The profiler's events as a ``Trace``; the harness's labels count
    as host events only."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        on_device = (e.device_type == DeviceType.CUDA
                     and not e.name.startswith(LABEL))
        (dev if on_device else host).append(item)
    return Trace(device=dev, host=host, steps=steps)


# Entries of each breakdown list, and the idle gaps that are attributed.
TOP = 10
LONGEST = 2000


def breakdown(tr: Trace) -> dict:
    """The ``TOP`` device operations that took most time, and the
    ``LONGEST`` idle gaps summed by what the host was doing at each gap's
    middle (the innermost host event there), in seconds."""
    import bisect
    ops = sorted(tr.device_us_by_name().items(), key=lambda kv: -kv[1])
    host = sorted(tr.host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    idle: dict = {}
    for a, b in sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:LONGEST]:
        mid = (a + b) / 2
        name = "no host event"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[k][2] >= mid:
                name = host[k][0]
                break
        idle[name] = idle.get(name, 0.0) + b - a
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops[:TOP]],
            "idle_gaps": [[n[:120], us / 1e6] for n, us in gaps[:TOP]]}
