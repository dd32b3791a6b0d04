"""Profiling hooks — the counterpart of
``water_sandbox_tpu/runtime/profiling.py``: a device trace of any
simulation span through ``torch.profiler``, written as a Chrome trace
(chrome://tracing, Perfetto), and what the port puts on that trace.

* Host spans (``span``): the runtime's and the front end's work as
  ``wst.*`` spans on the profiler's host timeline — ``wst.run``,
  ``wst.sync``, ``wst.capture``, ``wst.reset``, ``wst.tune``,
  ``wst.read.copy`` and ``wst.read.reorder``, ``wst.stats``, and the
  eager domain step's ``wst.phase.migrate`` around its migration
  (``parallel/domain.py``; a replayed step makes no host span). A span is a
  FUNCTION-scope record function, made only while a profiler records: with
  none, a span costs one flag read. (``torch.profiler.record_function``
  opens a USER_SCOPE span, which the profiler also lays on the device's
  timeline as an annotation as long as the span, counted among the
  device's events.)
* Phase markers (``phases``, ``phase``): the kernel pipeline's rebuild
  step calls ``phase(name)`` at the head of each of its phases (``PHASES``;
  the rescue twice, its density and its force half). Inside ``marking``,
  while ``ops/cuda/graph.py::StepGraph`` captures the step a second time,
  for the runs made while a profiler records, each call launches an empty
  kernel named ``wst_phase_<name>`` into that graph
  (``csrc/trace_mark.cu``), so the phases show inside a replay; the graph
  replayed while no profiler records has none. An eager step (the CPU;
  CUDA outside a capture) launches nothing: while a profiler records, each
  phase is a host span ``wst.phase.<name>`` that lasts until the next
  phase or the step's end.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch


# The profiler places the card's events on the host's clock by a
# conversion that can put a span's first kernels a few milliseconds before
# the profiler's own start, and the trace drops what lies before its start:
# a trace of back-to-back graph replays then lacks its first replays. Idle
# host time on both sides of the span, with the card synchronised, keeps
# every event of the span inside the trace.
TRACE_MARGIN_S = 0.1

# The phases of the kernel pipeline's rebuild step, in the order of
# csrc/trace_mark.cu's markers.
PHASES = ("build", "density", "rescue", "force", "integrate")


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


# ------------------------------------------------------------ host spans --

# A FUNCTION-scope record function (a context manager).
_Span = torch._C._profiler._RecordFunctionFast
_NO_SPAN = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records (one flag read)."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A host span ``name`` over a ``with`` block while a profiler records;
    otherwise a shared empty context, and no span is made."""
    if torch.autograd.profiler._is_profiler_enabled:
        return _Span(name)
    return _NO_SPAN


# --------------------------------------------------------- phase markers --

class _Phases(threading.local):
    on = False       # inside a step whose phases are marked (``phases``)
    open = None      # the eager span of the phase under way
    marks = None     # the phases marked in the capture under way
    device = 0       # and its device index


_PHASES = _Phases()


@contextlib.contextmanager
def phases(on: bool = True):
    """The scope of one step: inside it, with ``on``, ``phase`` marks the
    step's phases; an eager phase span still open closes on exit."""
    st = _PHASES
    was, st.on = st.on, on
    try:
        yield
    finally:
        st.on = was
        _close(st)


def phase(name: str) -> None:
    """The head of phase ``name`` (one of ``PHASES``) of the step under
    way: a marker kernel launched into the graph inside ``marking``, else
    a host span while a profiler records, else nothing. Outside ``phases``
    it does nothing, so the incremental, domain and sharded steps, which
    share the passes, stay unmarked."""
    st = _PHASES
    if not st.on:
        return
    if st.marks is not None:
        _mark(name, st.device)
        st.marks.append(name)
        return
    _close(st)
    if torch.autograd.profiler._is_profiler_enabled:
        st.open = _Span("wst.phase." + name)
        st.open.__enter__()


def _close(st: _Phases) -> None:
    if st.open is not None:
        span, st.open = st.open, None
        span.__exit__(None, None, None)


def _mark(name: str, device: int) -> None:
    """Launch the marker of phase ``name`` on the current stream of
    ``device``."""
    from ..ops.cuda import _build
    _build.check(_build.entry("wst_phase_mark")(
        PHASES.index(name), device,
        torch.cuda.current_stream(device).cuda_stream),
        f"phase marker {name!r} not launched")


@contextlib.contextmanager
def marking(device: int):
    """While a step is captured on ``device`` inside this block, ``phase``
    launches its marker into the graph; yields the list of the phases
    marked, in launch order."""
    st = _PHASES
    st.marks, st.device = [], device
    try:
        yield st.marks
    finally:
        st.marks = None
