"""The kernel pipeline's rebuild step as a captured CUDA graph — the
counterpart of the JAX package's device-only rollout (``jax.jit`` over
``lax.scan``, ``water_sandbox_tpu/ops/step.py:121-140``).

``StepGraph`` holds static buffers: the ``FluidState`` fields it steps and
every ``SimParams`` leaf the step reads, container and field included. On
a CUDA device its first ``run`` warms the step up on a side stream (the
kernels build and load, the allocator and cub's temporary storage fill —
the counterpart of JAX's first compile), puts the buffers back as they
were, and captures one step that ends by copying its outputs into its own
input buffers; each later step is one ``cudaGraphLaunch``
(``CUDAGraph.replay``). One step a graph, not several: a replay then
advances exactly one step for any ``run(n)``, and the launch a step costs
is one graph launch against the ~270 kernels it replaces. The capture
refuses any host read or synchronisation in the step
(``torch.cuda.graph`` raises), and a failed capture raises: nothing falls
back to the eager loop. On the CPU ``run`` steps eagerly into the same
buffers.

The graph reads the buffers by address, so the owner changes parameters by
copying into them (``Simulation.tune``) and the next replay sees the new
values, with no recapture. A graph also replays the code it was captured
under, so a graph belongs to its owner and is never shared: a patched
context (``golden.flipped_near_derivative``, a forced row group) captures
its own.

Kernel launches are counted as the eager step counts them: the wrappers'
counters (``LAUNCHES`` of ``sph_bucket``, ``rescue``, ``bitonic_sort``)
move only while the step is captured, and each replay adds what the
capture counted; warm-up launches are not counted.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ...core.params import SimConfig, SimParams
from ...core.state import FluidState

# Eager steps on a side stream before the capture.
WARMUP_STEPS = 2


def _counters() -> tuple:
    from . import bitonic_sort, rescue, sph_bucket
    return sph_bucket.LAUNCHES, rescue.LAUNCHES, bitonic_sort.LAUNCHES


def _read_counters() -> list:
    return [dict(c) for c in _counters()]


def _set_counters(values: list) -> None:
    for c, v in zip(_counters(), values):
        c.update(v)


def copy_state(dst: FluidState, src: FluidState) -> None:
    """Copy every field of ``src`` into the buffers of ``dst``."""
    for f in dataclasses.fields(FluidState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class StepGraph:
    """``run(n)`` advances ``state`` by n steps of ``ops/step.py::step`` in
    place, reading ``params`` in place: on CUDA n replays of a captured
    step, on the CPU n eager steps. The buffers are the caller's: hand over
    a state and params it owns (``FluidState.clone``)."""

    def __init__(self, state: FluidState, params: SimParams,
                 cfg: SimConfig):
        self.cfg = cfg.resolved()
        if self.cfg.neighbor_mode != "pallas" or self.cfg.incremental_rebuild:
            raise ValueError("StepGraph runs the kernel pipeline's rebuild "
                             "step (neighbor_mode 'pallas', "
                             "incremental_rebuild 0)")
        self.state = state
        self.params = params
        self.graph = None
        self.per_replay: dict = {}     # kernel launches a replay
        self.capture_s = 0.0           # warm-up and capture, wall seconds

    @property
    def captures(self) -> bool:
        return self.state.device.type == "cuda"

    def _advance(self) -> None:
        from .. import step as step_mod
        copy_state(self.state, step_mod.step(self.state, self.params,
                                             self.cfg))

    def capture(self) -> None:
        """Warm up, restore the buffers, capture one step. Raises if the
        step cannot be captured."""
        dev = self.state.device
        t0 = time.perf_counter()
        before = _read_counters()
        saved = self.state.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._advance()
        torch.cuda.current_stream(dev).wait_stream(side)
        copy_state(self.state, saved)
        del saved
        _set_counters(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._advance()
        after = _read_counters()
        _set_counters(before)
        self.per_replay = {k: v - b[k] for a, b in zip(after, before)
                           for k, v in a.items() if v != b[k]}
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, num_steps: int) -> None:
        if num_steps <= 0:
            return
        if not self.captures:
            for _ in range(num_steps):
                self._advance()
            return
        if self.graph is None:
            self.capture()
        for _ in range(num_steps):
            self.graph.replay()
        for c in _counters():
            for k in c:
                c[k] += num_steps * self.per_replay.get(k, 0)
