"""The kernel pipeline's rebuild step and the domain step as captured CUDA
graphs — the counterparts of the JAX package's device-only rollouts
(``jax.jit`` over ``lax.scan``, ``water_sandbox_tpu/ops/step.py:121-140``;
``make_domain_rollout``, ``water_sandbox_tpu/parallel/domain.py:913-940``).

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
buffers. ``DomainGraph`` does the same for the domain-decomposed step
(``parallel/domain.py``) over per-shard buffers when every shard sits on
one CUDA device.

The graph reads the buffers by address, so the owner changes parameters by
copying into them (``Simulation.tune``) and the next replay sees the new
values, with no recapture. A graph also replays the code it was captured
under, so a graph belongs to its owner and is never shared: a patched
context (``golden.flipped_near_derivative``, a forced row group) captures
its own.

Kernel launches are counted as the eager step counts them: the wrappers'
counters (``LAUNCHES`` of ``sph_bucket``, ``rescue``, ``bitonic_sort``,
``domain_rescue``) move only while the step is captured, and each replay
adds what the capture counted; warm-up launches are not counted.
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
    from . import bitonic_sort, domain_rescue, rescue, sph_bucket
    return (sph_bucket.LAUNCHES, rescue.LAUNCHES, bitonic_sort.LAUNCHES,
            domain_rescue.LAUNCHES)


def _read_counters() -> list:
    return [dict(c) for c in _counters()]


def _set_counters(values: list) -> None:
    for c, v in zip(_counters(), values):
        c.update(v)


def copy_state(dst: FluidState, src: FluidState) -> None:
    """Copy every field of ``src`` into the buffers of ``dst``."""
    for f in dataclasses.fields(FluidState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class _Graph:
    """One step captured as a CUDA graph over buffers the subclass owns:
    ``_advance`` steps them in place, ``_save`` / ``_restore`` copy them
    out and back, ``device`` is where they live and ``captures`` whether
    ``run`` replays a graph or steps eagerly."""

    def __init__(self):
        self.graph = None
        self.per_replay: dict = {}     # kernel launches a replay
        self.capture_s = 0.0           # warm-up and capture, wall seconds

    def capture(self) -> None:
        """Warm up, restore the buffers, capture one step. Raises if the
        step cannot be captured."""
        dev = self.device
        t0 = time.perf_counter()
        before = _read_counters()
        saved = self._save()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._advance()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore(saved)
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


class StepGraph(_Graph):
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
        super().__init__()
        self.state = state
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def captures(self) -> bool:
        return self.state.device.type == "cuda"

    def _advance(self) -> None:
        from .. import step as step_mod
        copy_state(self.state, step_mod.step(self.state, self.params,
                                             self.cfg))

    def _save(self):
        return self.state.clone()

    def _restore(self, saved) -> None:
        copy_state(self.state, saved)


class DomainGraph(_Graph):
    """``run(n)`` advances a sharded state (``parallel/domain.py``: the
    per-shard ``states`` and ``active`` masks) by n calls of ``step``, a
    domain step, in place, reading ``params`` in place and adding each
    step's migration losses into ``lost`` (() f32 on shard 0's device).

    It captures only when every shard of ``mesh`` sits on one CUDA device
    (``DistributedSimulation``'s case on one card) and ``capture`` is
    true: then n replays of one captured step, the counterpart of JAX's
    ``lax.scan`` over its jitted ``shard_map`` step. A mesh over several
    devices, the CPU, or ``capture=False`` (the plain pair-block step,
    whose occupied-cell walk syncs) steps eagerly into the same buffers:
    by construction, not after a failed capture (a failed capture raises).
    The buffers are the caller's."""

    def __init__(self, step, states: list, active: list, params: SimParams,
                 mesh, capture: bool = True):
        super().__init__()
        self.step = step
        self.states = states
        self.active = active
        self.params = params
        self.lost = torch.zeros((), device=mesh.devices[0])
        devices = set(mesh.devices)
        self.captures = (capture and len(devices) == 1
                         and mesh.devices[0].type == "cuda")

    @property
    def device(self) -> torch.device:
        return self.lost.device

    def _advance(self) -> None:
        states, active, lost = self.step(self.states, self.active,
                                         self.params)
        for dst, src in zip(self.states, states):
            copy_state(dst, src)
        for dst, src in zip(self.active, active):
            dst.copy_(src)
        self.lost.add_(lost)

    def _save(self):
        return ([s.clone() for s in self.states],
                [a.clone() for a in self.active], self.lost.clone())

    def _restore(self, saved) -> None:
        states, active, lost = saved
        for dst, src in zip(self.states, states):
            copy_state(dst, src)
        for dst, src in zip(self.active, active):
            dst.copy_(src)
        self.lost.copy_(lost)
