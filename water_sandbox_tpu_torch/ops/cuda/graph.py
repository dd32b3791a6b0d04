"""The single-device step in every neighbour mode (the kernel pipeline's
rebuild step, ``bucket_grid``, ``dense``, ``hash_grid``), the domain step
and the cell-slab-sharded step as captured CUDA graphs — the counterparts
of the JAX package's device-only rollouts
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
(``parallel/domain.py``) and ``ShardedGraph`` for the cell-slab-sharded
``bucket_grid`` step (``parallel/gspmd.py``), over per-shard buffers,
when every shard sits on one CUDA device; their steps fork into the
mesh's shard streams, so one graph holds a branch a shard.

The graph reads the buffers by address, so the owner changes parameters by
copying into them (``Simulation.tune``) and the next replay sees the new
values, with no recapture. A graph also replays the code it was captured
under, so a graph belongs to its owner and is never shared: a patched
context (``golden.flipped_near_derivative``, a forced row group) captures
its own.

Kernel launches are counted as the eager step counts them: the port's one
launch count (``_build.LAUNCHES``) moves only while the step is captured,
and each replay adds what the capture counted; warm-up launches are not
counted.

``IncrementalGraph`` captures the incremental step
(``ops/cuda/incremental.py``), whose branches the JAX package takes with
``lax.cond`` on the device. ``device_if`` is that ``lax.cond`` with an
empty else branch: under capture it records its body into a CUDA graph IF
conditional node (``csrc/graph_if.cu``) on a () bool device tensor, which
each replay evaluates on the device; outside a capture it reads the
tensor on the host once and runs the body when it holds. A body's
launches are counted apart from the rest of the step (``Branches``): each
body keeps a device count of the replays where it ran, read once after
``run``, and adds its captured launches that many times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ...core import device as device_mod
from ...core.params import SimConfig, SimParams
from ...core.state import FluidState
from ...runtime import profiling
from . import _build

# Eager steps on a side stream before the capture.
WARMUP_STEPS = 2

# The neighbour modes whose rebuild step StepGraph captures: all of them,
# as the JAX package runs every mode's rollout as one compiled program.
CAPTURED_MODES = ("pallas", "bucket_grid", "dense", "hash_grid")


@contextlib.contextmanager
def _counted_apart():
    """The launches made inside go to the dict it yields, by kernel, and
    not to the port's count (``_build.LAUNCHES``), which is left as it
    was."""
    before = dict(_build.LAUNCHES)
    made: dict = {}
    try:
        yield made
    finally:
        made.update({k: v - before[k] for k, v in _build.LAUNCHES.items()
                     if v != before[k]})
        _build.LAUNCHES.update(before)


def _add_launches(launches: dict, times: int) -> None:
    """``launches`` (by kernel) added ``times`` times to the counts."""
    for k, v in launches.items():
        _build.LAUNCHES[k] += times * v


def copy_state(dst: FluidState, src: FluidState) -> None:
    """Copy every field of ``src`` into the buffers of ``dst``."""
    for f in dataclasses.fields(FluidState):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class _Graph:
    """One step captured as a CUDA graph over buffers the subclass owns:
    ``_advance`` steps them in place, ``_save`` / ``_restore`` copy them
    out and back, ``device`` is where they live, ``captures`` whether
    ``run`` replays a graph or steps eagerly, and ``streams`` the streams
    the step forks into (a mesh's shard streams), which the warm-up and
    capture streams must not be.

    With ``marked`` (``StepGraph``) the step has phase markers
    (``runtime/profiling.py::phase``), which ``graph`` leaves out: the
    replays made while no profiler records are the step alone. ``capture``
    then captures the step a second time with its markers (``traced``),
    into the first graph's memory pool and on its capture stream, so that
    it reuses the first graph's intermediates, and the runs made while a
    profiler records replay that graph. Each ``run`` reads once whether
    one records."""

    streams: tuple = ()
    marked = False

    def __init__(self):
        self.graph = None
        self.traced = None             # the graph with the phase markers
        self.markers: list = []        # the phases it marks, in order
        self.per_replay: dict = {}     # kernel launches a replay
        self.capture_s = 0.0           # warm-up and captures, wall s
        self._stream = None            # the capture stream

    def capture(self) -> None:
        """Warm up, restore the buffers, capture one step. Raises if the
        step cannot be captured."""
        with profiling.span("wst.capture"):
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        t0 = time.perf_counter()
        saved = self._save()
        taken = {s.cuda_stream for s in self.streams}
        taken.add(torch.cuda.current_stream(dev).cuda_stream)
        side = device_mod.pool_stream(dev, taken)
        taken.add(side.cuda_stream)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _counted_apart():
            self._warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._restore(saved)
        del saved
        self._stream = device_mod.pool_stream(dev, taken)
        graph = torch.cuda.CUDAGraph()
        with _counted_apart() as made, torch.cuda.graph(
                graph, stream=self._stream):
            self._advance()
        self.per_replay = made
        self.graph = graph
        if self.marked:
            self._capture_traced()
        self.capture_s = time.perf_counter() - t0

    def _capture_traced(self) -> None:
        """Capture the step with its phase markers into ``traced``, after
        ``graph``; the launch counts stay as they were."""
        dev = self.device
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        graph = torch.cuda.CUDAGraph()
        with _counted_apart(), profiling.marking(index) as markers:
            with torch.cuda.graph(graph, pool=self.graph.pool(),
                                  stream=self._stream):
                self._advance()
        self.markers = list(markers)
        self.traced = graph

    def _warm_up(self) -> None:
        for _ in range(WARMUP_STEPS):
            self._advance()

    def run(self, num_steps: int) -> None:
        if num_steps <= 0:
            return
        if not self.captures:
            for _ in range(num_steps):
                self._advance()
            return
        if self.graph is None:
            self.capture()
        graph = self.graph
        if self.marked and profiling.recording():
            graph = self.traced
        for _ in range(num_steps):
            graph.replay()
        _add_launches(self.per_replay, num_steps)


class StepGraph(_Graph):
    """``run(n)`` advances ``state`` by n steps of ``ops/step.py::step`` in
    place, reading ``params`` in place: on CUDA n replays of a captured
    step, on the CPU n eager steps. The step is the rebuild step of any
    neighbour mode (the kernel pipeline's without ``incremental_rebuild``,
    which ``IncrementalGraph`` runs). The buffers are the caller's: hand
    over a state and params it owns (``FluidState.clone``). ``rescued``,
    a () i64 device counter of the graph's own, sums the rows the rescue
    took in (R1 adds each step's count, ``rescue.counting``). The kernel
    pipeline's step has phase markers (``marked``)."""

    def __init__(self, state: FluidState, params: SimParams,
                 cfg: SimConfig):
        self.cfg = cfg.resolved()
        mode = self.cfg.neighbor_mode
        if mode not in CAPTURED_MODES or (mode == "pallas"
                                          and self.cfg.incremental_rebuild):
            raise ValueError("StepGraph runs the rebuild step of "
                             f"neighbor_mode {CAPTURED_MODES} (in 'pallas' "
                             "with incremental_rebuild 0)")
        super().__init__()
        self.state = state
        self.params = params
        self.rescued = torch.zeros((), dtype=torch.int64,
                                   device=state.device)
        from .. import step as step_mod
        self.marked = step_mod.marked(self.cfg)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def captures(self) -> bool:
        return self.state.device.type == "cuda"

    def _advance(self) -> None:
        from .. import step as step_mod
        from . import rescue
        with rescue.counting(self.rescued):
            copy_state(self.state, step_mod.step(self.state, self.params,
                                                 self.cfg))

    def _save(self):
        return self.state.clone(), self.rescued.clone()

    def _restore(self, saved) -> None:
        copy_state(self.state, saved[0])
        self.rescued.copy_(saved[1])


class DomainGraph(_Graph):
    """``run(n)`` advances a sharded state (``parallel/domain.py``: the
    per-shard ``states`` and ``active`` masks) by n calls of ``step``, a
    domain step, in place, reading ``params`` in place and adding each
    step's migration losses into ``lost`` (() f32 on shard 0's device) and
    the particles that changed shards in it into ``migrated`` (() i64
    there: ``_arrivals``).

    It captures only when every shard of ``mesh`` sits on one CUDA device
    (``DistributedSimulation``'s case on one card): then n replays of one
    captured step, the counterpart of JAX's ``lax.scan`` over its jitted
    ``shard_map`` step. The step forks from the capture stream into the
    mesh's shard streams and joins them again (``Mesh.step``), so the graph
    holds one branch a shard, ordered against each other only at the
    collectives, and a replay runs the shards concurrently; a stream left
    unjoined fails the capture, which raises. A mesh over several devices,
    or the CPU, steps eagerly into the same buffers (on the same shard
    streams): by construction, not after a failed capture. The buffers are
    the caller's."""

    def __init__(self, step, states: list, active: list, params: SimParams,
                 mesh):
        super().__init__()
        self.step = step
        self.states = states
        self.active = active
        self.params = params
        self.lost = torch.zeros((), device=mesh.devices[0])
        self.migrated = torch.zeros((), dtype=torch.int64,
                                    device=mesh.devices[0])
        self.captures = _one_card(mesh)
        self.streams = tuple(mesh.streams or ())

    @property
    def device(self) -> torch.device:
        return self.lost.device

    def _advance(self) -> None:
        states, active, lost = self.step(self.states, self.active,
                                         self.params)
        for old, was, new, now in zip(self.states, self.active, states,
                                      active):
            self.migrated.add_(_arrivals(old.ids, was, new.ids, now).to(
                self.device))
        for dst, src in zip(self.states, states):
            copy_state(dst, src)
        for dst, src in zip(self.active, active):
            dst.copy_(src)
        self.lost.add_(lost)

    def _save(self):
        return ([s.clone() for s in self.states],
                [a.clone() for a in self.active], self.lost.clone(),
                self.migrated.clone())

    def _restore(self, saved) -> None:
        states, active, lost, migrated = saved
        for dst, src in zip(self.states, states):
            copy_state(dst, src)
        for dst, src in zip(self.active, active):
            dst.copy_(src)
        self.lost.copy_(lost)
        self.migrated.copy_(migrated)


def _arrivals(ids_before, active_before, ids_after, active_after):
    """The particles a shard's step brought in, () i64: its slots active
    after the step that were inactive before or held another particle (the
    migration fills the slots freed in the same step first, so a slot
    active on both sides may have changed hands)."""
    stayed = active_before * (ids_after == ids_before)
    return (active_after > stayed).sum()


def _one_card(mesh) -> bool:
    """Whether every shard of ``mesh`` sits on one CUDA device."""
    return len(set(mesh.devices)) == 1 and mesh.devices[0].type == "cuda"


class ShardedGraph(_Graph):
    """``run(n)`` advances a state sharded on the particle axis
    (``parallel/gspmd.py``: per-shard ``states``) by n calls of ``step``,
    the cell-slab-sharded ``bucket_grid`` step, in place, reading
    ``params`` in place. It captures when every shard of ``mesh`` sits on
    one CUDA device: then n replays of one captured step, the counterpart
    of JAX's ``lax.scan`` over its jitted sharded step, with one branch a
    shard forked from the capture stream and joined again, as in
    ``DomainGraph``. A mesh over several devices, or the CPU, steps
    eagerly into the same buffers. The buffers are the caller's."""

    def __init__(self, step, states: list, params: SimParams, mesh):
        super().__init__()
        self.step = step
        self.states = states
        self.params = params
        self.captures = _one_card(mesh)
        self.streams = tuple(mesh.streams or ())
        self._device = mesh.devices[0]

    @property
    def device(self) -> torch.device:
        return self._device

    def _advance(self) -> None:
        for dst, src in zip(self.states, self.step(self.states,
                                                   self.params)):
            copy_state(dst, src)

    def _save(self):
        return [s.clone() for s in self.states]

    def _restore(self, saved) -> None:
        for dst, src in zip(self.states, saved):
            copy_state(dst, src)


# ------------------------------------------------- device-side branches --

def _eager_read(pred: torch.Tensor) -> bool:
    """The host read of a device-side branch outside a capture: whether
    ``pred`` holds. Allowed under ``torch.cuda.set_sync_debug_mode``."""
    if pred.device.type != "cuda":
        return bool(pred)
    mode = torch.cuda.get_sync_debug_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return bool(pred)
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


class Branches:
    """The device-side branches of one captured step, by name: ``fired``,
    a () i64 device count of the runs of each body; ``launches``, the
    kernel launches one run of it makes (counted at capture, apart from the
    step's); ``pool``, the memory pool of the bodies' tensors in the graph,
    and ``stream``, the stream they are captured on (on CUDA). With
    ``force`` set, eager steps run every body without reading its
    predicate (the warm-up: each body's kernels load, and its allocations
    are made once, before the capture)."""

    def __init__(self, device: torch.device, names):
        self.fired = {k: torch.zeros((), dtype=torch.int64, device=device)
                      for k in names}
        self.launches: dict = {k: {} for k in names}
        self.force = False
        cuda = device.type == "cuda"
        self.pool = torch.cuda.MemPool() if cuda else None
        self.stream = torch.cuda.Stream(device) if cuda else None


def device_if(pred, body, branches: Branches | None = None,
              name: str = "") -> None:
    """``body()`` where ``pred`` holds: the counterpart of ``lax.cond``
    with an empty else branch.

    ``pred`` a Python bool: a Python ``if``. A () bool tensor outside a
    capture: one host read of it (``_eager_read``), or none when
    ``branches.force``. While a CUDA graph is captured: ``body`` is
    captured into an IF conditional node on ``pred`` (``csrc/graph_if.cu``)
    on ``branches.stream``, its tensors in ``branches.pool``, and each
    replay runs it or skips it on the device, with no host read; its
    launches go to ``branches.launches[name]``, not to the step's count.

    What the body writes and the rest of the step reads must be allocated
    before the call and preset to the else branch's value: a tensor
    allocated inside the body holds a value only on the replays where the
    body ran. Each run of the body adds one to ``branches.fired[name]``."""
    capturing = (isinstance(pred, torch.Tensor) and pred.device.type == "cuda"
                 and torch.cuda.is_current_stream_capturing())
    if not capturing:
        if isinstance(pred, bool):
            run = pred
        else:
            run = (branches is not None and branches.force) or _eager_read(
                pred)
        if run:
            body()
            if branches is not None:
                branches.fired[name].add_(1)
        return
    if branches is None:
        raise ValueError("device_if under capture needs a Branches")
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"{name}: the predicate must be a () bool tensor")
    dev = pred.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    parent = torch.cuda.current_stream(dev)
    child = branches.stream
    while child.cuda_stream == parent.cuda_stream:
        # torch hands its streams out round robin from a pool, so the
        # body's may be the capturing one: take the next
        child = branches.stream = torch.cuda.Stream(dev)
    with _counted_apart() as made:
        _build.check(_build.entry("wst_if_begin")(
            pred.data_ptr(), child.cuda_stream, index, parent.cuda_stream),
            f"{name}: IF node not added")
        try:
            with torch.cuda.stream(child), torch.cuda.use_mem_pool(
                    branches.pool, dev):
                body()
                branches.fired[name].add_(1)
        finally:
            err = _build.entry("wst_if_end")(index, child.cuda_stream)
    _build.check(err, f"{name}: IF body not captured")
    counted = branches.launches[name]
    for k, v in made.items():
        counted[k] = counted.get(k, 0) + v


class IncrementalGraph(_Graph):
    """``run(n)`` is ``rollout_inc``: the bucket cache built from ``state``
    on entry, then n incremental steps (``ops/cuda/incremental.py::
    step_inc``) in place, the last one gathering the per-particle results
    (``materialize``), reading ``params`` in place — the counterpart of
    JAX's ``lax.scan`` over ``step_inc`` (``ops/pallas/incremental.py
    :470``). On CUDA each step is one replay of a captured step whose
    rebuild, drop-step and materialize branches are IF conditional nodes
    (``device_if``); the materialize node reads ``materialize``, a device
    flag the host fills (no sync) before the last replay. One graph over
    one set of buffers, where a second graph for the last step would hold
    a second copy of the step's memory and take a second capture. On the
    CPU the same buffers step eagerly, each branch read on the host.

    The buffers are the caller's state and params and the graph's own
    cache (``cache``: planes, addr, origin, ticks) and flag. ``branches``
    counts the replays where each branch ran; ``run`` reads the counts once
    at its end and adds each body's launches that many times. ``rescued``
    sums the rows the drop step's rescue took in, as ``StepGraph``'s does.
    Its step carries no phase markers."""

    BRANCHES = ("rebuild", "drop", "drop_force", "materialize")

    def __init__(self, state: FluidState, params: SimParams,
                 cfg: SimConfig):
        self.cfg = cfg.resolved()
        if (self.cfg.neighbor_mode != "pallas"
                or self.cfg.incremental_rebuild <= 0):
            raise ValueError("IncrementalGraph runs the incremental step "
                             "(neighbor_mode 'pallas', incremental_rebuild "
                             "> 0)")
        super().__init__()
        self.state = state
        self.params = params
        self.cache = None
        self.materialize = torch.zeros((), dtype=torch.bool,
                                       device=state.device)
        self.branches = Branches(state.device, self.BRANCHES)
        self._seen = {k: 0 for k in self.BRANCHES}
        self.rescued = torch.zeros((), dtype=torch.int64,
                                   device=state.device)

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def captures(self) -> bool:
        return self.state.device.type == "cuda"

    def _copy_cache(self, cache) -> None:
        for dst, src in zip(self.cache, cache):
            dst.copy_(src)

    def build(self) -> None:
        """The cache rebuilt from the state, into the cache buffers."""
        from . import incremental
        cache = incremental.build_cache(self.state.predicted, self.state.vel,
                                        self.params, self.cfg)
        if self.cache is None:
            self.cache = cache
        else:
            self._copy_cache(cache)

    def _advance(self) -> None:
        from . import incremental, rescue
        with rescue.counting(self.rescued):
            state, cache = incremental.step_inc(
                self.state, self.cache, self.params, self.cfg,
                materialize=self.materialize, branches=self.branches)
        copy_state(self.state, state)
        self._copy_cache(cache)

    def _warm_up(self) -> None:
        self.branches.force = True
        try:
            super()._warm_up()
        finally:
            self.branches.force = False

    def capture(self) -> None:
        self.branches.launches = {k: {} for k in self.BRANCHES}
        super().capture()

    def _save(self):
        return (self.state.clone(), [t.clone() for t in self.cache],
                {k: v.clone() for k, v in self.branches.fired.items()},
                self.rescued.clone())

    def _restore(self, saved) -> None:
        state, cache, fired, rescued = saved
        copy_state(self.state, state)
        self._copy_cache(cache)
        for k, v in fired.items():
            self.branches.fired[k].copy_(v)
        self.rescued.copy_(rescued)

    def fired(self) -> dict:
        """The runs of each branch so far (one host read)."""
        names = list(self.branches.fired)
        values = torch.stack([self.branches.fired[k] for k in names])
        return dict(zip(names, values.tolist()))

    def run(self, num_steps: int) -> None:
        if num_steps <= 0:
            return
        self.build()
        self.materialize.fill_(False)
        super().run(num_steps - 1)
        self.materialize.fill_(True)
        super().run(1)
        if self.captures:
            fired = self.fired()
            for name, launches in self.branches.launches.items():
                _add_launches(launches, fired[name] - self._seen[name])
            self._seen = fired
