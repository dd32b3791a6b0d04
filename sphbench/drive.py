"""The one traffic generator: set-up and the measured window of a cell,
driven by its traffic file's parameters.

``loop: "closed"`` (a user's offline run): set-up steps the start state
``settle_steps`` steps (the first ``Simulation.run`` builds the kernels
and captures the step); the window enqueues ``Simulation.run`` replays in
chunks of ``chunk``, keeping one chunk in flight, until ``--seconds`` have
passed and every sample is taken, and stops the clock at a final
synchronisation. With ``reset_every`` (steps, a whole number of chunks) the
user drops the scene again and again: set-up ends with
``Simulation.reset``, so the window starts at a drop; the window enqueues
a reset between replays every ``reset_every`` steps and ends with a whole
drop. The rows the program's rescue took in over the window (its graph's
``rescued`` counter, added up on the device before each reset zeroes it)
are read once, after the final synchronisation.

``loop: "open"`` (an interactive user): one frame is due every
1 / ``rate_hz`` seconds; a frame applies the reset or the HUD key due at
it, runs one step (``Simulation.run(1)``, which synchronises) and reads
``reads`` back (``positions``, ``velocities``, ``stats``). A frame is
timed from its due time, so a late frame counts its wait. A reset is due
every ``reset_every`` frames; a key every ``key_every`` frames at phase
``key_phase``. Each of ``key_pairs`` is a HUD key and the key that undoes
it: a user tries a value and sets it back. The keys are taken in turn
from blocks that press every key of the pairs once, in an order drawn
from the seed with each pair's first key before its second, so every
seed presses the same keys in another order and a parameter moves by one
step at most.

Correctness samples are drawn from the seed (``samples`` of them): in the
closed loop at times drawn over the window, at the first chunk boundary
after each time, or with ``reset_every`` in the first drop that starts
after it, at a step of the drop drawn as the open loop draws its frames;
in the open loop among the frames. Drawn steps of a drop, like the open
loop's frames, hold at least one first step after a reset and two from the
``landing`` range of steps after a reset; the open loop's, one frame with
a key. A sample keeps the program's state before and after its step, and
the frame's reads. With ``--trace 1`` a span of the window
(``trace_from_chunk`` / ``trace_chunks``, ``trace_from_frame`` /
``trace_frames``) runs under the profiler; samples are not taken there.
With ``reset_every`` the traced span is whole drops from a reset.

A configuration with a ``runtime`` runs the port's ``DistributedSimulation``
in the closed loop without ``reset_every``: ``sharded.py`` builds it, stands
in for the ``Simulation`` and its state, and keeps the samples.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from . import inputs, sharded
from .trace import traced


@dataclasses.dataclass
class Sample:
    index: int            # the frame, or the chunk of the closed loop
    steps_done: int       # steps since the start or the last reset
    keys: list            # HUD keys pressed before the step
    pre: object           # the program's state before the step (a clone)
    post: object          # and after it
    reads: dict           # the frame's reads
    params: dict          # the program's parameter values at the step


@dataclasses.dataclass
class Run:
    loop: str
    n: int
    device_name: str
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    steps: int = 0
    wall_s: float = 0.0
    frame_ms: list = dataclasses.field(default_factory=list)
    late_ms: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    samples: list = dataclasses.field(default_factory=list)
    start_gap: float = 0.0
    prof: object = None
    traced_steps: int = 0
    traced_pred: list = dataclasses.field(default_factory=list)
    trace: object = None
    pairs: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    power: str = "not measured"
    rescued_rows: int | None = None     # the closed loop's, over the window
    resets: int = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    keys: dict
    resets: frozenset
    samples: tuple


def _take(rng, picks: list, pool, k: int) -> None:
    """Add ``k`` picks drawn from ``pool`` that ``picks`` does not hold."""
    pool = [f for f in pool if f not in picks]
    if pool:
        picks.extend(int(f) for f in rng.choice(pool, min(k, len(pool)),
                                                replace=False))


def plan(tr: dict, seed: int, frames: int) -> Plan:
    """The open loop's keys, resets and sampled frames for ``seed``."""
    rng = np.random.default_rng([int(seed), 11])
    slots = [f for f in range(frames)
             if f % tr["key_every"] == tr["key_phase"]]
    pairs = tr["key_pairs"]
    seq: list = []
    while len(seq) < len(slots):
        block = "".join(rng.permutation(list("".join(pairs))))
        if all(block.index(a) < block.index(b) for a, b in pairs):
            seq += list(block)
    keys = dict(zip(slots, seq))
    every = tr["reset_every"]
    resets = frozenset(f for f in range(1, frames) if f % every == 0)
    lo, hi = tr["landing"]
    picks: list = []
    _take(rng, picks, [f for f in range(frames) if f % every == 0], 1)
    _take(rng, picks, [f for f in range(frames) if lo <= f % every < hi], 2)
    _take(rng, picks, slots, 1)
    _take(rng, picks, range(frames), tr["samples"] - len(picks))
    return Plan(keys, resets, tuple(sorted(picks)))


def drop_steps(tr: dict, seed: int) -> list:
    """The closed loop's sampled steps of a drop (steps since a reset) for
    ``seed``, one a sample, in the order the samples come due: the first
    step, two from ``landing`` and the rest over the drop."""
    rng = np.random.default_rng([int(seed), 13])
    every = tr["reset_every"]
    lo, hi = tr["landing"]
    picks: list = []
    _take(rng, picks, [0], 1)
    _take(rng, picks, range(lo, hi), 2)
    _take(rng, picks, range(every), tr["samples"] - len(picks))
    return [int(f) for f in rng.permutation(picks)]


def check_traffic(tr: dict) -> None:
    """Refuse a closed loop's ``reset_every`` that is not a whole number
    of chunks or holds fewer steps than ``samples``, a ``landing`` outside
    a drop, or a traced span that is not whole drops from a reset."""
    if tr["loop"] != "closed" or "reset_every" not in tr:
        return
    every, chunk = tr["reset_every"], tr["chunk"]
    if every <= 0 or every % chunk:
        raise ValueError(f"reset_every {every} is not a whole number of "
                         f"chunks of {chunk} steps")
    if tr["samples"] > every:
        raise ValueError(f"{tr['samples']} samples do not fit distinct "
                         f"steps of a drop of {every}")
    lo, hi = tr["landing"]
    if not 0 <= lo < hi <= every:
        raise ValueError(f"landing {[lo, hi]} lies outside a drop of "
                         f"{every} steps")
    if ((tr["trace_from_chunk"] * chunk) % every
            or (tr["trace_chunks"] * chunk) % every
            or tr["trace_chunks"] <= 0):
        raise ValueError(f"the traced span (chunks {tr['trace_from_chunk']}"
                         f" + {tr['trace_chunks']} of {chunk} steps) is not "
                         f"whole drops of {every} steps from a reset")


class Snapshots:
    """State buffers made in set-up, so that a sample taken in the window
    copies into memory it already has and allocates nothing."""

    def __init__(self, state, count: int):
        self.free = [state.clone() for _ in range(count)]

    def take(self, state):
        buf = self.free.pop()
        for f in dataclasses.fields(buf):
            getattr(buf, f.name).copy_(getattr(state, f.name))
        return buf

    def finish(self, run) -> None:
        """After the window: the samples are the states as taken."""


def _params(sim) -> dict:
    p = sim.params
    out = {k: float(getattr(p, k)) for k in inputs.PARAM_NAMES}
    out["gravity"] = [float(x) for x in p.gravity]
    return out


def _wait(due: float) -> None:
    left = due - time.perf_counter()
    if left > 0.002:
        time.sleep(left - 0.002)
    while time.perf_counter() < due:
        pass


def _label(name: str, on: bool):
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def setup(cell, seed: int, device) -> tuple:
    """(sim, start gap, snapshots): the program built from the inputs for
    ``seed`` and warmed up as the cell's traffic needs; the start gap is
    the largest difference between the program's start state and the
    inputs (0 when the constructors keep them exactly); buffers for the
    window's samples and the traced span's two states."""
    conf, tr = cell.config, cell.traffic
    if "runtime" in conf:
        return sharded.setup(cell, seed, device)
    check_traffic(tr)
    pos = inputs.start_positions(conf, seed, device)
    sim = inputs.simulation(conf, pos.clone(), conf["name"])
    s = sim.state
    ids = torch.arange(conf["n"], device=device)
    gap = max(float((s.pos - pos).abs().max()),
              float((s.predicted - pos).abs().max()),
              float(s.vel.abs().max()), float(s.step_count),
              float(s.time.abs()), float((s.ids.long() - ids).abs().max()))
    del pos, ids
    snaps = Snapshots(s, 2 * tr["samples"] + 2)
    if tr["loop"] == "closed":
        sim.run(tr["settle_steps"])
        _bad(s, s.overflow_total.clone())
        if "reset_every" in tr:
            sim.reset()
    else:
        sim.run(1)
        for name in tr["reads"]:
            getattr(sim, name)()
        sim.tune(pressure_scalar=float(sim.params.pressure_scalar))
        float(s.overflow_total)
        sim.reset()
    snaps.free.append(snaps.take(s))
    _sync(sim)
    return sim, gap, snaps


def _sync(sim) -> None:
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


def _bad(s, last) -> torch.Tensor:
    """() bool on the device: a particle went non-finite, or the step left
    particles uncomputed since ``last`` (overflow_total grew)."""
    return ((s.overflow_total > last) | ~torch.isfinite(s.pos).all()
            | ~torch.isfinite(s.vel).all())


def closed(sim, tr: dict, seconds: float, seed: int, trace: bool,
           run: Run, snaps: Snapshots) -> None:
    cuda = sim.device.type == "cuda"
    chunk = tr["chunk"]
    every = tr.get("reset_every")
    rng = np.random.default_rng([int(seed), 7])
    due = sorted(rng.uniform(0.0, seconds, tr["samples"]).tolist())
    where = drop_steps(tr, seed) if every else None
    t_from = tr["trace_from_chunk"] if trace else -1
    t_end = t_from + tr["trace_chunks"] if trace else -1
    s = sim.state
    last = s.overflow_total.clone()
    failed = torch.zeros((), dtype=torch.int64, device=sim.device)
    # the domain step keeps no count of rescued rows
    rescued = getattr(sim.graph, "rescued", None)
    # the rows rescued in the window: the counter's start taken off, and
    # each drop's count added before its reset zeroes the counter
    held = None if rescued is None else rescued.neg()
    covered, steps, c = 0, 0, 0
    todo: list = []          # sampled steps of this chunk or drop, ascending

    def check():
        failed.add_(_bad(s, last).long() * covered)
        last.copy_(s.overflow_total)
    events: list = []
    stack = contextlib.ExitStack()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if (now >= seconds and not due and not todo
                and not (trace and c < t_end)
                and not (every and steps % every)):
            break
        tracing = t_from <= c < t_end
        if every and steps % every == 0:
            if steps:
                if covered:
                    check()
                    covered = 0
                held.add_(rescued)
                sim.reset()
                last.copy_(s.overflow_total)
                run.resets += 1
            while not tracing and due and now >= due[0]:
                due.pop(0)
                todo.append(where.pop(0))
            todo.sort()
        elif not every and not tracing and due and now >= due[0]:
            due.pop(0)
            todo.append(tr["settle_steps"] + steps)
        if c == t_from:
            check()
            covered = 0
            run.traced_pred.append(snaps.take(s))
            run.prof = stack.enter_context(traced())
        # steps since the last reset, or since the start without resets
        at = steps % every if every else tr["settle_steps"] + steps
        done = 0
        while todo and todo[0] < at + chunk:
            k = todo.pop(0) - at
            if k > done:
                sim.run(k - done, block=False)
            pre = snaps.take(s)
            sim.run(1, block=False)
            run.samples.append(Sample(c, at + k, [], pre, snaps.take(s), {},
                                      {}))
            done = k + 1
        if done == 0:
            with _label("sphbench.chunk", tracing):
                sim.run(chunk, block=False)
        elif done < chunk:
            sim.run(chunk - done, block=False)
        steps += chunk
        covered += chunk
        c += 1
        if c == t_end:
            _sync(sim)
            stack.close()
            run.traced_pred.append(snaps.take(s))
            run.traced_steps = tr["trace_chunks"] * chunk
        elif not tracing:
            check()
            covered = 0
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
            if len(events) > 1:
                events.pop(0).synchronize()
    _sync(sim)
    run.wall_s = time.perf_counter() - t0
    check()
    run.steps = run.attempted = steps
    run.failed = int(failed)
    if rescued is not None:
        run.rescued_rows = int(held + rescued)
    for sm in run.samples:
        sm.params = _params(sim)
    snaps.finish(run)


def open_loop(sim, tr: dict, seconds: float, seed: int, trace: bool,
              run: Run, snaps: Snapshots) -> None:
    from water_sandbox_tpu_torch.runtime.keymap import apply_key
    rate = tr["rate_hz"]
    frames = max(1, int(round(seconds * rate)))
    p = plan(tr, seed, frames)
    t_from = tr["trace_from_frame"] if trace else -1
    t_end = t_from + tr["trace_frames"] if trace else -1
    s = sim.state
    last = float(s.overflow_total)
    since_reset, keys = 0, []
    spans = {"step_ms": [], "readback_ms": []}
    stack = contextlib.ExitStack()
    sample = set(p.samples)
    t0 = time.perf_counter() + 0.05
    for f in range(frames):
        if f == t_from:
            # the frame clock stops while the profiler starts and stops
            paused = time.perf_counter()
            run.traced_pred.append(snaps.take(s))
            run.prof = stack.enter_context(traced())
            t0 += time.perf_counter() - paused
        tracing = t_from <= f < t_end
        pre = snaps.take(s) if f in sample else None
        due = t0 + f / rate
        with _label("sphbench.wait", tracing):
            _wait(due)
        start = time.perf_counter()
        if f in p.resets:
            with _label("sphbench.reset", tracing):
                sim.reset()
            since_reset = 0
        if f in p.keys:
            with _label("sphbench.key", tracing):
                apply_key(sim, p.keys[f])
            keys.append(p.keys[f])
        t_step = time.perf_counter()
        with _label("sphbench.step", tracing):
            sim.run(1)
        t_read = time.perf_counter()
        with _label("sphbench.readback", tracing):
            out = {name: getattr(sim, name)() for name in tr["reads"]}
        end = time.perf_counter()
        run.frame_ms.append(1e3 * (end - due))
        run.late_ms.append(1e3 * (start - due))
        if not tracing:
            spans["step_ms"].append(1e3 * (t_read - t_step))
            spans["readback_ms"].append(1e3 * (end - t_read))
        if f == t_end - 1:
            paused = time.perf_counter()
            _sync(sim)
            stack.close()
            run.traced_pred.append(snaps.take(s))
            run.traced_steps = tr["trace_frames"]
            t0 += time.perf_counter() - paused
        total = float(s.overflow_total)
        if total > last or not bool(torch.isfinite(s.pos).all()
                                    & torch.isfinite(s.vel).all()):
            run.failed += 1
        last = total
        if f in sample:
            run.samples.append(Sample(f, since_reset, list(keys), pre,
                                      snaps.take(s), out, _params(sim)))
        since_reset += 1
    run.wall_s = time.perf_counter() - t0
    run.steps = frames
    run.attempted = frames
    run.spans = spans
