"""The closed loop's surface of the port's ``DistributedSimulation``
(``water_sandbox_tpu_torch/runtime/distributed.py``), which a configuration
with a ``runtime`` key builds (``inputs.simulation``).

The domain-decomposed step keeps its particles in per-shard slots:
``states`` (one ``FluidState`` of P rows a shard) and ``active`` masks (P,)
f32; migration moves particles between shards and counts in ``graph.lost``
those that found no free slot. The program has no ``reset``, so it takes
the closed loop without ``reset_every`` and nothing else.

- ``Sharded`` stands in for ``Simulation`` and for its state in
  ``drive.closed``: ``run``, ``device``, ``params``, and ``overflow_total``,
  ``pos`` and ``vel`` as ``drive._bad`` reads them.
- ``Snapshots`` holds per-shard copies of ``states`` and ``active``, made in
  set-up and filled by device copies in the window. After the window,
  ``finish`` turns each sample's copies into one dense state in id order
  (the active rows with their ``ids``, as ``to_dense_state`` gathers them),
  which ``check`` judges as it judges a ``Simulation``'s samples.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import inputs


def refuse(tr: dict) -> None:
    """Refuse traffic that the program cannot take."""
    if tr["loop"] != "closed" or "reset_every" in tr:
        raise ValueError("a distributed runtime takes the closed loop "
                         "without reset_every: DistributedSimulation has no "
                         "reset")


class Sharded:
    """A ``DistributedSimulation`` as ``drive.closed`` drives it."""

    def __init__(self, sim):
        self.sim = sim
        self.graph = sim.graph
        self.params = sim.params
        self.cfg = sim.cfg
        self.name = sim.name

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def state(self) -> "Sharded":
        return self

    @property
    def states(self) -> list:
        return self.sim.states

    @property
    def active(self) -> list:
        return self.sim.active

    @property
    def n_shards(self) -> int:
        return len(self.sim.states)

    def run(self, num_steps: int, block: bool = True) -> None:
        self.sim.run(num_steps, block=block)

    @property
    def overflow_total(self) -> torch.Tensor:
        """() f32 on the device: every shard's ``overflow_total`` and the
        migration's ``lost``, summed. Each only grows, so the sum grows
        exactly when one of them does."""
        return torch.stack([s.overflow_total for s in self.states]
                           + [self.graph.lost]).sum()

    def _rows(self, name: str) -> torch.Tensor:
        """A per-particle field over every shard, inactive rows zeroed."""
        return torch.cat([torch.where(a[:, None] > 0, getattr(s, name), 0.0)
                          for s, a in zip(self.states, self.active)])

    @property
    def pos(self) -> torch.Tensor:
        return self._rows("pos")

    @property
    def vel(self) -> torch.Tensor:
        return self._rows("vel")

    def shard_counts(self) -> list:
        return [int(a.sum()) for a in self.active]


@dataclasses.dataclass
class Snap:
    """Per-shard copies of a ``Sharded``'s ``states`` and ``active``."""
    states: list
    active: list


def dense(snap: Snap, n: int):
    """The active rows of ``snap`` as one ``FluidState`` on the host, in id
    order. Fewer than ``n`` active rows are padded to ``n`` with id -1 and
    NaN, so that the ids are no permutation and the check reads infinite."""
    from water_sandbox_tpu_torch.core.state import FluidState
    act = torch.cat([a.cpu() for a in snap.active]) > 0
    ids = torch.cat([s.ids.cpu() for s in snap.states])[act]
    short = max(0, n - ids.shape[0])
    ids = torch.cat([ids, torch.full((short,), -1, dtype=ids.dtype)])
    order = torch.argsort(ids.long(), stable=True)
    fields = {}
    for f in dataclasses.fields(FluidState):
        x = getattr(snap.states[0], f.name)
        if x.dim() == 0:                           # replicated scalars
            fields[f.name] = x.cpu().clone()
            continue
        if f.name == "ids":
            fields[f.name] = ids[order]
            continue
        rows = torch.cat([getattr(s, f.name).cpu() for s in snap.states])
        rows = rows[act]
        pad = torch.full((short,) + tuple(rows.shape[1:]), math.nan,
                         dtype=rows.dtype)
        fields[f.name] = torch.cat([rows, pad])[order]
    return FluidState(**fields)


class Snapshots:
    """Buffers made in set-up, so that a sample taken in the window copies
    into memory it already has and allocates nothing."""

    def __init__(self, sim: Sharded, count: int, n: int):
        self.n = n
        self.free = [Snap([s.clone() for s in sim.states],
                          [a.clone() for a in sim.active])
                     for _ in range(count)]

    def take(self, sim: Sharded) -> Snap:
        buf = self.free.pop()
        for dst, src in zip(buf.states, sim.states):
            for f in dataclasses.fields(dst):
                getattr(dst, f.name).copy_(getattr(src, f.name))
        for dst, src in zip(buf.active, sim.active):
            dst.copy_(src)
        return buf

    def finish(self, run) -> None:
        """After the window: each sample's states made dense, in id order,
        on the host. The traced span's states are dropped: they serve only
        the rooflines' pair count, an O(n^2) sweep that no metric of a
        distributed cell reads."""
        for sm in run.samples:
            sm.pre = dense(sm.pre, self.n)
            sm.post = dense(sm.post, self.n)
        run.traced_pred = []


def start_gap(sim: Sharded, pos: torch.Tensor) -> float:
    """The largest difference between the program's start state, made
    dense in id order, and the inputs ``pos``; infinite where the ids are
    no permutation."""
    s = dense(Snap(sim.states, sim.active), pos.shape[0])
    ids = torch.arange(pos.shape[0])
    if not torch.equal(s.ids.long(), ids):
        return math.inf
    pos = pos.cpu()
    return max(float((s.pos - pos).abs().max()),
               float((s.predicted - pos).abs().max()),
               float(s.vel.abs().max()), float(s.step_count),
               float(s.time.abs()))


def setup(cell, seed: int, device) -> tuple:
    """``drive.setup`` for a configuration with a ``runtime``: the program
    built from the inputs for ``seed``, its start gap, the snapshots'
    buffers, and the settling steps (the first ``run`` builds the kernels
    and captures the step)."""
    from . import drive
    conf, tr = cell.config, cell.traffic
    refuse(tr)
    pos = inputs.start_positions(conf, seed, device)
    sim = Sharded(inputs.simulation(conf, pos.clone(), conf["name"]))
    gap = start_gap(sim, pos)
    del pos
    snaps = Snapshots(sim, 2 * tr["samples"] + 2, conf["n"])
    sim.run(tr["settle_steps"])
    drive._bad(sim, sim.overflow_total.clone())
    snaps.free.append(snaps.take(sim))
    drive._sync(sim)
    return sim, gap, snaps
