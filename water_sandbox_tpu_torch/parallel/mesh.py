"""The shard mesh of the domain-decomposed step — the counterpart of
``water_sandbox_tpu/parallel/mesh.py``.

The JAX package runs its domain step under ``shard_map`` on a 1-D device
mesh along the container's x axis, and its cell-slab-sharded step
(``parallel/gspmd.py``) with the collectives XLA's partitioner inserts;
each shard is a program of its own device, and the shards' programs meet
only at the collectives. The port runs both SPMD programs in one process:
a :class:`Mesh` of ``n_shards`` shards, each with its own torch device (by
default all on one) and, on CUDA, its own stream, and the collectives the
two steps use, over lists of per-shard tensors (element ``d`` belongs to
shard ``d`` and lives on its device). A shard's work runs on its stream
(``shard``), so the shards of one card run concurrently, as independent
devices do; a collective is the only place where one shard's stream waits
on another's. It is the counterpart of the virtual-device CPU mesh on
which the JAX package's tests run both steps.
"""

from __future__ import annotations

import contextlib

import torch

from ..core import device as device_mod


class Mesh:
    """``n_shards`` shards along x; shard ``d`` computes on ``devices[d]``.

    On CUDA each shard owns a stream (``streams[d]``, on ``devices[d]``,
    distinct from every other shard's and from the caller's). A step runs
    inside ``step()``: on entry every shard's stream waits on the caller's
    current stream (what the caller wrote before is visible), on exit the
    caller's stream waits on every shard's. Inside it, shard d's work runs
    under ``shard(d)`` (or ``each``), on shard d's stream, and the
    collectives run outside any shard's scope: each records where its
    source shard's stream stands, makes the destination's stream wait
    there, and hands the tensor over (one card) or copies it (two cards)
    on the destination's stream. Under a CUDA graph capture the fork and
    the join make the shards' streams branches of the captured graph. On
    the CPU the mesh has no streams and the scopes launch nothing.

    ``serial=True`` gives no streams on CUDA either: every shard runs on
    the caller's stream, one after another. It is a reference for tests
    and ``chip_smoke.py`` (the concurrent step must repeat its bits), not
    an execution mode: nothing else sets it.

    The collectives take a list of per-shard tensors and return one. Each
    counts the bytes that leave their shard (a tensor moved from shard s
    to shard d != s, whether or not the two share a device) in ``moved``
    by kind — "permute" (the shifts), "all-reduce", "all-to-all",
    "all-gather", the names of XLA's collectives — and the largest single
    transfer of each kind in ``largest``: the counterpart of the lowering
    the JAX package pins (``benchmarks/gspmd_lowering.py``). They count
    when they run in Python, so on a captured step only the capture (or an
    eager step) counts; ``reset_traffic`` zeroes both."""

    KINDS = ("permute", "all-reduce", "all-to-all", "all-gather")

    def __init__(self, devices: list[torch.device], serial: bool = False):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.serial = serial
        self.streams = None
        if not serial and all(d.type == "cuda" for d in self.devices):
            taken = {torch.cuda.current_stream(d).cuda_stream
                     for d in set(self.devices)}
            self.streams = []
            for dev in self.devices:
                s = device_mod.pool_stream(dev, taken)
                taken.add(s.cuda_stream)
                self.streams.append(s)
        self._depth = 0          # nested step() scopes
        self._shard = None       # the shard whose scope is open
        self.reset_traffic()

    @property
    def size(self) -> int:
        return len(self.devices)

    def reset_traffic(self) -> None:
        self.moved = dict.fromkeys(self.KINDS, 0)
        self.largest = dict.fromkeys(self.KINDS, 0)

    # ------------------------------------------------------------ scopes --

    @contextlib.contextmanager
    def step(self):
        """The fork and the join around a step's shard work (nested scopes
        add nothing). Raises if the caller's stream is a shard's."""
        if self._depth == 0 and self.streams is not None:
            own = {s.cuda_stream for s in self.streams}
            for dev, s in zip(self.devices, self.streams):
                caller = torch.cuda.current_stream(dev)
                if caller.cuda_stream in own:
                    raise RuntimeError(
                        "the caller's stream is a shard's stream: a step "
                        "cannot fork from it")
                s.wait_stream(caller)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0 and self.streams is not None:
                for dev, s in zip(self.devices, self.streams):
                    torch.cuda.current_stream(dev).wait_stream(s)

    def _on(self, d: int):
        """Shard d's stream as the current one (nothing without streams)."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[d])

    @contextlib.contextmanager
    def shard(self, d: int):
        """Shard d's work: on its stream, inside a step's scope, not inside
        another shard's."""
        if self._depth == 0:
            raise RuntimeError(f"shard {d}'s scope outside a step's scope")
        if self._shard is not None:
            raise RuntimeError(f"shard {d}'s scope inside shard "
                               f"{self._shard}'s")
        self._shard = d
        try:
            with self._on(d):
                yield
        finally:
            self._shard = None

    def each(self, fn) -> list:
        """``[fn(d) for d in range(size)]``, each call under shard d's scope
        (inside a step's scope, which it opens when none is)."""
        out = []
        with self.step():
            for d in range(self.size):
                with self.shard(d):
                    out.append(fn(d))
        return out

    @contextlib.contextmanager
    def _collective(self):
        if self._shard is not None:
            raise RuntimeError(f"a collective inside shard {self._shard}'s "
                               "scope")
        with self.step():
            yield

    # ------------------------------------------------------- collectives --

    def _send(self, kind: str, x: torch.Tensor, src: int,
              dst: int) -> torch.Tensor:
        """``x`` of shard ``src`` on shard ``dst``'s device, counted; with
        streams, ordered after the work ``src``'s stream has so far."""
        if src == dst:
            return x.to(self.devices[dst])
        nbytes = x.numel() * x.element_size()
        self.moved[kind] += nbytes
        self.largest[kind] = max(self.largest[kind], nbytes)
        if self.streams is None:
            return x.to(self.devices[dst])
        s_src, s_dst = self.streams[src], self.streams[dst]
        s_dst.wait_stream(s_src)
        if x.device == self.devices[dst]:
            # handed over: dst's stream reads a block that src's stream
            # allocated, which the allocator must not reuse before it is done
            x.record_stream(s_dst)
            return x
        # a copy between devices runs on the source device's current stream
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            return x.to(self.devices[dst])

    def _shift(self, xs: list[torch.Tensor], by: int) -> list[torch.Tensor]:
        """Shard d receives shard (d - by) % size's tensor."""
        n = self.size
        with self._collective():
            return [self._send("permute", xs[(d - by) % n], (d - by) % n, d)
                    for d in range(n)]

    def shift_right(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard d receives shard d-1's tensor (``lax.ppermute`` with pairs
        (d, d+1), wrapping: shard 0 receives the last shard's; callers mask
        the wrapped edge)."""
        return self._shift(xs, 1)

    def shift_left(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard d receives shard d+1's tensor (wrapping at the last)."""
        return self._shift(xs, -1)

    def _all_reduce(self, xs: list[torch.Tensor], reduce) -> list:
        """``reduce`` of the list of the shards' tensors on shard 0 (its
        stream), replicated on every shard's device."""
        with self._collective():
            got = [self._send("all-reduce", x, d, 0) for d, x in enumerate(xs)]
            with self._on(0):
                top = reduce(got)
            return [self._send("all-reduce", top, 0, d)
                    for d in range(self.size)]

    def psum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The sum over shards in shard order, replicated on every shard's
        device."""
        return self._all_reduce(xs, sum)

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The maximum over shards, replicated on every shard's device."""
        return self._all_reduce(xs, lambda ts: torch.stack(ts).amax(dim=0))

    def pmin(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The minimum over shards, replicated on every shard's device."""
        return self._all_reduce(xs, lambda ts: torch.stack(ts).amin(dim=0))

    def _gather_to(self, kind: str, parts) -> list:
        """Shard d receives ``parts(d)``'s (source, tensor) pairs,
        concatenated in source order on its stream."""
        out = []
        with self._collective():
            for d in range(self.size):
                got = [self._send(kind, x, s, d) for s, x in parts(d)]
                with self._on(d):
                    out.append(torch.cat(got))
        return out

    def all_to_all(self, blocks: list[list[torch.Tensor]]) -> list:
        """``blocks[s][d]``, shard s's rows for shard d, go to shard d: shard
        d receives every source's block, each in its own row order, the
        sources concatenated in shard order (a gather to one shard is the
        case where only blocks for it have rows)."""
        return self._gather_to("all-to-all", lambda d: [
            (s, blocks[s][d]) for s in range(self.size)])

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard receives every shard's tensor, concatenated in shard
        order (a broadcast is the case where one shard's has rows)."""
        return self._gather_to("all-gather", lambda d: list(enumerate(xs)))


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index ("cuda" is the current CUDA device), so that
    a tensor's device compares equal to its shard's."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_shards: int, devices=device_mod.DEFAULT,
              serial: bool = False) -> Mesh:
    """A mesh of ``n_shards`` shards. ``devices``: one device for all shards
    (default ``cuda:0``; raises without a CUDA device, pass ``"cpu"`` for
    the CPU) or a list of ``n_shards`` devices. ``serial``: every shard on
    the caller's stream, the test reference of ``Mesh``."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n_shards
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return Mesh([device_mod.resolve(d) for d in devices], serial=serial)
