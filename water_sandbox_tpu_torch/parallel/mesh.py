"""The shard mesh of the domain-decomposed step — the counterpart of
``water_sandbox_tpu/parallel/mesh.py``.

The JAX package runs its domain step under ``shard_map`` on a 1-D device
mesh along the container's x axis, and its cell-slab-sharded step
(``parallel/gspmd.py``) with the collectives XLA's partitioner inserts.
The port runs both SPMD programs in one process: a :class:`Mesh` of
``n_shards`` shards, each with its own torch device (by default all on
one), and the collectives the two steps use, over lists of per-shard
tensors (element ``d`` belongs to shard ``d`` and lives on its device). It
is the counterpart of the virtual-device CPU mesh on which the JAX
package's tests run both steps.
"""

from __future__ import annotations

import torch

from ..core import device as device_mod


class Mesh:
    """``n_shards`` shards along x; shard ``d`` computes on ``devices[d]``.

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

    def __init__(self, devices: list[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = [torch.device(d) for d in devices]
        self.reset_traffic()

    @property
    def size(self) -> int:
        return len(self.devices)

    def reset_traffic(self) -> None:
        self.moved = dict.fromkeys(self.KINDS, 0)
        self.largest = dict.fromkeys(self.KINDS, 0)

    def _send(self, kind: str, x: torch.Tensor, src: int,
              dst: int) -> torch.Tensor:
        """``x`` of shard ``src`` on shard ``dst``'s device, counted."""
        if src != dst:
            nbytes = x.numel() * x.element_size()
            self.moved[kind] += nbytes
            self.largest[kind] = max(self.largest[kind], nbytes)
        return x.to(self.devices[dst])

    def _shift(self, xs: list[torch.Tensor], by: int) -> list[torch.Tensor]:
        """Shard d receives shard (d - by) % size's tensor."""
        n = self.size
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
        """``reduce`` of the list of the shards' tensors on shard 0,
        replicated on every shard's device."""
        top = reduce([self._send("all-reduce", x, d, 0)
                      for d, x in enumerate(xs)])
        return [self._send("all-reduce", top, 0, d) for d in range(self.size)]

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

    def all_to_all(self, blocks: list[list[torch.Tensor]]) -> list:
        """``blocks[s][d]``, shard s's rows for shard d, go to shard d: shard
        d receives every source's block, each in its own row order, the
        sources concatenated in shard order (a gather to one shard is the
        case where only blocks for it have rows)."""
        return [torch.cat([self._send("all-to-all", blocks[s][d], s, d)
                           for s in range(self.size)])
                for d in range(self.size)]

    def all_gather(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard receives every shard's tensor, concatenated in shard
        order (a broadcast is the case where one shard's has rows)."""
        return [torch.cat([self._send("all-gather", x, s, d)
                           for s, x in enumerate(xs)])
                for d in range(self.size)]


def make_mesh(n_shards: int, devices=device_mod.DEFAULT) -> Mesh:
    """A mesh of ``n_shards`` shards. ``devices``: one device for all shards
    (default ``cuda:0``; raises without a CUDA device, pass ``"cpu"`` for
    the CPU) or a list of ``n_shards`` devices."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n_shards
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return Mesh([device_mod.resolve(d) for d in devices])
