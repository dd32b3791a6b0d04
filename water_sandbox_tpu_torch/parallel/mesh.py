"""The shard mesh of the domain-decomposed step — the counterpart of
``water_sandbox_tpu/parallel/mesh.py``.

The JAX package runs its domain step under ``shard_map`` on a 1-D device
mesh along the container's x axis. The port runs the same SPMD program in
one process: a :class:`Mesh` of ``n_shards`` shards, each with its own
torch device (by default all on one), and the collectives the domain step
uses, over lists of per-shard tensors (element ``d`` belongs to shard
``d`` and lives on its device). It is the counterpart of the virtual-device
CPU mesh on which the JAX package's tests run its domain step.
"""

from __future__ import annotations

import torch

from ..core import device as device_mod


class Mesh:
    """``n_shards`` shards along x; shard ``d`` computes on ``devices[d]``."""

    def __init__(self, devices: list[torch.device]):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def _place(self, xs):
        return [x.to(dev) for x, dev in zip(xs, self.devices)]

    def shift_right(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard d receives shard d-1's tensor (``lax.ppermute`` with pairs
        (d, d+1), wrapping: shard 0 receives the last shard's; callers mask
        the wrapped edge)."""
        return self._place(xs[-1:] + xs[:-1])

    def shift_left(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Shard d receives shard d+1's tensor (wrapping at the last)."""
        return self._place(xs[1:] + xs[:1])

    def psum(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The sum over shards, replicated on every shard's device."""
        total = sum(x.to(self.devices[0]) for x in xs)
        return self._place([total] * self.size)

    def pmax(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The maximum over shards, replicated on every shard's device."""
        top = torch.stack([x.to(self.devices[0]) for x in xs]).amax(dim=0)
        return self._place([top] * self.size)


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
