"""Cell coordinates and spatial-hash keys — the counterpart of
``water_sandbox_tpu/ops/hashing.py``.

Two key schemes:

* ``reference_hash`` — the reference's hashed cell table: cell = floor(p/h)
  as int32, read as uint32, key = (x·15823 + y·9737333 + z·440817757) mod T
  in wrapping 32-bit arithmetic. Collisions alias distinct cells into one
  bucket; ``hash_grid`` mode counts a pair once per neighbour offset whose
  hash collides (``reference_pair_weights``).
* the bounded grid — collision-free linear cell ids over a dynamically
  anchored grid, x the slowest axis (``bounded_cell_ids``, ``linearize``).
"""

from __future__ import annotations

import itertools
import math

import torch

# Reference hash primes.
P1 = 15823
P2 = 9737333
P3 = 440817757

_U32 = 0xFFFFFFFF


def get_cell(pos: torch.Tensor, h) -> torch.Tensor:
    """floor(p / h) as int32."""
    return torch.floor(pos / h).to(torch.int32)


def reference_hash(cell: torch.Tensor, table_size: int) -> torch.Tensor:
    """Wrapping-u32 prime hash mod ``table_size`` of int32 cell coordinates
    (..., dim), dim 2 or 3; int32 out. torch has no uint32 arithmetic, so
    the sums run in int64 and are cut to 32 bits after every multiply and
    add; a negative coordinate enters as its two's complement."""
    c = cell.to(torch.int64) & _U32
    acc = torch.zeros(cell.shape[:-1], dtype=torch.int64, device=cell.device)
    for a, prime in enumerate((P1, P2, P3)[:cell.shape[-1]]):
        acc = (acc + ((c[..., a] * prime) & _U32)) & _U32
    return (acc % table_size).to(torch.int32)


def neighbor_offsets(dim: int, device=None) -> torch.Tensor:
    """The 3^dim neighbour-cell offsets (3^dim, dim) int32: x outermost, z
    innermost, each in (-1, 0, 1) — the reference's OFFSET_TABLE order."""
    return torch.tensor(list(itertools.product((-1, 0, 1), repeat=dim)),
                        dtype=torch.int32, device=device)


def reference_pair_weights(predicted: torch.Tensor, h,
                           table_size: int) -> torch.Tensor:
    """(n, n) multiplicity matrix for the dense oracle in reference-hash
    mode: weight[i, j] = the number of neighbour offsets o with
    hash(cell_i + o) == hash(cell_j), i.e. how often the reference's walk
    visits particle j when it processes particle i. Without collisions it
    is the 0/1 adjacency of the 3^dim neighbourhood."""
    cell = get_cell(predicted, h)
    key = reference_hash(cell, table_size)
    offs = neighbor_offsets(predicted.shape[-1], predicted.device)
    nbr_keys = reference_hash(cell[:, None, :] + offs[None, :, :], table_size)
    return (nbr_keys[:, :, None] == key[None, None, :]).sum(dim=1)


def bounded_cell_ids(predicted: torch.Tensor, h, origin: torch.Tensor,
                     dims: tuple):
    """Cell coordinates clamped into the grid and their linear ids, x
    slowest. Returns (cell (n, dim) int32, cid (n,) int32)."""
    # a true division, not a multiply by 1/h: keys must match JAX's bits
    cell = torch.floor((predicted - origin) / h).to(torch.int32)
    hi = torch.tensor(dims, dtype=torch.int32, device=predicted.device) - 1
    cell = torch.minimum(torch.clamp_min(cell, 0), hi)
    cid = cell[:, 0]
    for a in range(1, len(dims)):
        cid = cid * dims[a] + cell[:, a]
    return cell, cid


def linearize(cell: torch.Tensor, dims: tuple) -> torch.Tensor:
    """Linear id of (possibly out-of-range) cell coordinates; -1 out of
    range."""
    dims_t = torch.tensor(dims, dtype=torch.int32, device=cell.device)
    in_range = ((cell >= 0) & (cell < dims_t)).all(dim=-1)
    cid = cell[..., 0]
    for a in range(1, len(dims)):
        cid = cid * dims[a] + cell[..., a]
    return torch.where(in_range, cid, -1)


def grid_origin(predicted: torch.Tensor, h) -> torch.Tensor:
    """Dynamic grid anchor: one cell below the current minimum position."""
    return predicted.amin(dim=0) - h


def key_coords(predicted: torch.Tensor, params, cfg,
               time: torch.Tensor | None) -> torch.Tensor:
    """Coordinates the cell keys are computed from: ``predicted`` itself
    for ``grid_frame == "world"``; for ``"container"`` the positions mapped
    into the box's body frame at ``time`` (an isometry, so the pair set is
    unchanged while the static grid spans only the box interior)."""
    if cfg.grid_frame == "world":
        return predicted
    if time is None:
        raise ValueError(
            "grid_frame='container' needs the sim time for the box pose; "
            "this neighbor pipeline does not thread it")
    from . import integrate as integrate_mod
    center, angle = integrate_mod.container_at(params.container, time)
    return integrate_mod._rotate_yaw(predicted - center, angle, inverse=True)


def default_grid_dims(container_size, smoothing_radius: float,
                      margin: int = 4):
    """Static grid dims covering the container plus a safety margin."""
    return tuple(int(math.ceil(s / smoothing_radius)) + margin
                 for s in container_size)
