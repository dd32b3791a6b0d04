"""The bucket build after the sort: slot ranks, the sorted row gather, the
feature planes, the per-lane counts and the overflow — the second half of
``sph_bucket._build_core`` and of the domain step's per-shard build
(``sph_bucket.build_local_slab_buckets``), the port's one build rule.

``run_build`` runs ``build_plain``, the ATen chain (``grid.slots_in_runs``
slot ranks, one row gather, the slot-major "stack" scatter, the counts), for
CPU tensors, and launches ``csrc/sph_build.cu`` for CUDA tensors — there is
no fallback between the two, and both give the same bits.
"""

from __future__ import annotations

import torch

from ..grid import slots_in_runs
from . import _build
from .sph_bucket import _FAR

# The kernel's key bound for a build in which every key may take a slot.
_NO_KEY_BOUND = 2**31 - 1

# Carried column blocks the kernel reads beside the positions and
# velocities, and the widest sorted row it takes (a block of 256 rows
# staged in 48 KB of shared memory).
_MAX_CARRY = 2
_MAX_WIDTH = 48


def _scatter_planes(srows: torch.Tensor, flat: torch.Tensor, dim: int,
                    cap_p: int, L: int) -> torch.Tensor:
    """Scatter the (n, 2·dim) sorted feature rows into the planes
    (2·dim, cap_p, L): one slot-major scatter per feature, then a stack (the
    JAX package's "stack" build). Position rows fill with _FAR (the kernels'
    distance test then rejects empty slots), velocity rows with 0. The
    capacity-overflow address cap_p·L lands in one extra element that is
    dropped; it is the only address that repeats."""
    idx = flat.long()
    out = []
    for j in range(srows.shape[1]):
        buf = torch.full((cap_p * L + 1,), _FAR if j < dim else 0.0,
                         dtype=srows.dtype, device=srows.device)
        buf[idx] = srows[:, j]
        out.append(buf[:-1].view(cap_p, L))
    return torch.stack(out)


def build_plain(sorted_col, order, predicted, vel, carry, cap: int,
                cap_p: int, L: int, pad: int, end: int):
    """Plain PyTorch version of the kernel, on the sort's ``sorted_col``
    (n,) i32 and ``order`` (n,) i64: slot ranks in the runs of equal keys,
    one row gather of ``predicted``, ``vel`` and the ``carry`` blocks, the
    planes scattered slot-major, the counts from the position plane. Only
    keys below ``end`` take a slot or count as overflow. Returns (planes,
    counts, flat, order i32, srows, overflow) as ``sph_bucket._build_core``
    documents them."""
    dim = predicted.shape[1]
    slot = slots_in_runs(sorted_col)
    keyed = sorted_col < end
    ok = (slot < cap) & keyed
    flat = torch.where(ok, slot * L + pad + sorted_col, cap_p * L)

    srows = torch.cat([predicted, vel, *carry], dim=1)[order]   # ONE gather

    planes = _scatter_planes(srows[:, :2 * dim], flat, dim, cap_p, L)
    # occupied slots per lane, from the position plane (slots fill from 0)
    counts = (planes[0] < _FAR * 0.5).sum(
        dim=0, dtype=predicted.dtype)[None, :]
    overflow = (keyed & ~ok).sum().to(torch.int32)
    return planes, counts, flat, order.to(torch.int32), srows, overflow


def _check_inputs(sorted_col, order, predicted, vel, carry) -> None:
    """What the kernel reads through raw pointers: dtypes, shapes, one
    device, at most ``_MAX_CARRY`` carried blocks."""
    n = predicted.shape[0]
    for t, dtype in ((sorted_col, torch.int32), (order, torch.int64)):
        if t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(f"build keys: expected {dtype} ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (predicted, vel, *carry):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != n:
            raise ValueError(f"build rows: expected float32 ({n}, k), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if vel.shape != predicted.shape:
        raise ValueError("predicted and vel must have one shape")
    if any(t.device != predicted.device
           for t in (sorted_col, order, vel, *carry)):
        raise ValueError("build inputs must share one device")
    if len(carry) > _MAX_CARRY:
        raise ValueError(f"at most {_MAX_CARRY} carried blocks, got "
                         f"{len(carry)}")
    width = 2 * predicted.shape[1] + sum(b.shape[1] for b in carry)
    if width > _MAX_WIDTH:
        raise ValueError(f"sorted rows of at most {_MAX_WIDTH} columns, got "
                         f"{width}")


def run_build(sorted_col, order, predicted, vel, carry, cap: int, cap_p: int,
              L: int, pad: int, end: int):
    """The build after ``torch.sort(col, stable=True)`` gave ``sorted_col``
    and ``order``; ``carry`` is a sequence of (n, k) f32 blocks that ride the
    row gather; keys at or above ``end`` take no slot and are not overflow
    (``_NO_KEY_BOUND`` where every key may take one). Plain version on the
    CPU, kernel on CUDA; the same outputs as ``build_plain``."""
    if predicted.device.type == "cpu":
        return build_plain(sorted_col, order, predicted, vel, carry, cap,
                           cap_p, L, pad, end)
    if predicted.device.type != "cuda":
        raise ValueError(f"unsupported device {predicted.device}")
    _check_inputs(sorted_col, order, predicted, vel, carry)
    n, dim = predicted.shape
    dev = predicted.device
    # no-ops on the main path; held here, so that no copy is freed (and its
    # memory handed to the next) before the launch reads it
    ins = [t.contiguous() for t in (sorted_col, order, predicted, vel)]
    blocks = [b.contiguous() for b in carry]
    planes = torch.empty((2 * dim, cap_p, L), dtype=torch.float32,
                         device=dev)
    planes[:dim].fill_(_FAR)
    planes[dim:].zero_()
    # the counts (0.0 has the bits of int 0) and the overflow counter in one
    # zeroed buffer
    zeros = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    counts = zeros[:L].view(torch.float32)[None, :]
    overflow = zeros[L]
    flat = torch.empty(n, dtype=torch.int32, device=dev)
    order_out = torch.empty(n, dtype=torch.int32, device=dev)
    srows = torch.empty((n, 2 * dim + sum(b.shape[1] for b in blocks)),
                        dtype=torch.float32, device=dev)
    ptrs = [(b.data_ptr(), b.shape[1]) for b in blocks]
    ptrs += [(None, 0)] * (_MAX_CARRY - len(ptrs))
    _build.launch(
        "sph_build", *[t.data_ptr() for t in ins], *ptrs[0], *ptrs[1],
        planes.data_ptr(), counts.data_ptr(), flat.data_ptr(),
        order_out.data_ptr(), srows.data_ptr(), overflow.data_ptr(), n, dim,
        cap, cap_p, L, pad, end, dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    return planes, counts, flat, order_out, srows, overflow
