"""The physics' least work for the density and force passes, and the
share of its bound that a pass's device time reaches.

The counts are of what the physics needs, whatever implements it, so a
kernel redesign moves the share only by moving the kernel's time:

* pairs: the directed pairs within h, self pairs included (``true_pairs``).
  Each unordered pair's shared arithmetic is counted once (a symmetric
  kernel may do it once), each side's accumulation once a side.
* bytes: each particle's inputs read once and its outputs written once, in
  float32.

Density (per unordered pair i != j): the displacement and its square (3
sub, 3 mul, 2 add), sqrt, u = h - d, u^2, u^3: 12; per side: two adds.
Per particle: its self pair's two adds, and the two scalings by the
normalisations and two paddings: 6. Inputs: the predicted position (12
bytes); outputs: the density and near-density (8 bytes).

Force (per unordered pair): displacement 3, d^2 5, sqrt 1, reciprocal 1,
d - h 1, (d - h)^2 1, h^2 - d^2 1, its cube 2, the velocity difference 3
and its product with the viscosity weight 3, the two pressure sums 2 and
their products with the slopes 4: 27; per side: the two divisions by the
other's densities as products 2, their sum 1, the division by d 1, the
direction times the scale 3, two accumulations of 3: 13. Per particle:
the division by its density 3, the viscosity scaling and sum 6: 9.
Inputs: position and velocity (24 bytes), density and near-density (8);
output: the acceleration (12 bytes).
"""

from __future__ import annotations

import json
from pathlib import Path

DENSITY_PAIR_OPS, DENSITY_SIDE_OPS, DENSITY_ROW_OPS = 12, 2, 6
DENSITY_ROW_BYTES = 12 + 8
FORCE_PAIR_OPS, FORCE_SIDE_OPS, FORCE_ROW_OPS = 27, 13, 9
FORCE_ROW_BYTES = 24 + 8 + 12


def peaks(device_name: str):
    """(f32 FLOP/s, bytes/s) of the card, or None if the table lacks it."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    entry = table.get(device_name)
    if entry is None:
        return None
    return entry["f32_flop_per_s"], entry["bytes_per_s"]


def density_work(n: int, pairs: float) -> tuple:
    """(operations, bytes) of one density pass over n particles with
    ``pairs`` directed pairs within h, self pairs included."""
    others = pairs - n
    ops = (others / 2 * DENSITY_PAIR_OPS + others * DENSITY_SIDE_OPS
           + n * DENSITY_ROW_OPS)
    return ops, n * DENSITY_ROW_BYTES


def force_work(n: int, pairs: float) -> tuple:
    others = pairs - n
    ops = (others / 2 * FORCE_PAIR_OPS + others * FORCE_SIDE_OPS
           + n * FORCE_ROW_OPS)
    return ops, n * FORCE_ROW_BYTES


def share(work: tuple, seconds: float, device_name: str):
    """Percent of the roofline bound that a pass taking ``seconds`` reaches:
    the larger of ops over the peak rate and bytes over the peak
    bandwidth, over the time. None without a time or a known card."""
    pk = peaks(device_name)
    if pk is None or not seconds:
        return None
    bound = max(work[0] / pk[0], work[1] / pk[1])
    return 100.0 * bound / seconds
