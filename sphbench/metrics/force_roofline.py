"""force_roofline: the share of the force pass's least time that the
port's force kernel (csrc/sph_force.cu, K2) reaches: the physics' work
(sphbench/roofline.py, pairs as for density_roofline) over the card's
peaks, divided by K2's device time a step from the trace."""

from sphbench import roofline

KERNEL = "sph_force_kernel"


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not run.pairs:
        return None
    us = sum(b - a for name, a, b in tr.device if KERNEL in name)
    if not us:
        return None
    pairs = sum(run.pairs) / len(run.pairs)
    return roofline.share(roofline.force_work(run.n, pairs),
                          us / 1e6 / tr.steps, run.device_name)
