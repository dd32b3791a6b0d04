"""density_roofline: the share of the density pass's least time that the
port's density kernel (csrc/sph_density.cu, K1) reaches: the physics'
work (sphbench/roofline.py: pairs within h counted by true_pairs on the
traced window's first and last predicted positions, their mean) over the
card's peaks, divided by K1's device time a step from the trace."""

from sphbench import roofline

KERNEL = "sph_density_kernel"


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not run.pairs:
        return None
    us = sum(b - a for name, a, b in tr.device if KERNEL in name)
    if not us:
        return None
    pairs = sum(run.pairs) / len(run.pairs)
    return roofline.share(roofline.density_work(run.n, pairs),
                          us / 1e6 / tr.steps, run.device_name)
