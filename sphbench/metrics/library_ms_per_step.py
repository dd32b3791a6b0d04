"""library_ms_per_step: device ms a step of every device operation in the
traced window that is not one of the port's own CUDA kernels (ATen's
kernels, copies and sets: mostly the build's keys and sort and the
integration). The program's empty phase markers (``wst_phase_*``, launched
only while a profiler records, sphbench/phases.py) are not counted."""

from sphbench import phases

# The port's hand-written kernels (water_sandbox_tpu_torch/csrc/*.cu).
OWN_KERNELS = ("sph_density_kernel", "sph_force_kernel",
               "rescue_density_kernel", "rescue_force_kernel",
               "domain_density_kernel", "domain_force_kernel",
               "bitonic_sort_cluster", "set_if_kernel", "sph_build_kernel")


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.device:
        return None
    us = sum(b - a for name, a, b in tr.device
             if not name.startswith(phases.PREFIX)
             and not any(k in name for k in OWN_KERNELS))
    return us / 1e3 / tr.steps
