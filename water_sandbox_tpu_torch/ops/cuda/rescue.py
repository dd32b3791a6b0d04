"""The exact overflow rescue's two kernels (``csrc/sph_rescue.cu``): R1,
the density half, and R2, the force half — the counterpart of
``water_sandbox_tpu/ops/rescue.py::density_rescue`` and ``force_rescue``
under the JAX step's ``lax.cond`` (``ops/pallas/sph_bucket.py:1701``,
``:1727``).

Both work in place and read the rescued count from device memory, so the
step launches them on every step and reads nothing on the host: with count
0 they change nothing. The selection they take (``sel``, ``slot``,
``count``) comes from ``ops/rescue.py::rescue_selection``. Each wrapper
runs its plain version (``density_plain`` / ``force_plain``, the
device-count functions of ``ops/rescue.py``) for CPU tensors and launches
its kernel for CUDA tensors — there is no fallback between the two — and
counts its launches in ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from ...core.params import KernelCoeffs, SimConfig, SimParams
from .. import rescue as rescue_mod
from . import sph_bucket as sb

# Kernel launches by the wrappers (callers that need the main path's count
# reset it first).
LAUNCHES = {"sph_rescue_density": 0, "sph_rescue_force": 0}

# Blocks of part (a), which walk the rescued list with a stride of this
# many: enough to fill the card at thousands of rescued rows, few enough
# that the empty launch of a step without overflow stays short.
_BLOCKS_A = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_inputs(rows, sel, slot, count, params_vec):
    """dtypes, shapes, contiguity and one device of what the kernels read
    through raw pointers: ``rows`` maps a name to (tensor, trailing
    shape)."""
    n = slot.shape[0]
    for name, (t, tail) in rows.items():
        sb._check(t, name, torch.float32, (n,) + tail)
    sb._check(sel, "sel", torch.int32, (sel.numel(),))
    sb._check(slot, "slot", torch.int32, (n,))
    sb._check(count, "count", torch.int32, ())
    sb._check(params_vec, "params_vec", torch.float32, (1, 16))
    ts = [t for t, _ in rows.values()] + [sel, slot, count, params_vec]
    if any(t.device != slot.device for t in ts):
        raise ValueError("kernel inputs must share one device")
    if slot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {slot.device}")
    if sel.numel() == 0:
        raise ValueError("the rescue needs rescue_capacity > 0")


def _launch(name: str, *args) -> None:
    from . import _build
    err = _build.entry("wst_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _blocks_a(sel) -> int:
    return min(sel.shape[0], _BLOCKS_A)


def rescue_density(predicted, sel, slot, count, addr, den, nden, dens,
                   params: SimParams, coeffs: KernelCoeffs, params_vec,
                   cfg: SimConfig) -> None:
    """R1 in place: rescued rows of ``den``/``nden`` (n,) take their exact
    sums; residents gain the rescued rows' contributions, in ``den``,
    ``nden`` and in their six rows of the density planes ``dens`` (6,
    cap_p, L) at ``addr``. Nothing changes when ``count`` is 0. Plain
    version on the CPU, kernel on CUDA."""
    dim = cfg.dim
    _check_inputs({"predicted": (predicted, (dim,)), "den": (den, ()),
                   "nden": (nden, ())}, sel, slot, count, params_vec)
    g = sb._geometry(cfg)
    cap_p = sb._cap_pad(cfg.cell_capacity)
    sb._check(addr, "addr", torch.int32, (slot.shape[0],))
    sb._check(dens, "dens", torch.float32, (6, cap_p, g.L))
    if addr.device != slot.device or dens.device != slot.device:
        raise ValueError("kernel inputs must share one device")
    if slot.device.type == "cpu":
        density_plain(predicted, sel, slot, count, addr, den, nden, dens,
                      params, coeffs, cfg)
        return
    _launch("sph_rescue_density", predicted.data_ptr(), slot.shape[0],
            sel.data_ptr(), slot.data_ptr(), count.data_ptr(),
            addr.data_ptr(), params_vec.data_ptr(), den.data_ptr(),
            nden.data_ptr(), dens.data_ptr(), dim, cap_p, g.L,
            _blocks_a(sel), slot.device.index or 0,
            torch.cuda.current_stream(slot.device).cuda_stream)


def density_plain(predicted, sel, slot, count, addr, den, nden, dens,
                  params: SimParams, coeffs: KernelCoeffs,
                  cfg: SimConfig) -> None:
    """Plain PyTorch version of R1, in place and sync-free: the device-count
    density rescue, then the residents' derived rows written back at their
    addresses (each other row rewrites the value its clamped address
    already holds)."""
    den_r, nden_r = rescue_mod.density_rescue_count(
        predicted, sel, slot, count, den, nden, params, coeffs, cfg)
    den.copy_(den_r)
    nden.copy_(nden_r)
    flat = dens.view(6, -1)
    safe = torch.clamp_max(addr, flat.shape[1] - 1).long()
    write = (slot < 0) & (count > 0)
    flat[:, safe] = torch.where(
        write, sb.derived_density_planes(den, nden, params), flat[:, safe])


def rescue_force(predicted, vel, den, nden, prs, nprs, sel, slot, count,
                 acc, params: SimParams, coeffs: KernelCoeffs, params_vec,
                 cfg: SimConfig) -> None:
    """R2 in place on ``acc`` (n, dim): rescued rows take their exact
    accelerations, residents add the pair forces of the rescued rows.
    Nothing changes when ``count`` is 0. Plain version on the CPU, kernel
    on CUDA."""
    dim = cfg.dim
    _check_inputs({"predicted": (predicted, (dim,)), "vel": (vel, (dim,)),
                   "den": (den, ()), "nden": (nden, ()), "prs": (prs, ()),
                   "nprs": (nprs, ()), "acc": (acc, (dim,))},
                  sel, slot, count, params_vec)
    if slot.device.type == "cpu":
        force_plain(predicted, vel, den, nden, prs, nprs, sel, slot, count,
                    acc, params, coeffs, cfg)
        return
    _launch("sph_rescue_force", predicted.data_ptr(), vel.data_ptr(),
            den.data_ptr(), nden.data_ptr(), prs.data_ptr(), nprs.data_ptr(),
            slot.shape[0], sel.data_ptr(), slot.data_ptr(), count.data_ptr(),
            params_vec.data_ptr(), acc.data_ptr(), dim, _blocks_a(sel),
            slot.device.index or 0,
            torch.cuda.current_stream(slot.device).cuda_stream)


def force_plain(predicted, vel, den, nden, prs, nprs, sel, slot, count, acc,
                params: SimParams, coeffs: KernelCoeffs,
                cfg: SimConfig) -> None:
    """Plain PyTorch version of R2, in place and sync-free."""
    acc.copy_(rescue_mod.force_rescue_count(
        predicted, vel, den, nden, prs, nprs, sel, slot, count, acc, params,
        coeffs, cfg))
