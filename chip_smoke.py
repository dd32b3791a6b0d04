#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``water_sandbox_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, checks
the exact overflow rescue and the ``mini-3d`` golden pins, then drives the
main path through ``Simulation.from_scene(...).run(n)`` on
``reference-cube`` (65,536 particles) and ``moving-container-256k``
(266,112 particles), and checks that both runs went through the kernels.
Any failed check raises, so the exit code is non-zero. The last two lines
are a JSON summary of the kernels and ``{"ok": true, "device": {...}}``.
Needs one CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel-vs-plain bar: occupied slots, per plane
# |kernel - plain| <= RTOL·|plain| + RTOL·max(1, max|plain|). The two sum
# the pairs in different orders (and the force kernel uses rsqrtf).
RTOL = 2e-4

# The JAX package's golden pin ("mini-3d", "pallas", 60) and its tolerances
# (tests/test_golden.py:58-63 and :153-175).
MINI_3D_PIN = dict(
    com=[0.0, -3.79511, 0.0], ke=10585.89,
    bbox_lo=[-2.28083, -4.4, -2.28083], bbox_hi=[2.28083, -3.10759, 2.28083],
    mean_rho=156.2288, vq=[1.79178, 5.23468, 8.81625],
    rq=[152.7888, 152.7888, 168.9195])

KERNELS = {
    "sph_density": dict(
        source="water_sandbox_tpu_torch/csrc/sph_density.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:571"),
    "sph_force": dict(
        source="water_sandbox_tpu_torch/csrc/sph_force.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:1128"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median device time of ``reps`` synchronised calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_planes(name, got, want, occ) -> float:
    """Max |got - want| over the occupied slots ``occ``; raises past the
    bar."""
    worst = 0.0
    for p in range(want.shape[0]):
        w = want[p].reshape(-1)[occ]
        g = got[p].reshape(-1)[occ]
        err = (g - w).abs()
        bar = RTOL * w.abs() + RTOL * max(1.0, float(w.abs().max()))
        check(bool(torch.isfinite(g).all()), f"{name} plane {p}: non-finite")
        check(bool((err <= bar).all()),
              f"{name} plane {p}: max err {float(err.max()):.3e} past the "
              "bar")
        worst = max(worst, float(err.max()))
    return worst


def kernel_inputs(cfg, params, state):
    from water_sandbox_tpu_torch.core.params import KernelCoeffs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    cfg = cfg.resolved()
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    planes, counts, flat, _, _, overflow = sb._build_core(
        state.predicted, state.vel, params, cfg, time=state.time)
    return planes, counts, flat, sb._param_vector(params, coeffs), cfg


def kernels_vs_plain(label, cfg, params, state, record) -> None:
    """K1 against density_plain and K2 against force_plain (on the same
    dens) at the shapes the main path gives them."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    planes, counts, flat, pv, cfg = kernel_inputs(cfg, params, state)
    occ = flat[flat < sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L]
    occ = occ.long()

    dens_k = sb.run_density(planes, counts, flat, pv, cfg)
    dens_p = sb.density_plain(planes, counts, flat, pv, cfg)
    torch.cuda.synchronize()
    err_d = compare_planes(f"{label} sph_density", dens_k, dens_p, occ)
    out_k = sb.run_force(planes, dens_p, counts, flat, pv, cfg)
    out_p = sb.force_plain(planes, dens_p, counts, flat, pv, cfg)
    torch.cuda.synchronize()
    err_f = compare_planes(f"{label} sph_force", out_k, out_p, occ)

    t = {
        "sph_density": (
            cuda_ms(lambda: sb.run_density(planes, counts, flat, pv, cfg)),
            cuda_ms(lambda: sb.density_plain(planes, counts, flat, pv, cfg))),
        "sph_force": (
            cuda_ms(lambda: sb.run_force(planes, dens_p, counts, flat, pv,
                                         cfg)),
            cuda_ms(lambda: sb.force_plain(planes, dens_p, counts, flat, pv,
                                           cfg))),
    }
    for name, err in (("sph_density", err_d), ("sph_force", err_f)):
        ms, plain_ms = t[name]
        log(f"[kernels] {label}: {name} max_abs_err={err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"(n={cfg.n}, planes {tuple(planes.shape)})")
        rec = record.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if label.startswith("reference-cube"):
            rec["ms"], rec["plain_ms"] = ms, plain_ms   # last one wins


def by_id(state, field):
    arr = getattr(state, field).cpu().numpy()
    out = np.empty_like(arr)
    out[state.ids.cpu().numpy()] = arr
    return out


def box_local(params, state):
    from water_sandbox_tpu_torch.ops import integrate as integrate_mod
    center, angle = integrate_mod.container_at(params.container, state.time)
    return integrate_mod._rotate_yaw(state.pos - center, angle,
                                     inverse=True)


def phase_rescue(state100) -> None:
    """reference-cube at cell_capacity 8 (forces overflow): one step on the
    kernel path against the same step on the plain path (CPU). At step 100
    about 5k particles overflow cap 8, past the scene's rescue budget of
    2048, so the budget is raised to keep every particle exact."""
    import water_sandbox_tpu_torch as wst
    cfg, params, _ = wst.scenes.build("reference-cube", device="cuda",
                                      cell_capacity=8, rescue_capacity=8192)
    s_k = wst.step(state100, params, cfg)
    s_p = wst.step(state100.to("cpu"), params.to("cpu"), cfg)
    torch.cuda.synchronize()
    ovf, ovf_p = int(s_k.overflow), int(s_p.overflow)
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    raw = int(sb._build_core(state100.predicted, state100.vel, params, cfg,
                             time=state100.time)[5])
    log(f"[rescue] cap 8: overflowing particles {raw}, unrescued "
        f"{ovf} (plain path {ovf_p})")
    check(raw > 0, "rescue phase must overflow")
    check(ovf == 0 and ovf_p == 0, "rescue left particles unrescued")
    worst = 0.0
    for f in ("density", "near_density", "acc", "vel", "pos"):
        got, want = by_id(s_k, f), by_id(s_p, f)
        err = np.abs(got - want)
        bar = RTOL * np.abs(want) + RTOL * max(1.0, float(np.abs(want).max()))
        check(bool((err <= bar).all()),
              f"rescue step {f}: max err {float(err.max()):.3e} past the bar")
        worst = max(worst, float(err.max()))
    log(f"[rescue] kernel path vs plain path: max_abs_err={worst:.3e}")


def phase_golden() -> None:
    import water_sandbox_tpu_torch as wst
    cfg, params, state = wst.scenes.build("mini-3d", device="cuda",
                                          grid_dims=(20, 16, 16))
    s = wst.rollout(state, params, cfg, 60)
    pos, vel = s.pos.cpu().numpy(), s.vel.cpu().numpy()
    rho = s.density.cpu().numpy()
    g = MINI_3D_PIN
    check(float(s.overflow_total) == 0.0, "golden run dropped particles")
    np.testing.assert_allclose(pos.mean(0), g["com"], atol=2e-3)
    np.testing.assert_allclose(0.5 * (vel ** 2).sum(), g["ke"], rtol=2e-3)
    np.testing.assert_allclose(pos.min(0), g["bbox_lo"], atol=5e-3)
    np.testing.assert_allclose(pos.max(0), g["bbox_hi"], atol=5e-3)
    np.testing.assert_allclose(rho.mean(), g["mean_rho"], rtol=2e-3)
    speed = np.sqrt((vel ** 2).sum(axis=1))
    np.testing.assert_allclose(np.quantile(speed, (0.1, 0.5, 0.9)), g["vq"],
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.quantile(rho, (0.1, 0.5, 0.9)), g["rq"],
                               rtol=2e-3)
    log(f"[golden] mini-3d 60 steps on the kernels: pins met "
        f"(ke {0.5 * (vel ** 2).sum():.2f}, mean_rho {rho.mean():.4f})")


def phase_main_path(scene: str, steps: int, warmup: int) -> dict:
    """Simulation.from_scene(scene).run(steps) on the card; returns the
    launch counts of the run."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    sim = wst.Simulation.from_scene(scene, device="cuda")
    sb.reset_launches()
    sim.run(warmup)
    sim.run(steps - warmup)
    launches = dict(sb.LAUNCHES)
    st = sim.stats()
    s = sim.state
    pos = s.pos
    check(bool(torch.isfinite(pos).all()), f"{scene}: non-finite positions")
    local = box_local(sim.params, s)
    half = sim.params.container.half_size
    check(bool((local.abs() <= half + 1e-4).all()),
          f"{scene}: particles outside the box")
    check(float(s.overflow_total) == 0.0, f"{scene}: overflow_total > 0")
    ids = torch.sort(s.ids.long()).values
    check(bool((ids == torch.arange(s.n, device=ids.device)).all()),
          f"{scene}: ids are not a permutation")
    for k, v in launches.items():
        check(v == steps, f"{scene}: {k} launched {v} times in {steps} "
              "steps")
    log(f"[main] {scene}: {steps} steps, n={s.n}, "
        f"ms/step {st['ms_per_step']:.3f} (timed over {st['steps_timed']} "
        f"steps after {warmup} warm-up), ke {st['kinetic_energy']:.2f}, "
        f"mean_rho {st['mean_density']:.3f}, launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    built = _build.build()
    log(f"[build] {built.path.name}: nvcc {built.seconds:.1f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions, at full shapes
    record: dict = {}
    cfg, params, state = wst.scenes.build("reference-cube", device="cuda")
    kernels_vs_plain("reference-cube fresh", cfg, params, state, record)
    state100 = wst.rollout(state, params, cfg, 100)
    kernels_vs_plain("reference-cube step 100", cfg, params, state100,
                     record)
    cfg2, params2, state2 = wst.scenes.build("dam-break-2d-4k",
                                             device="cuda")
    kernels_vs_plain("dam-break-2d-4k fresh", cfg2, params2, state2, record)
    state2 = wst.rollout(state2, params2, cfg2, 100)
    kernels_vs_plain("dam-break-2d-4k step 100", cfg2, params2, state2,
                     record)

    # 4. exact rescue on the card
    phase_rescue(state100)

    # 5. golden pins
    phase_golden()

    # 6. main path
    launches = phase_main_path("reference-cube", 200, warmup=20)
    phase_main_path("moving-container-256k", 50, warmup=10)

    kernels = []
    for name, meta in KERNELS.items():
        rec = record[name]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": launches[name],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
