#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``water_sandbox_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes, checks
the exact overflow rescue and the ``mini-3d`` golden pins, holds the
kernel pipeline against the dense oracle and ``hash_grid`` against the
weighted oracle on ``mini-3d``, runs ``reference-cube`` in ``bucket_grid``
mode against the kernel pipeline, then drives the single-device path through ``Simulation.from_scene(...).run(n)`` on
``reference-cube`` (65,536 particles) and ``moving-container-256k``
(266,112 particles). The domain-decomposed step runs next: 8 shards of a
128-particle flow against the single-device step (migration and the
cross-shard rescue included; once on the kernels, once on the plain
pair-block passes), then ``DistributedSimulation`` on
``sharded-1m`` (1,015,920 particles, 4 shards on the one card), with the
kernels held against their plain versions on one shard's halo-filled
planes. Last, the bitonic sort against its plain version at every padded
size class (bit-identical, one launch a call), beside ``torch.sort``. Each
path's kernel launches are counted from 0 over its run and checked. Each
kernel's time is given as CUDA-event time of one call and as device time
from ``torch.profiler``, beside its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over 67 TFLOP/s (f32), counted from
this run's inputs. Any failed check raises, so the exit code is non-zero.
The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits non-zero and prints no result.
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

# The domain step's parity bar against the single-device step, summed over
# the axes per particle (tests/test_domain.py:42).
DOMAIN_TOL = 1e-3

# H100 SXM peaks (NVIDIA's data sheet): f32 outside the tensor cores, HBM3.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12

# The TPU kernels (K1-K4) and, for each, the wrapper's launch counter, the
# path whose launches and the call site whose time the summary reports, and
# the step paths it runs on (launches a step are read from each of their
# runs).
KERNELS = {
    "sph_density": dict(
        counter="sph_density", path="reference-cube",
        paths=("reference-cube", "moving-container-256k", "sharded-1m"),
        at="reference-cube step 100",
        source="water_sandbox_tpu_torch/csrc/sph_density.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:571"),
    # the pair-once force of the single-device step (gate "qsym"), ported
    # with the query-side contract
    "sph_force": dict(
        counter="sph_force", path="reference-cube",
        paths=("reference-cube", "moving-container-256k"),
        at="reference-cube step 100",
        source="water_sandbox_tpu_torch/csrc/sph_force.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:1128"),
    # the query-side force kernel the domain step pins (gate "qrow3"): the
    # same source, launched on halo-filled planes
    "sph_force_halo": dict(
        counter="sph_force", path="sharded-1m", paths=("sharded-1m",),
        at="sharded-1m shard 1 (halo-filled)",
        source="water_sandbox_tpu_torch/csrc/sph_force.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:774"),
    # on no step path, as in the JAX package: its launches a step are read
    # from every step path's run all the same
    "bitonic_sort": dict(
        counter="bitonic_sort", path="argsort_keys",
        paths=("reference-cube", "moving-container-256k", "sharded-1m"),
        at="sort n=65536",
        source="water_sandbox_tpu_torch/csrc/bitonic_sort.cu",
        replaces="water_sandbox_tpu/ops/pallas/bitonic_sort.py:55"),
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


def device_ms(fn, kernel: str, reps: int = 20):
    """Device time per call of the kernels whose name holds ``kernel``
    (all device work for ""), from torch.profiler over ``reps`` calls after
    one warm-up; None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum((getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0.0))
             for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3 if us > 0 else None


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                        else "bytes")


def pair_counts(planes, counts, addr, cfg, h):
    """(rows, P_c, P_h) of this input: occupied rows, candidate slots the
    kernels walk (every occupied slot of the 3^dim neighbour lanes), and
    pairs within h (self excluded)."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    P = planes[:cfg.dim].reshape(cfg.dim, -1)
    rows = p_c = p_h = 0
    for a, cidx, mask in sb._candidate_chunks(counts, addr, cfg):
        d2 = sum((P[k][cidx] - P[k][a][:, None, None]) ** 2
                 for k in range(cfg.dim))
        rows += a.numel()
        p_c += int(mask.sum())
        p_h += int((mask & (cidx != a[:, None, None]) & (d2 <= h * h)).sum())
    return rows, p_c, p_h


def density_bound(rows, p_c, p_h, L, dim):
    """Reads positions and addr, writes 6 planes a row, reads counts;
    3*dim - 1 flops of distance a candidate, 9 of the two kernels a pair
    within h (the self pair of every row among them)."""
    return bound(p_c * (3 * dim - 1) + (p_h + rows) * 9,
                 rows * (4 * dim + 4 + 24) + 4 * L)


def force_bound(rows, p_c, p_h, L, dim):
    """Reads positions, velocities and the 6 density planes, writes 2 + dim
    planes a row, reads counts; 3*dim - 1 flops a candidate, 20 + 5*dim a
    pair within h."""
    return bound(p_c * (3 * dim - 1) + p_h * (20 + 5 * dim),
                 rows * (8 * dim + 24 + 4 * (2 + dim)) + 4 * L)


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


def hold_and_time(label, record, planes, counts, addr, pv, cfg, h, dens_k,
                  dens_in, plain_reps=20, force_key="sph_force") -> None:
    """K1's output ``dens_k`` against density_plain, and the force kernel
    on ``dens_in`` against force_plain; their event and device times, the
    plain versions' event times, and the bounds from this input's pair
    counts. Where the wrappers put several threads on a row, each kernel
    with one thread a row too, checked and timed beside it."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    cap_p = sb._cap_pad(cfg.cell_capacity)
    occ = addr[addr < cap_p * sb._geometry(cfg).L].long()
    # K1 reads the empty slots of a run's lanes unpredicated: every position
    # slot at or above its lane's count must hold the build's far fill
    empty = torch.arange(cap_p, device=counts.device)[:, None] >= counts
    check(bool((planes[:cfg.dim][:, empty] == sb._FAR).all()),
          f"{label}: an empty position slot does not hold the far fill")
    dens_p = sb.density_plain(planes, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    err_d = compare_planes(f"{label} sph_density", dens_k, dens_p, occ)
    out_p = sb.force_plain(planes, dens_in, counts, addr, pv, cfg)
    err_f = compare_planes(
        f"{label} sph_force", sb.run_force(planes, dens_in, counts, addr, pv,
                                           cfg), out_p, occ)
    rows, p_c, p_h = pair_counts(planes, counts, addr, cfg, h)
    L = sb._geometry(cfg).L

    def density():
        return sb.run_density(planes, counts, addr, pv, cfg)

    def force():
        return sb.run_force(planes, dens_in, counts, addr, pv, cfg)
    rec_d = dict(
        max_abs_err=err_d, ms=cuda_ms(density),
        plain_ms=cuda_ms(lambda: sb.density_plain(planes, counts, addr, pv,
                                                  cfg), reps=plain_reps),
        device_ms=device_ms(density, "sph_density"))
    rec_d["bound_ms"], rec_d["bound_by"] = density_bound(rows, p_c, p_h, L,
                                                         cfg.dim)
    rec_f = dict(
        max_abs_err=err_f, ms=cuda_ms(force),
        plain_ms=cuda_ms(lambda: sb.force_plain(planes, dens_in, counts,
                                                addr, pv, cfg),
                         reps=plain_reps),
        device_ms=device_ms(force, "sph_force"))
    rec_f["bound_ms"], rec_f["bound_by"] = force_bound(rows, p_c, p_h, L,
                                                       cfg.dim)
    # both kernels take the wrappers' one picker
    group = sb._row_group(addr.shape[0],
                          sb._sm_count(planes.device.index or 0))
    ones = (("sph_density", rec_d, dens_p, lambda: sb._density_kernel(
                planes, counts, addr, pv, cfg, 1)),
            ("sph_force", rec_f, out_p, lambda: sb._force_kernel(
                planes, dens_in, counts, addr, pv, cfg, 1)))
    for name, rec, want, one in ones:
        rec["extra"] = f" threads a row {group}"
        if group > 1:
            err_1 = compare_planes(f"{label} {name} one thread a row", one(),
                                   want, occ)
            rec["max_abs_err"] = max(rec["max_abs_err"], err_1)
            rec["one_thread_ms"] = cuda_ms(one)
            rec["one_thread_device_ms"] = device_ms(one, name)
            rec["extra"] += (
                f" (one thread a row: max_abs_err={err_1:.3e} kernel_ms="
                f"{rec['one_thread_ms']:.4f} device_ms="
                f"{fmt(rec['one_thread_device_ms'])})")
    for name, key, rec in (("sph_density", "sph_density", rec_d),
                           ("sph_force", force_key, rec_f)):
        log(f"[kernels] {label}: {name} max_abs_err={rec['max_abs_err']:.3e}"
            f" kernel_ms={rec['ms']:.4f} device_ms={fmt(rec['device_ms'])} "
            f"plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.3e} "
            f"({rec['bound_by']}) library_ms=none{rec.pop('extra')} (rows "
            f"{rows}, candidates {p_c}, pairs within h {p_h}, planes "
            f"{tuple(planes.shape)})")
        record.setdefault(key, {})[label] = rec


def row_group_crossing(label, planes, counts, addr, pv, cfg, dens) -> None:
    """Device time of both row kernels with one and with two threads a row
    on the first m rows of ``addr``, for m around the row count at which
    ``_row_group`` goes from 2 to 1 on this card: the measurement its
    threshold rests on."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    sms = sb._sm_count(planes.device.index or 0)
    at = sms * sb._ROW_THREADS_PER_SM
    for m in sorted({at * k // 8 for k in (5, 6, 7, 9, 10, 12)}
                    | {at - 1, at, addr.shape[0]}):
        if m > addr.shape[0]:
            continue
        sub = addr[:m].contiguous()
        t = {(name, g): device_ms(fn(g), name)
             for name, fn in (
                 ("sph_density", lambda g: lambda: sb._density_kernel(
                     planes, counts, sub, pv, cfg, g)),
                 ("sph_force", lambda g: lambda: sb._force_kernel(
                     planes, dens, counts, sub, pv, cfg, g)))
             for g in (1, 2)}
        log(f"[kernels] {label}, first {m} rows (the picker gives "
            f"{sb._row_group(m, sms)} threads a row; 2 below {at} rows on "
            f"{sms} SMs): device_ms sph_density one thread a row "
            f"{fmt(t['sph_density', 1])}, two {fmt(t['sph_density', 2])}; "
            f"sph_force one {fmt(t['sph_force', 1])}, two "
            f"{fmt(t['sph_force', 2])}")


def fmt(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def kernels_vs_plain(label, cfg, params, state, record,
                     crossing=False) -> None:
    """K1 against density_plain and K2 against force_plain (on the same
    dens) at the shapes the main path gives them; with ``crossing`` the
    row-subset timings of row_group_crossing too."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    planes, counts, flat, pv, cfg = kernel_inputs(cfg, params, state)
    dens_k = sb.run_density(planes, counts, flat, pv, cfg)
    dens_p = sb.density_plain(planes, counts, flat, pv, cfg)
    hold_and_time(label, record, planes, counts, flat, pv, cfg,
                  float(params.smoothing_radius), dens_k, dens_p)
    if crossing:
        row_group_crossing(label, planes, counts, flat, pv, cfg, dens_p)


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
    worst = max(hold(f"rescue step {f}", by_id(s_k, f), by_id(s_p, f))
                for f in ("density", "near_density", "acc", "vel", "pos"))
    log(f"[rescue] kernel path vs plain path: max_abs_err={worst:.3e}")


def phase_golden():
    """The JAX package's ("mini-3d", "pallas", 60) pin on the kernels;
    returns the scene's config, parameters and its state at step 60."""
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
    return cfg, params, s


def hold(name, got, want, rtol=RTOL) -> float:
    """|got - want| <= rtol·|want| + rtol·max(1, max|want|) elementwise on
    two numpy arrays; returns the max error, raises past the bar."""
    err = np.abs(got - want)
    bar = rtol * np.abs(want) + rtol * max(1.0, float(np.abs(want).max()))
    check(bool(np.isfinite(got).all()), f"{name}: non-finite")
    check(bool((err <= bar).all()),
          f"{name}: max err {float(err.max()):.3e} past the bar")
    return float(err.max())


def phase_oracle(cfg, params, state) -> None:
    """mini-3d on the card, from its compressed state at step 60: one step
    of the dense oracle against one step of the kernel pipeline (density,
    near density and acceleration by particle id, the 2e-4 bar of the JAX
    package's test_pallas_matches_xla_bucket), and hash_grid, on a table
    small enough to collide, against the oracle weighted by
    reference_pair_weights (tests/test_grid.py's parity)."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import KernelCoeffs
    from water_sandbox_tpu_torch.ops import dense, grid, hashing
    s_k = wst.step(state, params, cfg)
    s_d = wst.step(state, params,
                   dataclasses.replace(cfg, neighbor_mode="dense"))
    check(int(s_k.overflow) == 0, "oracle phase: the kernel step overflowed")
    worst = max(hold(f"kernel pipeline vs dense oracle, {f}", by_id(s_k, f),
                     by_id(s_d, f))
                for f in ("density", "near_density", "acc"))
    check(float(s_d.acc.abs().max()) > 1.0, "oracle phase: no pair forces")
    log(f"[oracle] mini-3d step 61: kernel pipeline vs dense oracle by id, "
        f"max_abs_err={worst:.3e} (max |acc| "
        f"{float(s_d.acc.abs().max()):.1f})")

    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    cfg_h = dataclasses.replace(cfg, neighbor_mode="hash_grid",
                                hash_table_size=61)
    pred, vel = state.predicted, state.vel
    w = hashing.reference_pair_weights(pred, params.smoothing_radius,
                                       cfg_h.table_size)
    got = grid.hash_sph(pred, vel, params, coeffs, cfg_h)
    want = dense.density_pass(pred, params, coeffs, pair_weight=w)
    want += (dense.force_pass(pred, vel, *want, params, coeffs,
                              pair_weight=w),)
    check(int(got[5]) == 0, "oracle phase: a hash run was truncated")
    check(int(w.max()) > 1, "oracle phase: no hash collision to multi-count")
    worst = max(hold(f"hash_grid vs weighted oracle, {name}",
                     g.cpu().numpy(), x.cpu().numpy())
                for name, g, x in zip(("den", "nden", "prs", "nprs", "acc"),
                                      got, want))
    log(f"[oracle] mini-3d step 60: hash_grid vs dense oracle with "
        f"reference_pair_weights (table {cfg_h.table_size}, max weight "
        f"{int(w.max())}), max_abs_err={worst:.3e}")


def phase_bucket_grid(state100, steps: int = 10) -> None:
    """reference-cube at full width with neighbor_mode="bucket_grid"
    (particle-order rows, the plain pair-block passes of ops/grid.py) from
    the step-100 state: ``steps`` steps against the kernel pipeline's from
    the same state, by particle id; every particle exact."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    cfg_k, params, _ = wst.scenes.build("reference-cube", device="cuda")
    cfg_b = dataclasses.replace(cfg_k, neighbor_mode="bucket_grid",
                                sorted_state=False)
    base = float(state100.overflow_total)
    s_k = wst.rollout(state100, params, cfg_k, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s_b = wst.step(state100, params, cfg_b)          # warm-up, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_b = wst.rollout(s_b, params, cfg_b, steps - 1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(float(s_b.overflow_total) == base
          and float(s_k.overflow_total) == base,
          "bucket_grid phase: overflow_total grew")
    err = float(np.abs(by_id(s_b, "pos") - by_id(s_k, "pos"))
                .sum(axis=1).max())
    log(f"[bucket_grid] reference-cube from step 100: {steps} steps, "
        f"n={s_b.n}, ms/step {ms:.3f} (host clock over {steps - 1} synced "
        f"steps after 1 warm-up), peak memory {peak:.2f} GiB, "
        f"overflow_total {float(s_b.overflow_total) - base}, max |dpos| by "
        f"id vs the kernel pipeline {err:.3e}")
    check(err <= DOMAIN_TOL, f"bucket_grid phase: parity {err:.3e}")


def phase_main_path(scene: str, steps: int, warmup: int):
    """Simulation.from_scene(scene).run(steps) on the card; returns the
    launch counts of the run and its steps."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    sim = wst.Simulation.from_scene(scene, device="cuda")
    sb.reset_launches()
    bs.reset_launches()
    sim.run(warmup)
    sim.run(steps - warmup)
    launches = {**sb.LAUNCHES, **bs.LAUNCHES}
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
    for k in sb.LAUNCHES:
        check(launches[k] == steps, f"{scene}: {k} launched {launches[k]} "
              f"times in {steps} steps")
    log(f"[main] {scene}: {steps} steps, n={s.n}, "
        f"ms/step {st['ms_per_step']:.3f} (timed over {st['steps_timed']} "
        f"steps after {warmup} warm-up), ke {st['kinetic_energy']:.2f}, "
        f"mean_rho {st['mean_density']:.3f}, launches {launches}")
    return launches, steps


def sharded_by_id(states, active) -> np.ndarray:
    """Positions of the active slots of all shards, row = particle id."""
    act = torch.cat([a.cpu() for a in active]).numpy() > 0
    ids = torch.cat([s.ids.cpu() for s in states]).numpy()[act]
    pos = torch.cat([s.pos.cpu() for s in states]).numpy()[act]
    check(bool((np.sort(ids) == np.arange(ids.size)).all()),
          "sharded ids are not a permutation")
    out = np.empty_like(pos)
    out[ids] = pos
    return out


def phase_domain_parity(dev, use_pallas=None) -> None:
    """__graft_entry__.py::dryrun_multichip on the port: 8 shards of a
    128-particle cube in rightward flow (real migration), then forced
    overflow, each against the single-device step from the same state.
    ``use_pallas=False`` runs the shards' plain pair-block passes
    (ops/grid.py) in place of the kernels, at the same bars."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import Container
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    nsh = 8
    gx = 3 * nsh
    pts = wst.cube_fluid(8, 4, 4)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    params = wst.SimParams.create(
        dim=3, device=dev, container=Container.create(
            (0.0, 0.0, 0.0), (gx * 0.25 - 1.0, 1.8, 1.8), device=dev))
    cfg = wst.SimConfig(n=pts.shape[0], dim=3, grid_dims=(gx, 8, 8),
                        cell_capacity=16)
    state0 = wst.init_state(pts, vel, device=dev)
    mesh = mesh_mod.make_mesh(nsh, dev)
    cases = (("flow", cfg, 8),
             ("rescue cap 2", dataclasses.replace(
                 cfg, cell_capacity=2, rescue_capacity=512), 6),
             ("rescue cap 1", dataclasses.replace(
                 cfg, cell_capacity=1, rescue_capacity=512), 6))
    for label, c, steps in cases:
        states, active = domain.shard_state(state0, mesh, c, params,
                                            slack=float(nsh))
        raw = sum(int(o) for o in domain.halo_planes(
            [s.predicted for s in states], [s.vel for s in states], active,
            [params] * nsh, c, gx // nsh, mesh)[3])
        step = domain.make_domain_step(mesh, c, use_pallas=use_pallas)
        before = [int(a.sum()) for a in active]
        lost = ovf = 0.0
        sb.reset_launches()
        for _ in range(steps):
            states, active, lost_step = step(states, active, params)
            lost += float(lost_step)
            ovf += float(states[0].overflow)
        after = [int(a.sum()) for a in active]
        want = 0 if use_pallas is False else nsh * steps
        check(all(v == want for v in sb.LAUNCHES.values()),
              f"domain {label}: launches {sb.LAUNCHES}, expected {want}")
        single = wst.rollout(state0, params, c, steps)
        err = float(np.abs(sharded_by_id(states, active)
                           - by_id(single, "pos")).sum(axis=1).max())
        path = "plain passes" if use_pallas is False else "kernels"
        log(f"[domain] parity {label} ({path}): {steps} steps, per-shard "
            f"counts {before} -> {after}, overflowing at step 0 {raw}, lost "
            f"{lost}, unrescued {ovf}, max |dpos| by id {err:.3e}")
        check(lost == 0.0, f"domain {label}: lost {lost} particles")
        check(ovf == 0.0, f"domain {label}: {ovf} unrescued")
        check(float(single.overflow_total) == 0.0,
              f"domain {label}: the single-device reference overflowed")
        check(err <= DOMAIN_TOL, f"domain {label}: parity {err:.3e}")
        if label == "flow":
            check(after != before, "domain flow: no shard crossing")
        if label.startswith("rescue"):
            check(raw > 0, f"domain {label} must overflow")


def domain_kernels_vs_plain(sim, shard: int, record) -> None:
    """K1 and K3 against their plain versions on one shard's halo-filled
    planes: the shards' builds, the position and velocity halo exchange,
    every shard's density, the density halo exchange, then the force on
    ``shard``'s planes (the inputs the domain step gives the kernels)."""
    from water_sandbox_tpu_torch.core.params import KernelCoeffs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.parallel import domain
    mesh, cfg = sim.mesh, sim.cfg
    gx_loc = cfg.grid_dims[0] // mesh.size
    cfg_loc = domain._local_cfg(cfg, gx_loc)
    g = sb._geometry(cfg_loc)
    feats, counts, addr, _ = domain.halo_planes(
        [s.predicted for s in sim.states], [s.vel for s in sim.states],
        sim.active, [sim.params] * mesh.size, cfg, gx_loc, mesh)
    coeffs = KernelCoeffs.from_radius(sim.params.smoothing_radius, cfg.dim)
    pv = sb._param_vector(sim.params, coeffs)
    dens = [sb.run_density(feats[d], counts[d], addr[d], pv, cfg_loc)
            for d in range(mesh.size)]
    dens = domain._exchange_halo_slabs(dens, gx_loc, g.S_pad, g.PAD, mesh)
    f, c, a, dn = feats[shard], counts[shard], addr[shard], dens[shard]
    halo = (float(c[0, g.PAD - g.S_pad:g.PAD].sum()),
            float(c[0, g.PAD + gx_loc * g.S_pad:
                    g.PAD + (gx_loc + 1) * g.S_pad].sum()))
    check(min(halo) > 0, f"shard {shard}: a halo slab is empty {halo}")
    hold_and_time(f"{sim.name} shard {shard} (halo-filled)", record, f, c,
                  a, pv, cfg_loc, float(sim.params.smoothing_radius), dn, dn,
                  plain_reps=5, force_key="sph_force_halo")
    log(f"[kernels] {sim.name} shard {shard}: halo particles {halo}")


def phase_domain_full(record, scene="sharded-1m", dev="cuda"):
    """DistributedSimulation on ``scene``, 4 shards on the card: 10 steps
    held by id against the single-device step from the same state, the
    kernels against their plain versions on halo-filled planes, then 20
    timed steps. Returns the kernel launches of the 30 steps and 30."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.runtime.distributed import (
        DistributedSimulation)
    nsh, warm, timed = 4, 10, 20
    cfg, params, state = wst.scenes.build(scene, device=dev)
    single = wst.rollout(state, params, cfg, warm)
    want = by_id(single, "pos")
    check(float(single.overflow_total) == 0.0,
          f"{scene}: the single-device reference overflowed")
    del single, state
    sim = DistributedSimulation.from_scene(scene, n_shards=nsh, device=dev)

    sb.reset_launches()
    bs.reset_launches()
    sim.run(warm)
    launches = {**sb.LAUNCHES, **bs.LAUNCHES}
    err = float(np.abs(sharded_by_id(sim.states, sim.active) - want)
                .sum(axis=1).max())
    log(f"[domain] {scene}: n={sim.cfg.n}, {warm} steps on {nsh} shards "
        f"(gx_loc {sim.cfg.grid_dims[0] // nsh}), max |dpos| by id vs "
        f"single device {err:.3e}")
    check(err <= DOMAIN_TOL, f"{scene}: parity {err:.3e}")
    domain_kernels_vs_plain(sim, 1, record)

    sb.reset_launches()
    bs.reset_launches()
    t0 = time.perf_counter()
    sim.run(timed)
    ms = 1000.0 * (time.perf_counter() - t0) / timed
    for k, v in {**sb.LAUNCHES, **bs.LAUNCHES}.items():
        launches[k] += v
    st = sim.stats()
    dense = sim.to_dense_state().to(dev)
    check(dense.n == sim.cfg.n, f"{scene}: lost slots")
    check(bool(torch.isfinite(dense.pos).all()
               and torch.isfinite(dense.vel).all()),
          f"{scene}: non-finite state")
    half = sim.params.container.half_size
    check(bool((box_local(sim.params, dense).abs() <= half + 1e-4).all()),
          f"{scene}: particles outside the box")
    check(st["lost_particles"] == 0.0, f"{scene}: lost_total > 0")
    check(st["overflow_total"] == 0.0, f"{scene}: overflow_total > 0")
    for k in sb.LAUNCHES:
        check(launches[k] == nsh * (warm + timed),
              f"{scene}: {k} launched {launches[k]} times in "
              f"{warm + timed} steps on {nsh} shards")
    log(f"[main] {scene} on {nsh} shards: ms/step {ms:.3f} (host clock "
        f"over {timed} synced steps after {warm} warm-up), lost_total "
        f"{st['lost_particles']}, overflow_total {st['overflow_total']}, "
        f"per-shard counts {st['per_shard_counts']}, ke "
        f"{st['kinetic_energy']:.2f}, launches {launches}")
    return launches, warm + timed


def sort_case(rng, n: int, kind: str):
    """int32 (keys, values) on the card: random keys with many ties,
    descending, all equal, or with real INT32_MAX keys (they tie with the
    padding)."""
    if kind == "random":
        keys = rng.integers(-2000, 2000, n)
    elif kind == "descending":
        keys = np.arange(n)[::-1] // 3
    elif kind == "all_equal":
        keys = np.full(n, -4)
    else:
        keys = rng.integers(-50, 50, n)
        keys[rng.random(n) < 0.3] = np.iinfo(np.int32).max
    return (torch.from_numpy(np.ascontiguousarray(keys, np.int32)).cuda(),
            torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda())


def phase_sort(record, dev="cuda") -> int:
    """K4 against its plain version (bit-identical keys and values, one
    launch a call) at every padded size class, with four key patterns;
    event and device times beside torch.sort's at four sizes; then its
    path: argsort_keys on reference-cube's 65,536 cell keys, the
    reference's use. Returns that path's launches."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops import hashing
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    rng = np.random.default_rng(0)
    for n in (1, 2, 1000, 1024, 8192, 8193, 50000, 65536):
        for kind in ("random", "descending", "all_equal", "int32_max"):
            keys, vals = sort_case(rng, n, kind)
            bs.reset_launches()
            gk, gv = bs.sort_pairs(keys, vals)
            check(bs.LAUNCHES["bitonic_sort"] == 1,
                  f"sort n={n} {kind}: {bs.LAUNCHES} launches")
            wk, wv = bs.sort_pairs_plain(keys, vals)
            torch.cuda.synchronize()
            check(bool(torch.equal(gk, wk) and torch.equal(gv, wv)),
                  f"sort n={n} {kind}: kernel and plain differ")
            check(bool(torch.equal(gk, torch.sort(keys).values)),
                  f"sort n={n} {kind}: keys not sorted")
        log(f"[sort] n={n}: bit-identical to the plain version for random, "
            "descending, all-equal and INT32_MAX keys, 1 launch a call")
    for n in (1000, 8192, 50000, 65536):
        keys, vals = sort_case(rng, n, "random")
        n_pad = max(1024, 1 << (n - 1).bit_length())
        lg = n_pad.bit_length() - 1
        # every stage compare-exchanges n_pad / 2 pairs; n pairs are read
        # and written once (the padding is made on the chip)
        b_ms, b_by = bound(lg * (lg + 1) // 2 * n_pad // 2, 16 * n)
        rec = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: bs.sort_pairs(keys, vals)),
            device_ms=device_ms(lambda: bs.sort_pairs(keys, vals),
                                "bitonic"),
            plain_ms=cuda_ms(lambda: bs.sort_pairs_plain(keys, vals),
                             reps=5),
            library_ms=cuda_ms(lambda: torch.sort(keys, stable=True)),
            library_device_ms=device_ms(
                lambda: torch.sort(keys, stable=True), ""),
            bound_ms=b_ms, bound_by=b_by)
        log(f"[sort] n={n}: kernel_ms={rec['ms']:.4f} device_ms="
            f"{fmt(rec['device_ms'])} plain_ms={rec['plain_ms']:.4f} "
            f"bound_ms={b_ms:.3e} ({b_by}) library_ms (torch.sort, stable)="
            f"{rec['library_ms']:.4f} its device_ms="
            f"{fmt(rec['library_device_ms'])}")
        record.setdefault("bitonic_sort", {})[f"sort n={n}"] = rec
    try:
        big = torch.zeros(65537, dtype=torch.int32, device=dev)
        bs.sort_pairs(big, big)
    except ValueError:
        pass
    else:
        raise AssertionError("sort: n_pad > 65,536 did not raise")

    cfg, params, state = wst.scenes.build("reference-cube", device=dev)
    h = params.smoothing_radius
    cell = hashing.get_cell(state.predicted
                            - hashing.grid_origin(state.predicted, h), h)
    gy, gz = cfg.grid_dims[1], cfg.grid_dims[2]
    keys = (cell[:, 0] * gy + cell[:, 1]) * gz + cell[:, 2]
    bs.reset_launches()
    sk, order = bs.argsort_keys(keys)
    launches = bs.LAUNCHES["bitonic_sort"]
    wk, worder = bs.sort_pairs_plain(
        keys, torch.arange(keys.shape[0], dtype=torch.int32, device=dev))
    check(bool(torch.equal(sk, wk) and torch.equal(order, worder)),
          "argsort_keys: kernel and plain differ")
    check(bool(torch.equal(keys[order.long()], sk)), "argsort_keys order")
    log(f"[sort] argsort_keys on reference-cube's {keys.shape[0]} cell "
        f"keys: bit-identical to the plain version, launches {launches}")
    check(launches == 1, "argsort_keys did not launch the kernel")
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
    # the flagship's gz = 58 window
    cfg3, params3, state3 = wst.scenes.build("moving-container-256k",
                                             device="cuda")
    kernels_vs_plain("moving-container-256k step 10", cfg3, params3,
                     wst.rollout(state3, params3, cfg3, 10), record,
                     crossing=True)
    del state3

    # 4. exact rescue on the card
    phase_rescue(state100)

    # 5. golden pins, the oracle and the plain neighbour modes
    phase_oracle(*phase_golden())
    phase_bucket_grid(state100)

    # 6. single-device path
    paths = {"reference-cube": phase_main_path("reference-cube", 200,
                                               warmup=20),
             "moving-container-256k": phase_main_path(
                 "moving-container-256k", 50, warmup=10)}

    # 7. domain-decomposed path
    phase_domain_parity("cuda:0")
    phase_domain_parity("cuda:0", use_pallas=False)
    paths["sharded-1m"] = phase_domain_full(record)

    # 8. the bitonic sort and its own path (launches per call, not step)
    paths["argsort_keys"] = ({"bitonic_sort": phase_sort(record)}, 1)

    kernels = []
    for name, meta in KERNELS.items():
        rec = record[name][meta["at"]]
        launches, _ = paths[meta["path"]]
        per_step = {p: paths[p][0][meta["counter"]] / paths[p][1]
                    for p in meta["paths"]}
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": launches[meta["counter"]],
            "max_abs_err": max(r["max_abs_err"]
                               for r in record[name].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            "device_ms": rec["device_ms"], "at": meta["at"],
            "launches_per_step": per_step})
        log(f"[kernels] {name}: launches_per_step {per_step}, at "
            f"{meta['at']}: kernel_ms {rec['ms']:.4f}, device_ms "
            f"{fmt(rec['device_ms'])}, bound_ms {rec['bound_ms']:.3e} "
            f"({rec['bound_by']}), library_ms "
            f"{fmt(rec.get('library_ms')) if name == 'bitonic_sort' else 'none'}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
