#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare DIR   # this tree against an older one
    python3 chip_smoke.py --params DIR    # [params], and states against DIR
    python3 chip_smoke.py --replay-cost DIR  # replays' device time, both trees
    python3 chip_smoke.py --trace-margin TRIALS  # profiler traces' drops


Builds the port's CUDA kernels from ``water_sandbox_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes (the build's
and the integrate's and the parameter kernels' bit for bit: [build],
[integrate], [params]), checks
the exact overflow rescue (the step on the card against the CPU, and the
rescue's two kernels against their plain versions at ~5k dropped rows, at
64, 512 and 2,048 of them, at count 0 and at the flagship forced past its
budget, each timed beside two bounds: the cell-list walk's work and the
all-pairs sweep's), the step captured as a CUDA graph against the eager step on
both flagship scenes ([capture]: bit for bit over ``reference-cube``'s
rescue-firing steps 100-200 and over 50 settled steps of each, the eager
step under ``torch.cuda.set_sync_debug_mode("error")``, launches a replay,
peak memory, eager and captured ms/step alternated), the JAX package's
``mini-3d`` golden pin
(and that the planted physics bug of ``golden.flipped_near_derivative``
trips it), holds the
kernel pipeline against the dense oracle and ``hash_grid`` against the
weighted oracle on ``mini-3d`` (eager and captured steps), runs ``reference-cube`` in ``bucket_grid``
mode against the kernel pipeline ([bucket_grid]: the eager step under sync
debug "error", the captured step against it bit for bit, eager and
captured ms/step alternated, R1 and R2 launched once a step, also at cell
capacity 8), then the same step in 4 cell slabs of the card through
``parallel/gspmd.py`` ([gspmd]: each slab's planes against the
single-device build bit for bit, 10 steps against the single-device step,
captured against eager bit for bit, ms/step, peak memory, the bytes each
collective moves a step, and at cell capacity 8 R1 and R2 held against
their plain versions on the sharded path; at cell capacity 24 and 8 the
mesh with a CUDA stream a shard against the serial reference, below),
then the "dense" and
"hash_grid" steps on the device only ([modes]: ``mini-3d`` and
``dam-break-2d-4k`` from steps 0 and 100 in "dense"; ``mini-3d``,
``reference-cube`` and ``moving-container-256k`` in "hash_grid"; each
eager step under sync debug "error", 10 captured steps against 10 eager
ones bit for bit, ms/step eager and captured alternated, capture seconds,
peak memory, kernels a replay and busy share of 20 traced replays, the
hash runs truncated; the bench's fingerprint in both modes; one CLI run
in "dense"). Then the port's own 1,000-step pins of
``reference-cube`` and ``moving-container-256k``, made on the card
(``golden.GOLDEN``): the kernels' own row group must meet the pin and
repeat bit for bit, the row groups G = 1, 2 and 4 (three summation
orders, all different) and the eager step with the rescue's plain versions
must stay within the pin's bars, no particle may drop, and the planted bug
must trip a pin; and the same for ``dam-break-2d-4k`` in "dense" over its
captured step, with the scene's row order and two seeded permutations of
it as the three orders. Then it drives the single-device path through ``Simulation.from_scene(...).run(n)`` on
``reference-cube`` (65,536 particles) and ``moving-container-256k``
(266,112 particles), then the incremental plane-resident mode on
``reference-cube`` in particle order (parity with the rebuild path at the
JAX package's bars, the cache invariants, both kernels on re-inserted
planes with holes, the step captured with its rebuild, drop-step and
materialize branches as CUDA graph IF conditional nodes against the eager
step bit for bit, keep-or-drop windows of replayed graphs for k = 0, 4, 8,
16, and ``Simulation.from_scene(..., incremental_rebuild=8).run``). The
domain-decomposed step runs next: 8 shards of a
128-particle flow against the single-device step (migration and the
cross-shard rescue included, also with one shard alone overflowing; once
on the kernels, with the rescue's kernels D1 and D2 held against their
plain versions, once on the plain pair-block passes; each also captured
against its eager steps bit for bit; at cell capacity 1 the mesh with a
stream a shard against the serial reference, below), then
``DistributedSimulation`` on ``sharded-1m`` (1,015,920 particles, 4
shards on the one card) with its step captured as one CUDA graph: parity
by id with the single device, the kernels held against their plain
versions on one shard's halo-filled planes, captured against eager bit
for bit over 20 steps, ms/step captured and eager alternated, kernels a
replay, the summed device time beside its union, the busy share on the
union and the kernel pairs of different streams that overlap in 20
replays, then the mesh with a stream a shard against the serial
reference (``concurrent_vs_serial``: 10 repeats of 30 captured steps bit
for bit against the serial mesh's, launches a replay, peak memory, 10
alternated pairs of windows, both traced); then [domain-rescue], the same
state at a cell capacity where every shard drops more rows than the
rescue takes: D1 and D2 against their plain versions, timed beside the
cell list's and the all-pairs sweep's bounds, at count 0 (bit for bit
unchanged), and the rescue step's ms/step. Then the bitonic sort
against its plain version at every padded size class (bit-identical, one
launch a call), beside ``torch.sort``. Last,
the front end: ``python -m water_sandbox_tpu_torch.cli`` as subprocesses
(``scenes``; ``run`` at its default 2-D scene and at ``reference-cube``,
each with a trajectory and a checkpoint; ``resume`` held by id against the
same steps in this process; ``bench``), ``runtime/profiling.py``'s trace of
``Simulation.run`` (the step's four kernels once a step, its six phase
markers in order, no program span among the device events), ``viz/live.py`` on a stub
terminal, ``viz/server.py`` over HTTP (a density raster at the flagship,
points at ``dam-break-2d-4k``), and ``python -m
water_sandbox_tpu_torch.bench`` at its defaults. Each
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

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Kernel-vs-plain bar: occupied slots, per plane
# |kernel - plain| <= RTOL·|plain| + RTOL·max(1, max|plain|). The two sum
# the pairs in different orders (and the force kernel uses rsqrtf).
RTOL = 2e-4

# The scenes with 1,000-step pins made on the card (golden.GOLDEN), and the
# row groups G whose summation orders set those pins' bars.
GOLDEN_1K = ("reference-cube", "moving-container-256k")
ROW_GROUPS = (1, 2, 4)

# The domain step's parity bar against the single-device step, summed over
# the axes per particle (tests/test_domain.py:42).
DOMAIN_TOL = 1e-3

# H100 SXM peaks (NVIDIA's data sheet): f32 outside the tensor cores, HBM3.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12

# The front end's paths (chip_smoke's phases 9): each one's launches are
# counted from 0 over its own run.
FRONT_PATHS = ("cli run dam-break-2d-4k", "cli run reference-cube",
               "cli resume", "cli bench", "profile", "live",
               "viewer moving-container-256k", "viewer dam-break-2d-4k",
               "bench")

# The rescue budgets of the [rescue] count sweep: the cap-8 state's list
# cut to its first 64, 512 and 2,048 rows.
RESCUE_SWEEP = (64, 512, 2048)

# The parameter kernels (csrc/sph_coeffs.cu): the coefficients from the
# radius and the parameter vector, once a step (a shard) on the kernel
# pipeline.
PARAM_KERNELS = ("sph_coeffs", "sph_param_vector")

# The kernels every single-device step launches once.
STEP_KERNELS = PARAM_KERNELS + (
    "sph_build", "sph_density", "sph_force", "sph_rescue_density",
    "sph_rescue_force", "sph_integrate")

# The domain step's kernels beside K1 and K3: the cross-shard rescue's
# halves, each once a shard a step.
DOMAIN_KERNELS = ("sph_domain_rescue_density", "sph_domain_rescue_force")

# The golden phase's runs of the picker's order (each counted from 0).
GOLDEN_PATHS = tuple(f"golden {scene}" for scene in GOLDEN_1K)

# The bucket_grid step's runs, single-device ([bucket_grid]) and
# cell-slab-sharded ([gspmd]), each at the scene's capacity and at 8: its
# rescue is R1 and R2, gated on the device count.
GRID_PATHS = ("reference-cube bucket_grid", "reference-cube bucket_grid cap 8",
              "gspmd reference-cube", "gspmd reference-cube cap 8")

# The TPU kernels (K1-K4) and, for each, the wrapper's launch counter, the
# path whose launches and the call site whose time the summary reports, and
# the step paths it runs on (launches a step are read from each of their
# runs).
KERNELS = {
    "sph_density": dict(
        counter="sph_density", path="reference-cube",
        paths=("reference-cube", "moving-container-256k", "sharded-1m",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + FRONT_PATHS,
        at="reference-cube step 100",
        source="water_sandbox_tpu_torch/csrc/sph_density.cu",
        replaces="water_sandbox_tpu/ops/pallas/sph_bucket.py:571"),
    # the pair-once force of the single-device step (gate "qsym"), ported
    # with the query-side contract
    "sph_force": dict(
        counter="sph_force", path="reference-cube",
        paths=("reference-cube", "moving-container-256k",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + FRONT_PATHS,
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
    # the exact rescue's two halves, launched on every single-device step
    # and gated on the device count: no pallas_call in the JAX package
    # (XLA ops under lax.cond, ops/pallas/sph_bucket.py:1701, :1727)
    "sph_rescue_density": dict(
        counter="sph_rescue_density", path="reference-cube",
        paths=("reference-cube", "moving-container-256k",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + GRID_PATHS + FRONT_PATHS,
        at="reference-cube cap 8 step 100",
        source="water_sandbox_tpu_torch/csrc/sph_rescue.cu",
        replaces="water_sandbox_tpu/ops/rescue.py:61"),
    "sph_rescue_force": dict(
        counter="sph_rescue_force", path="reference-cube",
        paths=("reference-cube", "moving-container-256k",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + GRID_PATHS + FRONT_PATHS,
        at="reference-cube cap 8 step 100",
        source="water_sandbox_tpu_torch/csrc/sph_rescue.cu",
        replaces="water_sandbox_tpu/ops/rescue.py:116"),
    # the domain step's cross-shard rescue, launched once a shard on every
    # domain step and gated on the device count of the shard's query rows:
    # no pallas_call in the JAX package (XLA ops under lax.cond,
    # parallel/domain.py:382, :421, :459)
    "sph_domain_rescue_density": dict(
        counter="sph_domain_rescue_density", path="sharded-1m",
        paths=("sharded-1m",), at="sharded-1m forced rescue shard 1",
        source="water_sandbox_tpu_torch/csrc/sph_domain_rescue.cu",
        replaces="water_sandbox_tpu/parallel/domain.py:641"),
    "sph_domain_rescue_force": dict(
        counter="sph_domain_rescue_force", path="sharded-1m",
        paths=("sharded-1m",), at="sharded-1m forced rescue shard 1",
        source="water_sandbox_tpu_torch/csrc/sph_domain_rescue.cu",
        replaces="water_sandbox_tpu/parallel/domain.py:689"),
    # on no step path, as in the JAX package: its launches a step are read
    # from every step path's run all the same
    # the build after the sort (slot ranks, row gather, planes, counts):
    # no pallas_call in the JAX package (XLA ops, a cummax and the "stack"
    # scatter)
    "sph_build": dict(
        counter="sph_build", path="moving-container-256k",
        paths=("reference-cube", "moving-container-256k", "sharded-1m",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + FRONT_PATHS,
        at="moving-container-256k step 600",
        source="water_sandbox_tpu_torch/csrc/sph_build.cu",
        replaces="none: XLA ops, water_sandbox_tpu/ops/pallas/"
                 "sph_bucket.py:268"),
    # the integrate phase (field, velocity, speed clamp, box collision,
    # prediction): no pallas_call in the JAX package (XLA ops)
    "sph_integrate": dict(
        counter="sph_integrate", path="moving-container-256k",
        paths=("reference-cube", "moving-container-256k", "sharded-1m",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + GRID_PATHS + FRONT_PATHS,
        at="moving-container-256k step 600",
        source="water_sandbox_tpu_torch/csrc/sph_integrate.cu",
        replaces="none: XLA ops, water_sandbox_tpu/ops/integrate.py:167"),
    "bitonic_sort": dict(
        counter="bitonic_sort", path="argsort_keys",
        paths=("reference-cube", "moving-container-256k", "sharded-1m",
               "reference-cube incremental",
               "reference-cube incremental cap 8") + GOLDEN_PATHS
        + GRID_PATHS + FRONT_PATHS,
        at="sort n=65536",
        source="water_sandbox_tpu_torch/csrc/bitonic_sort.cu",
        replaces="water_sandbox_tpu/ops/pallas/bitonic_sort.py:55"),
}


def reset_launches() -> None:
    """The port's launch counts (``_build.LAUNCHES``) to 0."""
    from water_sandbox_tpu_torch.ops.cuda import _build
    _build.reset_launches()


def launches_now() -> dict:
    """A copy of the port's launch counts, by kernel."""
    from water_sandbox_tpu_torch.ops.cuda import _build
    return dict(_build.LAUNCHES)


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
    (all device work for ""), from torch.profiler (``profiling.traced``)
    over ``reps`` calls after one warm-up; None where the profiler records
    no device time."""
    from torch.profiler import ProfilerActivity
    from water_sandbox_tpu_torch.runtime.profiling import traced
    fn()
    with traced([ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
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
    planes, counts, flat = sb._build_core(
        state.predicted, state.vel, params, cfg, time=state.time)[:3]
    return planes, counts, flat, sb._param_vector(params, coeffs), cfg


def hold_and_time(label, record, planes, counts, addr, pv, cfg, h, dens_k,
                  dens_in, plain_reps=20, force_key="sph_force",
                  far_planes=None) -> None:
    """K1's output ``dens_k`` against density_plain, and the force kernel
    on ``dens_in`` against force_plain; their event and device times, the
    plain versions' event times, and the bounds from this input's pair
    counts. Where the wrappers put several threads on a row, each kernel
    with one thread a row too, checked and timed beside it. ``far_planes``:
    the position planes whose empty slots must hold the far fill (default
    all of them)."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    cap_p = sb._cap_pad(cfg.cell_capacity)
    occ = addr[addr < cap_p * sb._geometry(cfg).L].long()
    # K1 reads the empty slots of a run's lanes unpredicated: every position
    # slot at or above its lane's count must hold the build's far fill
    empty = torch.arange(cap_p, device=counts.device)[:, None] >= counts
    check(bool((planes[:far_planes or cfg.dim][:, empty] == sb._FAR).all()),
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
    if x is None:
        return "not measured"
    return str(x) if isinstance(x, int) else f"{x:.4f}"


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


def phase_rescue(state100, record) -> None:
    """reference-cube at cell_capacity 8 (forces overflow): one step on the
    kernel path against the same step on the plain path (CPU). At step 100
    about 5k particles overflow cap 8, past the scene's rescue budget of
    2048, so the budget is raised to keep every particle exact. Then the
    rescue's kernels at that state: R1 and R2 against their plain versions
    on the same CUDA tensors, two launches bit-identical, count 0 leaving
    den, nden, the density planes and acc bit-untouched, and their times
    at the state's count and at count 0."""
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
    rescue_kernels("reference-cube cap 8 step 100", cfg, params, state100,
                   record, sweep=RESCUE_SWEEP)


def rescue_bounds(pred, scol, rows, dropped, h, cfg):
    """Both bounds of R1 and R2 at one rescue selection, from this run's
    inputs: (sweep, walk, facts). ``rows``: the rescued rows, which on the
    sorted step are their positions.

    sweep: the all-pairs sweep's work, the yardstick of the kernels before
    the cell list: count x n distance tests (3*dim - 1 flops each), the
    pairs within h on both sides; bytes: every row's fields once. walk: the
    cell list's work: the candidate rows of the rescued rows' clamped
    3^dim neighbourhoods, tested once a side, and the same pairs within h;
    bytes: the rows in those neighbourhoods, each read once (and, for the
    residents among them, their outputs written once), the rescued list,
    the rescued rows' outputs."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    n, dim = pred.shape
    k = rows.numel()
    p_h = sum(int((torch.cdist(
        pred[rows[i:i + 256]], pred,
        compute_mode="donot_use_mm_for_euclid_dist") <= h).sum())
        for i in range(0, k, 256))
    lo, hi = rk.neighbour_runs(scol[rows], cfg)
    s64 = scol.long()
    valid = lo <= hi
    b = torch.where(valid, torch.searchsorted(s64, lo), 0).reshape(-1)
    e = torch.where(valid, torch.searchsorted(s64, hi + 1), 0).reshape(-1)
    cand = int((e - b).sum())
    delta = torch.zeros(n + 1, dtype=torch.int64, device=pred.device)
    delta.index_add_(0, b, torch.ones_like(b))
    delta.index_add_(0, e, -torch.ones_like(e))
    covered = torch.cumsum(delta, 0)[:n] > 0
    u = int(covered.sum())
    u_res = int((covered & ~dropped).sum())
    tests = k * n * (3 * dim - 1)
    walk_tests = 2 * cand * (3 * dim - 1)
    residents = n - int(dropped.sum())
    sweep = {
        # 7 flops a pair within h a side; reads pred, slot, den, nden, sel
        # and the residents' addresses, writes den, nden and 6 planes a
        # resident
        "sph_rescue_density": bound(
            tests + 2 * 7 * p_h,
            n * (4 * dim + 12) + 4 * k + n * 8 + residents * (4 + 24)),
        # 20 + 5*dim flops a pair within h a side; reads pred, vel, den,
        # nden, prs, nprs, slot, acc, sel, writes acc
        "sph_rescue_force": bound(
            tests + 2 * (20 + 5 * dim) * p_h,
            n * (8 * dim + 20) + 4 * k + n * 4 * dim * 2),
    }
    walk = {
        # a neighbourhood row: pred, slot, its column; a resident among
        # them: addr, den, nden read, den, nden and 6 planes written; a
        # rescued row: its list entry, den and nden written
        "sph_rescue_density": bound(
            walk_tests + 2 * 7 * p_h,
            u * (4 * dim + 8) + u_res * (4 + 8 + 8 + 24) + k * (4 + 8)),
        # a neighbourhood row: pred, vel, den, nden, prs, nprs, slot, its
        # column; a resident among them: acc read and written; a rescued
        # row: its list entry, acc written
        "sph_rescue_force": bound(
            walk_tests + 2 * (20 + 5 * dim) * p_h,
            u * (8 * dim + 24) + u_res * 8 * dim + k * (4 + 4 * dim)),
    }
    facts = dict(p_h=p_h, tests=tests, cand=cand, walk_rows=u)
    return sweep, walk, facts


def rescue_kernels(label, cfg, params, state, record, sweep=()) -> None:
    """R1 and R2 (csrc/sph_rescue.cu) against density_plain and
    force_plain at the sorted step's inputs of ``state``: K1's planes, the
    gathered densities, the rescue selection and its walk; R2 on R1's
    output and K2's accelerations. At the state's own budget, then at each
    budget of ``sweep`` on the same state (the first rows of the same
    list): held against the plain versions, two launches bit-identical,
    timed beside both bounds (rescue_bounds). At the state's budget also
    count 0 (den, nden, the planes and acc bit-untouched, and timed)."""
    from water_sandbox_tpu_torch.core.params import KernelCoeffs
    from water_sandbox_tpu_torch.ops import rescue as rescue_mod
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    cfg = cfg.resolved()
    dim, n = cfg.dim, state.n
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    pv = sb._param_vector(params, coeffs)
    planes, counts, flat, _, srows, overflow, scol = sb._build_core(
        state.predicted, state.vel, params, cfg, time=state.time)
    pred = srows[:, :dim].contiguous()
    vel = srows[:, dim:2 * dim].contiguous()
    PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    dropped = flat == PL
    dens = sb.run_density(planes, counts, flat, pv, cfg)
    den, nden = sb.gather_density(dens, flat, dropped, params)
    zero = torch.zeros((), dtype=torch.int32, device=flat.device)
    occ = flat[flat < PL].long()
    fresh = lambda: (den.clone(), nden.clone(), dens.clone())  # noqa: E731
    safe = torch.clamp_max(flat, PL - 1).long()

    for cap in (min(cfg.rescue_capacity, n),) + tuple(sweep):
        sel, slot, count = rescue_mod.rescue_selection(dropped, overflow,
                                                       cap)
        walk = rk.cell_walk(sel, count, scol)
        k = int(count)
        at = label if cap == min(cfg.rescue_capacity, n) else (
            f"{label} count {k}")

        def r1(out, c=count):
            rk.rescue_density(pred, sel, slot, c, flat, *out, params,
                              coeffs, pv, cfg, walk)

        def r1_plain(out):
            rk.density_plain(pred, sel, slot, count, flat, *out, params,
                             coeffs, cfg)

        got, again, want = fresh(), fresh(), fresh()
        r1(got)
        r1(again)
        r1_plain(want)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(got, again)),
              f"{at}: two launches of R1 differ")
        err_d = max(hold(f"{at} R1 {name}", g.cpu().numpy(),
                         w.cpu().numpy())
                    for name, g, w in zip(("den", "nden"), got, want))
        err_d = max(err_d, compare_planes(f"{at} R1 planes", got[2],
                                          want[2], occ))
        # R2 on R1's densities and the force pass over its planes
        acc = torch.where(dropped[:, None], 0.0, sb.run_force(
            planes, got[2], counts, flat, pv, cfg)[2:].reshape(dim, -1)[
            :, safe].T).contiguous()
        d, nd = got[0], got[1]
        prs = params.pressure_scalar * (d - params.target_density)
        nprs = params.near_pressure_scalar * nd

        def r2(a, c=count):
            rk.rescue_force(pred, vel, d, nd, prs, nprs, sel, slot, c, a,
                            params, coeffs, pv, cfg, walk)

        a_k, a_again, a_p = acc.clone(), acc.clone(), acc.clone()
        r2(a_k)
        r2(a_again)
        rk.force_plain(pred, vel, d, nd, prs, nprs, sel, slot, count, a_p,
                       params, coeffs, cfg)
        torch.cuda.synchronize()
        check(same_bits(a_k, a_again), f"{at}: two launches of R2 differ")
        err_f = hold(f"{at} R2 acc", a_k.cpu().numpy(), a_p.cpu().numpy())

        if at == label:
            zd, za = fresh(), acc.clone()
            r1(zd, zero)
            rk.rescue_force(pred, vel, den, nden, prs, nprs, sel, slot,
                            zero, za, params, coeffs, pv, cfg, walk)
            torch.cuda.synchronize()
            check(all(same_bits(a, b) for a, b in zip(zd, (den, nden, dens)))
                  and same_bits(za, acc),
                  f"{at}: count 0 changed den, nden, the planes or acc")

        bsweep, bwalk, facts = rescue_bounds(
            pred, scol, sel[:k].long(), dropped,
            float(params.smoothing_radius), cfg)
        scratch_d, scratch_a = fresh(), acc.clone()
        runs = {
            "sph_rescue_density": (err_d, lambda c=count: r1(scratch_d, c),
                                   lambda: r1_plain(fresh())),
            "sph_rescue_force": (err_f, lambda c=count: r2(scratch_a, c),
                                 lambda: rk.force_plain(
                                     pred, vel, d, nd, prs, nprs, sel, slot,
                                     count, acc.clone(), params, coeffs,
                                     cfg)),
        }
        for name, (err, launch, plain) in runs.items():
            kernel = name.replace("sph_", "") + "_kernel"
            rec = dict(max_abs_err=err, ms=cuda_ms(launch),
                       device_ms=device_ms(launch, kernel),
                       plain_ms=cuda_ms(plain, reps=5), library_ms=None,
                       count=k, **facts)
            if at == label:
                rec.update(ms_count0=cuda_ms(lambda: launch(zero)),
                           device_ms_count0=device_ms(lambda: launch(zero),
                                                      kernel))
            rec["bound_ms"], rec["bound_by"] = bwalk[name]
            rec["sweep_bound_ms"], rec["sweep_bound_by"] = bsweep[name]
            record.setdefault(name, {})[at] = rec
            zero_part = (
                f"; at count 0: kernel_ms={rec['ms_count0']:.4f} device_ms="
                f"{fmt(rec['device_ms_count0'])}" if at == label else "")
            log(f"[rescue] {at}: {name} at count {k} of {int(overflow)} "
                f"dropped: max_abs_err={err:.3e} kernel_ms={rec['ms']:.4f} "
                f"device_ms={fmt(rec['device_ms'])} plain_ms="
                f"{rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.3e} "
                f"({rec['bound_by']}; cell list: {facts['cand']} candidate "
                f"rows, {facts['walk_rows']} rows in the neighbourhoods) "
                f"sweep_bound_ms={rec['sweep_bound_ms']:.3e} "
                f"({rec['sweep_bound_by']}; {facts['tests']} distance-test "
                f"flops) library_ms=none{zero_part} (n {n}, pairs within h "
                f"of a rescued row {facts['p_h']})")


def recorded_builds(run) -> list:
    """The arguments of every ``build.run_build`` call ``run()`` makes,
    cloned, recorded by patching the wrapper around it."""
    from water_sandbox_tpu_torch.ops.cuda import build
    seen = []
    real = build.run_build

    def rec(*args):
        seen.append(tuple(tuple(b.clone() for b in a) if isinstance(a, tuple)
                          else a.clone() if isinstance(a, torch.Tensor)
                          else a for a in args))
        return real(*args)

    build.run_build = rec
    try:
        run()
    finally:
        build.run_build = real
    torch.cuda.synchronize()
    return seen


def build_args(state, params, cfg) -> tuple:
    """The inputs the sorted step hands the build after its sort
    (``build.run_build``), recorded around one eager step from ``state``:
    the carry is its two blocks, the positions and the bit-cast ids."""
    import water_sandbox_tpu_torch as wst
    seen = recorded_builds(lambda: wst.step(state, params, cfg))
    check(len(seen) == 1, f"build: the step called the build {len(seen)} "
          "times")
    check([b.shape[1] for b in seen[0][4]] == [cfg.dim, 1],
          f"build: carried blocks {[b.shape for b in seen[0][4]]}")
    return seen[0]


def build_bytes(args) -> int:
    """Bytes the build after the sort moves at least: the planes written
    whole, the rows read once and written sorted, the keys (4 B) and the
    permutation (8 B) read, the addresses and the order written (4 B
    each), the counts written."""
    _, _, pred, _, carry, _, cap_p, L, _, _ = args
    n, dim = pred.shape
    width = 2 * dim + sum(b.shape[1] for b in carry)
    return 4 * (2 * dim * cap_p * L + 2 * n * width + L) + 20 * n


def hold_build(label, args, record, note: str = "") -> None:
    """The build's kernel (csrc/sph_build.cu, with the wrapper's two plane
    fills and one memset) against the ATen chain (``build.build_plain``) on
    ``args``: bit for bit on all six outputs, one launch a call; event ms
    and profiler device ms of the whole build after the sort and of the
    kernel alone, the plain chain's, the bound from the bytes."""
    from water_sandbox_tpu_torch.ops.cuda import build
    reset_launches()
    got = build.run_build(*args)
    want = build.build_plain(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in launches_now().items() if v}
    check(launched == {"sph_build": 1}, f"build {label}: launches {launched}")
    for name, a, b in zip(("planes", "counts", "flat", "order", "srows",
                           "overflow"), got, want):
        check(same_bits(a, b), f"build {label}: {name} differs from the "
              "plain chain")
    nbytes = build_bytes(args)
    b_ms, b_by = bound(0, nbytes)

    def run():
        return build.run_build(*args)

    def plain():
        return build.build_plain(*args)

    rec = dict(max_abs_err=0.0, ms=cuda_ms(run),
               device_ms=device_ms(run, "sph_build_kernel"),
               all_device_ms=device_ms(run, ""), plain_ms=cuda_ms(plain),
               plain_device_ms=device_ms(plain, ""), bound_ms=b_ms,
               bound_by=b_by)
    log(f"[build] {label}: bit-identical to the plain chain, 1 launch; "
        f"kernel_ms (fills + kernel)={rec['ms']:.4f} device_ms (kernel)="
        f"{fmt(rec['device_ms'])} device_ms (fills + kernel)="
        f"{fmt(rec['all_device_ms'])} plain_ms={rec['plain_ms']:.4f} "
        f"its device_ms={fmt(rec['plain_device_ms'])} bound_ms="
        f"{b_ms:.3e} ({b_by}: {nbytes} B) library_ms=none (n "
        f"{args[2].shape[0]}, overflow {int(got[5])}{note})")
    record.setdefault("sph_build", {})[label] = rec


def phase_build(record, cfg, params, state100) -> None:
    """The build's kernel against the ATen chain (``hold_build``) at
    reference-cube step 100 and the flagship's step 600, with the sorted
    step's carry and no key bound."""
    import water_sandbox_tpu_torch as wst
    cfg3, params3, state3 = wst.scenes.build("moving-container-256k",
                                             device="cuda")
    state3 = wst.rollout(state3, params3, cfg3, 600)
    for label, c, prm, st in (
            ("reference-cube step 100", cfg, params, state100),
            ("moving-container-256k step 600", cfg3, params3, state3)):
        hold_build(label, build_args(st, prm, c), record)


def domain_build_vs_plain(sim, shard: int, record) -> None:
    """The build's kernel against the ATen chain (``hold_build``) on the
    arguments one eager domain step hands ``build.run_build`` for
    ``shard`` (``sph_bucket.build_local_slab_buckets``): the shard's key
    bound end = gx_loc·S_pad, its inactive rows keyed at end and sorted
    last, where they take no slot and are no overflow."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.parallel import domain
    nsh = sim.mesh.size
    seen = recorded_builds(lambda: sim.graph.step(
        [s.clone() for s in sim.states], [a.clone() for a in sim.active],
        sim.params))
    check(len(seen) == nsh, f"{sim.name}: the domain step called the build "
          f"{len(seen)} times on {nsh} shards")
    args = seen[shard]
    gx_loc = sim.cfg.grid_dims[0] // nsh
    end = gx_loc * sb._geometry(domain._local_cfg(sim.cfg, gx_loc)).S_pad
    at_end = int((args[0] == end).sum())
    inactive = int((sim.active[shard] <= 0).sum())
    check(args[9] == end and at_end == inactive > 0,
          f"{sim.name} shard {shard}: key bound {args[9]} (end {end}), "
          f"{at_end} rows keyed at it, {inactive} inactive rows")
    hold_build(f"{sim.name} shard {shard} (domain step)", args, record,
               note=f", key bound {end}, {at_end} inactive rows keyed at it")


def integrate_args(state, params, cfg) -> tuple:
    """The inputs the sorted step hands the integrate (pos and vel, column
    slices of the build's sorted rows; acc, the results' gather; params;
    t_new), recorded by patching ``ops/integrate.py::integrate`` around one
    eager step from ``state``: held as they were passed, strides and all."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops import integrate as integ
    seen = []
    real = integ.integrate

    def rec(*args):
        seen.append(args)
        return real(*args)

    integ.integrate = rec
    try:
        wst.step(state, params, cfg)
    finally:
        integ.integrate = real
    check(len(seen) == 1, f"integrate: the step called it {len(seen)} times")
    check(not (seen[0][0].is_contiguous() or seen[0][1].is_contiguous()),
          "integrate: the sorted step's pos and vel are not strided slices")
    return seen[0]


def kernels_per_call(fn, reps: int = 10) -> int:
    """Device kernels a call of ``fn`` launches, from torch.profiler over
    ``reps`` calls (a later profiler session of a process can lose 1-3
    device events, so one call's count is not to be trusted)."""
    from torch.autograd import DeviceType
    from water_sandbox_tpu_torch.runtime.profiling import traced
    fn()
    with traced() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return round(sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA) / reps)


def phase_integrate(record, cfg, params, state100) -> None:
    """The integrate kernel (csrc/sph_integrate.cu) against the ATen chain
    (``integrate_plain``) at reference-cube step 100 and the flagship's
    step 600, on the sorted step's own call (strided rows): bit for bit on
    pos, vel and predicted, one launch a call; event ms and profiler device
    ms of the kernel and of the chain, the device kernels a call of each,
    the bound from the bytes (a row reads pos, vel, acc and writes pos,
    vel, predicted: 18 f32 in 3-D), and the launches a replay of the
    scene's captured step. Then the 1,000 steps of each scene's card pin
    (golden.run) with the kernel against the same steps with the chain
    patched in: every state field bit for bit."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch import golden
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops import integrate as integ
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.ops.cuda import integrate as ik
    cfg3, params3, state3 = wst.scenes.build("moving-container-256k",
                                             device="cuda")
    state3 = wst.rollout(state3, params3, cfg3, 600)
    for label, c, prm, st in (
            ("reference-cube step 100", cfg, params, state100),
            ("moving-container-256k step 600", cfg3, params3, state3)):
        args = integrate_args(st, prm, c)
        reset_launches()
        got = ik.run_integrate(*args)
        want = integ.integrate_plain(*args)
        torch.cuda.synchronize()
        launched = {k: v for k, v in launches_now().items() if v}
        check(launched == {"sph_integrate": 1},
              f"integrate {label}: launches {launched}")
        for name, a, b in zip(("pos", "vel", "predicted"), got, want):
            check(same_bits(a, b), f"integrate {label}: {name} differs from "
                  "the ATen chain")
        n, dim = args[0].shape
        nbytes = 4 * 6 * dim * n
        b_ms, b_by = bound(0, nbytes)

        def run():
            return ik.run_integrate(*args)

        def plain():
            return integ.integrate_plain(*args)

        g = graph_mod.StepGraph(st.clone(), _map_tensors(prm, torch.clone),
                                c.resolved())
        g.capture()
        check(g.per_replay.get("sph_integrate") == 1,
              f"integrate {label}: launches a replay {g.per_replay}")
        del g
        rec = dict(max_abs_err=0.0, ms=cuda_ms(run),
                   device_ms=device_ms(run, "sph_integrate_kernel"),
                   plain_ms=cuda_ms(plain),
                   plain_device_ms=device_ms(plain, ""), bound_ms=b_ms,
                   bound_by=b_by, kernels=kernels_per_call(run),
                   plain_kernels=kernels_per_call(plain))
        log(f"[integrate] {label}: bit-identical to the ATen chain, 1 "
            f"launch; kernel_ms={rec['ms']:.4f} device_ms="
            f"{fmt(rec['device_ms'])} plain_ms={rec['plain_ms']:.4f} its "
            f"device_ms={fmt(rec['plain_device_ms'])} device kernels a call "
            f"{rec['kernels']} (the chain's {rec['plain_kernels']}) bound_ms="
            f"{b_ms:.3e} ({b_by}: {nbytes} B, 18 f32 a row in 3-D) "
            f"library_ms=none (n {n}, strides pos {args[0].stride()} vel "
            f"{args[1].stride()} acc {args[2].stride()}); the captured "
            f"step launches sph_integrate once a replay")
        record.setdefault("sph_integrate", {})[label] = rec
    del state3
    for scene in GOLDEN_1K:
        key = (scene, "pallas", 1000)
        t0 = time.perf_counter()
        _, _, kernel = golden.run(*key, device="cuda")
        saved = integ.integrate
        integ.integrate = integ.integrate_plain
        try:
            _, _, chain = golden.run(*key, device="cuda")
        finally:
            integ.integrate = saved
        same = all(same_bits(getattr(kernel, f.name), getattr(chain, f.name))
                   for f in dataclasses.fields(kernel))
        log(f"[integrate] {scene} 1000 steps (golden.run) with the kernel "
            f"and with the ATen chain: {'bit for bit' if same else 'differ'}"
            f" ({time.perf_counter() - t0:.1f} s)")
        check(same, f"integrate {scene}: 1000 steps differ from the chain's")


def phase_params(record) -> None:
    """The parameter kernels (csrc/sph_coeffs.cu) against their ATen
    chains (``coeffs_plain``, ``param_vector_plain``) on both cells'
    scenes' own parameters: bit for bit on the five coefficients and the
    (1, 16) vector, one launch of each a call; event ms and profiler
    device ms of each kernel alone and of each chain, the device kernels a
    call of each, the bound from the bytes; the launches a replay of each
    scene's captured step."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import (KernelCoeffs,
                                                     _map_tensors,
                                                     coeffs_plain)
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    for scene in ("reference-cube", "moving-container-256k"):
        cfg, params, state = wst.scenes.build(scene, device="cuda")
        h, dim = params.smoothing_radius, cfg.dim
        reset_launches()
        got = KernelCoeffs.from_radius(h, dim)
        pv = sb._param_vector(params, got)
        torch.cuda.synchronize()
        launched = {k: v for k, v in launches_now().items() if v}
        check(launched == {k: 1 for k in PARAM_KERNELS},
              f"params {scene}: launches {launched}")
        want = coeffs_plain(h, dim)
        fields = [f.name for f in dataclasses.fields(KernelCoeffs)]
        check(all(same_bits(getattr(got, f), getattr(want, f))
                  for f in fields)
              and same_bits(pv, sb.param_vector_plain(params, want)),
              f"params {scene}: the kernels differ from the ATen chains")
        calls = {
            "sph_coeffs": (lambda: KernelCoeffs.from_radius(h, dim),
                           lambda: coeffs_plain(h, dim), 4 + 4 * 5),
            "sph_param_vector": (
                lambda: sb._param_vector(params, got),
                lambda: sb.param_vector_plain(params, want), 4 * (10 + 16))}
        for name, (run, plain, nbytes) in calls.items():
            b_ms, b_by = bound(0, nbytes)
            rec = dict(max_abs_err=0.0, ms=cuda_ms(run),
                       device_ms=device_ms(run, name + "_kernel"),
                       plain_ms=cuda_ms(plain),
                       plain_device_ms=device_ms(plain, ""), bound_ms=b_ms,
                       bound_by=b_by, kernels=kernels_per_call(run),
                       plain_kernels=kernels_per_call(plain))
            log(f"[params] {scene} {name}: bit-identical to the ATen chain "
                f"(h {float(h)!r}, dim {dim}), 1 launch; kernel_ms="
                f"{rec['ms']:.4f} device_ms={fmt(rec['device_ms'])} "
                f"plain_ms={rec['plain_ms']:.4f} its device_ms="
                f"{fmt(rec['plain_device_ms'])} device kernels a call "
                f"{rec['kernels']} (the chain's {rec['plain_kernels']}) "
                f"bound_ms={b_ms:.3e} ({b_by}: {nbytes} B)")
            record.setdefault(name, {})[scene] = rec
        g = graph_mod.StepGraph(state.clone(),
                                _map_tensors(params, torch.clone),
                                cfg.resolved())
        g.capture()
        check(all(g.per_replay.get(k) == 1 for k in PARAM_KERNELS),
              f"params {scene}: launches a replay {g.per_replay}")
        log(f"[params] {scene}: launches a replay of the captured step "
            f"{g.per_replay}")
        del g


# Both cells' scenes through the public runtime only (so it runs in an
# older checkout too): Simulation.run(100) from the scene's start (the
# captured step), every state field saved to the npz of argv[1]. Prints
# each scene's launches a replay.
STATES100 = """
import dataclasses, json, sys
import numpy as np
import torch
import water_sandbox_tpu_torch as wst
out, saved = {}, {}
for scene in ("reference-cube", "moving-container-256k"):
    sim = wst.Simulation.from_scene(scene)
    sim.run(100)
    torch.cuda.synchronize()
    out[scene] = dict(sim.graph.per_replay)
    for f in dataclasses.fields(sim.state):
        saved[scene + "__" + f.name] = getattr(sim.state, f.name).cpu().numpy()
np.savez(sys.argv[1], **saved)
print(json.dumps(out))
"""


def params_against(other: Path) -> int:
    """``--params DIR``: [params] (``phase_params``), then both cells'
    scenes after 100 captured steps (STATES100) in DIR and in this tree,
    as subprocesses in the order DIR, this tree, this tree, DIR: every
    state field of every run bit for bit against the first DIR run's, and
    the launches a replay of each."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from water_sandbox_tpu_torch.ops.cuda import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    other = other.resolve()
    check((other / "water_sandbox_tpu_torch").is_dir(),
          f"--params {other}: no port there")
    built = _build.build()
    for line in (built.path / "sph_coeffs.nvcc.log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    phase_params({})
    FRONT_OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (label, tree) in enumerate((("parent", other), ("change", ROOT),
                                       ("change", ROOT), ("parent", other))):
        npz = FRONT_OUT / f"params_{i}_{label}.npz"
        out = subprocess.run([sys.executable, "-c", STATES100, str(npz)],
                             cwd=tree, capture_output=True, text=True,
                             env=_front_env(), timeout=600)
        if out.returncode != 0:
            log(out.stderr[-3000:])
        check(out.returncode == 0, f"--params {label}: exit {out.returncode}")
        per_replay = json.loads(out.stdout.strip().splitlines()[-1])
        log(f"[params] {label} ({tree}): launches a replay {per_replay}")
        runs.append((label, dict(np.load(npz))))
    base_label, base = runs[0]
    for label, got in runs[1:]:
        check(sorted(got) == sorted(base) and len(base) == 26,
              f"--params {label}: fields {sorted(got)}")
        for scene in ("reference-cube", "moving-container-256k"):
            keys = [k for k in base if k.startswith(scene + "__")]
            same = all(base[k].dtype == got[k].dtype
                       and base[k].tobytes() == got[k].tobytes()
                       for k in keys)
            log(f"[params] {label} against the first {base_label}: {scene}, "
                f"{len(keys)} state fields after 100 captured steps "
                f"{'bit for bit' if same else 'differ'}")
            check(same, f"--params {label}: {scene} after 100 steps differs "
                  f"from the first {base_label} run's")
    log(smi)
    log(json.dumps({"ok": True}))
    return 0


def phase_rescue_flagship(cfg, params, state, record) -> None:
    """The flagship past its own rescue budget (16,384): the highest cell
    capacity below the scene's that overflows more rows than the budget,
    then R1 and R2 held against their plain versions there and timed
    (rescue_kernels: count == budget, beyond-budget rows excluded)."""
    import dataclasses
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    for cap in (8, 6, 4, 3, 2):
        c = dataclasses.replace(cfg, cell_capacity=cap)
        raw = int(sb._build_core(state.predicted, state.vel, params,
                                 c.resolved(), time=state.time)[5])
        if raw > cfg.rescue_capacity:
            break
    log(f"[rescue] moving-container-256k step 10 at cell capacity {cap}: "
        f"{raw} rows overflow, budget {cfg.rescue_capacity}")
    check(raw > cfg.rescue_capacity,
          "the flagship must overflow past its budget")
    rescue_kernels(f"moving-container-256k cap {cap} step 10", c, params,
                   state, record)


def phase_golden():
    """The JAX package's ("mini-3d", "pallas", 60) pin on the kernels, and
    the planted physics bug (golden.flipped_near_derivative) tripping it;
    returns the scene's config, parameters and its state at step 60."""
    from water_sandbox_tpu_torch import golden
    key = ("mini-3d", "pallas", 60)
    pin = golden.JAX_GOLDEN[key]
    cfg, params, s = golden.run(*key, device="cuda", **pin["kw"])
    got = golden.summarize(s)
    tripped = golden.check(got, pin)
    check(tripped == [], f"golden mini-3d: tripped {tripped}")
    with golden.flipped_near_derivative():
        flipped = golden.check(golden.stats(*key, device="cuda",
                                            **pin["kw"]), pin)
    check(bool(set(flipped) - {"overflow_total"}),
          f"golden mini-3d: the flipped run tripped {flipped}")
    log(f"[golden] mini-3d 60 steps on the kernels: the JAX package's pin "
        f"met, worst statistic at {max(golden.margins(got, pin).values()):.3f}"
        f" of its bar (ke {got['ke']:.2f}, mean_rho {got['mean_rho']:.4f}); "
        f"pow3_der flipped trips {flipped}")
    return cfg, params, s


@contextlib.contextmanager
def row_group(group: int):
    """Every launch of the density and force kernels with ``group`` threads
    a row while open: each row's lanes split G ways and the partial sums
    joined by warp shuffles, another summation order of the same pairs."""
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    orig = sb._row_group
    sb._row_group = lambda n, sms: group
    try:
        yield
    finally:
        sb._row_group = orig


def spreads(runs) -> dict:
    """Per statistic, the largest difference between two of ``runs`` (stats
    dicts) over its elements."""
    from water_sandbox_tpu_torch import golden
    out = {}
    for key in golden.BARS:
        v = np.array([np.atleast_1d(np.asarray(r[key], np.float64))
                      for r in runs])
        out[key] = float((v.max(axis=0) - v.min(axis=0)).max())
    return out


def rounded(margins: dict) -> dict:
    return {k: round(v, 3) for k, v in margins.items()}


@contextlib.contextmanager
def plain_rescue():
    """While open, the step's rescue runs its plain versions (ops/cuda/
    rescue.py::density_plain, force_plain) on the card's tensors instead of
    the kernels: another summation order of the same pairs. Eager only: it
    reads the rescued count on the host, skips the halves at count 0 as the
    kernels do, and sweeps the first count slots of the rescued list."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    saved = rk.rescue_density, rk.rescue_force

    def density(predicted, sel, slot, count, addr, den, nden, dens, params,
                coeffs, params_vec, cfg, walk):
        k = int(count)
        if k:
            rk.density_plain(predicted, sel[:k], slot, count, addr, den,
                             nden, dens, params, coeffs, cfg)

    def force(predicted, vel, den, nden, prs, nprs, sel, slot, count, acc,
              params, coeffs, params_vec, cfg, walk):
        k = int(count)
        if k:
            rk.force_plain(predicted, vel, den, nden, prs, nprs, sel[:k],
                           slot, count, acc, params, coeffs, cfg)

    rk.rescue_density, rk.rescue_force = density, force
    try:
        yield
    finally:
        rk.rescue_density, rk.rescue_force = saved


def phase_golden_1k(scene: str, paths: dict, steps: int = 1000) -> None:
    """``steps`` steps of ``scene`` in the kernel pipeline, through
    golden.run (the captured step, one graph a run, captured under the
    run's own context), against the port's pin made on the card: the
    picker's row group, then G = 1, 2 and 4 forced (three summation
    orders, which must differ from one another; the one the picker takes
    must repeat the first run bit for bit), then the eager step with the
    rescue's plain versions at the picker's G (a fourth order), then the
    planted physics bug. Every run prints its statistics before any check
    fails."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch import golden
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    key = (scene, "pallas", steps)
    pin = golden.GOLDEN.get(key)
    t_phase = time.perf_counter()

    def run(label):
        t0 = time.perf_counter()
        _, _, s = golden.run(*key, device="cuda")
        got = golden.summarize(s)
        log(f"[golden] {scene} {steps} steps, {label}: {json.dumps(got)} "
            f"({time.perf_counter() - t0:.1f} s)")
        return s, got

    reset_launches()
    first, picked = run("the picker's order")
    launches = launches_now()
    paths[f"golden {scene}"] = (launches, steps)
    group = sb._row_group(first.n, sb._sm_count(0))
    orders, states, same = {}, {}, False
    for g in ROW_GROUPS:
        with row_group(g):
            states[g], orders[g] = run(f"G = {g}")
        if g == group:
            same = same_state(states[g], first)
    differ = all(not torch.equal(states[a].pos, states[b].pos)
                 for a in ROW_GROUPS for b in ROW_GROUPS if a < b)
    del states

    t0 = time.perf_counter()
    cfg, params, s = wst.scenes.build(scene, device="cuda")
    with plain_rescue():
        for _ in range(steps):
            s = wst.step(s, params, cfg)
    orders["plain rescue"] = golden.summarize(s)
    log(f"[golden] {scene} {steps} steps, the eager step with the plain "
        f"rescue (G = {group}): {json.dumps(orders['plain rescue'])} "
        f"({time.perf_counter() - t0:.1f} s)")
    del s
    spread_g = spreads([orders[g] for g in ROW_GROUPS])
    spread = spreads(orders.values())
    log(f"[golden] {scene}: spread over G = 1, 2, 4 {json.dumps(spread_g)}; "
        f"over G = 1, 2, 4 and the plain rescue {json.dumps(spread)}; 2x "
        f"that {json.dumps({k: 2 * v for k, v in spread.items()})}")
    with golden.flipped_near_derivative():
        _, flipped = run("pow3_der flipped")
    jax_pin = golden.JAX_GOLDEN[key]
    log(f"[golden] {scene} beside the JAX package's TPU pin (information "
        f"only): tripped {golden.check(picked, jax_pin)}, margins "
        f"{json.dumps(rounded(golden.margins(picked, jax_pin)))}")

    check(pin is not None, f"golden {scene}: no pin for {key}")
    check_launches(f"golden {scene}", launches, steps)
    check(same, f"golden {scene}: two runs of G = {group} differ")
    check(differ, f"golden {scene}: the runs of G = 1, 2, 4 do not all "
          "differ (a graph replayed another context's step)")
    tripped = golden.check(picked, pin)
    margins = golden.margins(picked, pin)
    log(f"[golden] {scene}: the picker's order (G = {group}) against the pin "
        f"made on {pin['made_on']}: tripped {tripped}, margins "
        f"{json.dumps(rounded(margins))}, worst {max(margins.values())!r}")
    check(tripped == [], f"golden {scene}: the picker's order tripped "
          f"{tripped}")
    for g, got in orders.items():
        tripped = golden.check(got, pin)
        log(f"[golden] {scene}: {g if isinstance(g, str) else f'G = {g}'} "
            f"against the pin's bars: tripped {tripped}, worst margin "
            f"{max(golden.margins(got, pin).values()):.3f}")
        check(tripped == [], f"golden {scene}: {g} tripped {tripped}")
    tripped = golden.check(flipped, pin)
    log(f"[golden] {scene}: pow3_der flipped trips {tripped} "
        f"(overflow_total {flipped['overflow_total']})")
    check(bool(set(tripped) - {"overflow_total"}),
          f"golden {scene}: the flipped run tripped no statistic")
    log(f"[golden] {scene}: launches {launches}, two runs of G = {group} "
        f"bit-identical, G = 1, 2, 4 all different, phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def hold(name, got, want, rtol=RTOL) -> float:
    """|got - want| <= rtol·|want| + rtol·max(1, max|want|) elementwise on
    two numpy arrays; returns the max error, raises past the bar."""
    err = np.abs(got - want)
    bar = rtol * np.abs(want) + rtol * max(
        1.0, float(np.abs(want).max(initial=0.0)))
    check(bool(np.isfinite(got).all()), f"{name}: non-finite")
    check(bool((err <= bar).all()),
          f"{name}: max err {float(err.max(initial=0.0)):.3e} past the bar")
    return float(err.max(initial=0.0))


def captured_step(state, params, cfg):
    """One replay of a StepGraph of ``cfg``'s step over copies of
    ``state``: the step as rollout and Simulation.run run it."""
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    g = graph_mod.StepGraph(state.clone(), params, cfg)
    g.run(1)
    torch.cuda.synchronize()
    check(g.graph is not None, f"{cfg.neighbor_mode}: no graph captured")
    return g.state


def phase_oracle(cfg, params, state) -> None:
    """mini-3d on the card, from its compressed state at step 60: one step
    of the dense oracle against one step of the kernel pipeline (density,
    near density and acceleration by particle id, the 2e-4 bar of the JAX
    package's test_pallas_matches_xla_bucket), and hash_grid, on a table
    small enough to collide, against the oracle weighted by
    reference_pair_weights (tests/test_grid.py's parity). Each step runs
    eagerly and as one replay of its captured graph (the two bit for bit),
    and the captured steps meet the same bars."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import KernelCoeffs
    from water_sandbox_tpu_torch.ops import dense, grid, hashing
    cfg_d = dataclasses.replace(cfg, neighbor_mode="dense")
    s_k = wst.step(state, params, cfg)
    s_d = wst.step(state, params, cfg_d)
    c_k = captured_step(state, params, cfg)
    c_d = captured_step(state, params, cfg_d)
    check(same_state(c_k, s_k) and same_state(c_d, s_d)
          and same_bits(c_d.acc, s_d.acc),
          "oracle phase: a captured step differs from the eager one")
    check(int(s_k.overflow) == 0, "oracle phase: the kernel step overflowed")
    worst = max(hold(f"kernel pipeline vs dense oracle, {f}", by_id(a, f),
                     by_id(b, f))
                for a, b in ((s_k, s_d), (c_k, c_d))
                for f in ("density", "near_density", "acc"))
    check(float(s_d.acc.abs().max()) > 1.0, "oracle phase: no pair forces")
    log(f"[oracle] mini-3d step 61: kernel pipeline vs dense oracle by id, "
        f"eager and captured (each captured = its eager step bit for bit), "
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
    c_h = captured_step(state, params, cfg_h)
    stepped = (c_h.density, c_h.near_density, c_h.pressure,
               c_h.near_pressure, c_h.acc)
    check(int(got[5]) == 0 and int(c_h.overflow) == 0,
          "oracle phase: a hash run was truncated")
    check(int(w.max()) > 1, "oracle phase: no hash collision to multi-count")
    worst = max(hold(f"hash_grid vs weighted oracle, {name}",
                     g.cpu().numpy(), x.cpu().numpy())
                for out in (got, stepped)
                for name, g, x in zip(("den", "nden", "prs", "nprs", "acc"),
                                      out, want))
    check(all(same_bits(a, b) for a, b in zip(stepped, got)),
          "oracle phase: the captured hash_grid step differs from hash_sph")
    log(f"[oracle] mini-3d step 60: hash_grid vs dense oracle with "
        f"reference_pair_weights (table {cfg_h.table_size}, max weight "
        f"{int(w.max())}), hash_sph and one captured step (bit for bit the "
        f"same), max_abs_err={worst:.3e}")


def alternate(eager, captured, pairs: int = 3, steps: int = 5) -> tuple:
    """ms/step of ``pairs`` alternated windows of ``steps`` steps each:
    ``eager(steps)`` then ``captured(steps)``, synced, on the host clock.
    Returns (eager ms list, captured ms list)."""
    out = ([], [])
    for _ in range(pairs):
        for fn, ms in zip((eager, captured), out):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(steps)
            torch.cuda.synchronize()
            ms.append(round(1e3 * (time.perf_counter() - t0) / steps, 3))
    return out


def grid_launches(label: str, paths: dict, launches: dict, steps: int,
                  fired: bool, shards: int = 1) -> None:
    """A bucket_grid path's launches: R1 and R2 once a step (their gate
    decides on the device whether they work) with the parameter vector
    they read, the integrate and coefficient kernels once a shard a step,
    no other kernel; recorded as ``paths[label]``."""
    check(launches.get("sph_rescue_density") == steps
          and launches.get("sph_rescue_force") == steps
          and launches.get("sph_param_vector") == steps
          and launches.get("sph_integrate") == shards * steps
          and launches.get("sph_coeffs") == shards * steps
          and sum(launches.values()) == (3 + 2 * shards) * steps,
          f"{label}: launches {launches} over {steps} steps")
    check(fired, f"{label}: no row was rescued")
    paths[label] = (launches, steps)


def phase_bucket_grid(state100, paths: dict, steps: int = 10):
    """reference-cube at full width with neighbor_mode="bucket_grid"
    (particle-order rows, the plain pair-block passes of ops/grid.py, the
    rescue R1/R2) from the step-100 state: the eager step, its first step
    under ``torch.cuda.set_sync_debug_mode("error")``; ``steps`` steps of
    the captured step (a StepGraph) against them bit for bit, with R1 and
    R2 launched once a step; against the kernel pipeline by particle id,
    every particle exact; ms/step eager and captured alternated; the same
    path at cell capacity 8, where R1 and R2 rescue rows on every step.
    Returns the eager state after ``steps`` steps."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops import grid
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    cfg_k, params, _ = wst.scenes.build("reference-cube", device="cuda")
    cfg_b = dataclasses.replace(cfg_k, neighbor_mode="bucket_grid",
                                sorted_state=False)
    base = float(state100.overflow_total)
    s_k = wst.rollout(state100, params, cfg_k, steps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_b = wst.step(state100, params, cfg_b)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(steps - 1):
        s_b = wst.step(s_b, params, cfg_b)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    g = graph_mod.StepGraph(state100.clone(), params, cfg_b)
    g.run(steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grid_launches("reference-cube bucket_grid", paths, launches_now(), steps,
                  True)
    check(same_state(g.state, s_b) and same_bits(g.state.acc, s_b.acc),
          "bucket_grid phase: captured != eager")
    check(float(s_b.overflow_total) == base
          and float(s_k.overflow_total) == base,
          "bucket_grid phase: overflow_total grew")
    err = float(np.abs(by_id(s_b, "pos") - by_id(s_k, "pos"))
                .sum(axis=1).max())
    check(err <= DOMAIN_TOL, f"bucket_grid phase: parity {err:.3e}")
    state = {"eager": s_b}

    def eager(k):
        for _ in range(k):
            state["eager"] = wst.step(state["eager"], params, cfg_b)

    ms_e, ms_c = alternate(eager, g.run)
    log(f"[bucket_grid] reference-cube from step 100: {steps} steps, "
        f"n={s_b.n}, eager step under sync debug \"error\", captured = eager "
        f"bit for bit, ms/step eager {ms_e} captured {ms_c} (host clock, "
        f"alternated windows of 5 steps), capture {g.capture_s:.2f} s, "
        f"peak memory {peak:.2f} GiB, overflow_total "
        f"{float(s_b.overflow_total) - base}, max |dpos| by id vs the kernel "
        f"pipeline {err:.3e}, launches {paths['reference-cube bucket_grid'][0]}")

    cfg8 = dataclasses.replace(cfg_b, cell_capacity=8)
    raw = int(grid.build_bucket_grid(state100.predicted, state100.vel,
                                     params, cfg8).overflow)
    reset_launches()
    g8 = graph_mod.StepGraph(state100.clone(), params, cfg8)
    g8.run(steps)
    torch.cuda.synchronize()
    grown = float(g8.state.overflow_total) - base
    # every step rescues min(dropped, budget) rows: the total grows by the
    # rows beyond the budget only
    grid_launches("reference-cube bucket_grid cap 8", paths, launches_now(),
                  steps, raw > 0 and grown < raw * steps)
    check(bool(torch.isfinite(g8.state.pos).all()),
          "bucket_grid cap 8: non-finite positions")
    log(f"[bucket_grid] cell capacity 8: {raw} rows dropped at step 100, "
        f"budget {cfg8.rescue_capacity}, overflow_total +{grown} over "
        f"{steps} captured steps, launches "
        f"{paths['reference-cube bucket_grid cap 8'][0]}")
    return s_b


@contextlib.contextmanager
def recording_rescue():
    """R1's and R2's wrappers patched to keep a copy of every call's inputs
    before they run as before; yields {"density": [...], "force": [...]}."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    calls = {"density": [], "force": []}
    real = {"density": rk.rescue_density, "force": rk.rescue_force}

    def recorder(half):
        def rec(*args):
            calls[half].append(clone_args(args))
            real[half](*args)
        return rec

    rk.rescue_density = recorder("density")
    rk.rescue_force = recorder("force")
    try:
        yield calls
    finally:
        rk.rescue_density = real["density"]
        rk.rescue_force = real["force"]


def hold_rescue(label, calls) -> dict:
    """R1 and R2 against their plain versions on each recorded call: R1's
    den and nden, R2's acc at ``hold``'s bar, two launches bit-identical,
    the rescue firing. Returns the worst |kernel - plain| of each."""
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    err = {}
    # the wrapper, its plain version's arguments (the wrapper's without
    # params_vec and walk), the count's and the outputs' positions
    halves = {"density": (rk.rescue_density, rk.density_plain,
                          lambda a: a[:10] + [a[11]], 3, (5, 6)),
              "force": (rk.rescue_force, rk.force_plain,
                        lambda a: a[:12] + [a[13]], 8, (9,))}
    for half, (fn, plain, plain_args, at_count, outs) in halves.items():
        name = f"sph_rescue_{half}"
        check(len(calls[half]) == 1, f"{label}: {name} calls {calls[half]}")
        for args in calls[half]:
            k, again, want = (clone_args(args) for _ in range(3))
            fn(*k)
            fn(*again)
            plain(*plain_args(want))
            torch.cuda.synchronize()
            check(int(args[at_count]) > 0, f"{label}: {name} rescued no row")
            for j in outs:
                check(same_bits(k[j], again[j]),
                      f"{label}: two launches of {name} differ")
                err[name] = max(err.get(name, 0.0), hold(
                    f"{label} {name} output {j}", k[j].cpu().numpy(),
                    want[j].cpu().numpy()))
    return err


def phase_gspmd(state100, single, record, paths: dict, shards: int = 4,
                steps: int = 10) -> None:
    """The cell-slab-sharded bucket_grid step (parallel/gspmd.py) on
    ``shards`` shards of the card: reference-cube (65,536 particles, grid
    (68, 40, 40), cell capacity 24, rescue 2,048) from the step-100 state.
    Each slab's planes bit for bit against the single-device build; the
    eager step (its first under sync debug "error", with the bytes each
    collective moves) over ``steps`` steps against the single-device
    bucket_grid step (``single``) row by row at tests/test_parallel.py's
    bars, with overflow_total not growing; the captured step (a
    ShardedGraph) against the eager one bit for bit, launches counted;
    ms/step eager and captured alternated; peak memory; at cell capacity
    8, R1 and R2 held against their plain versions on the sharded path's
    inputs and the captured path's launches. At cell capacity 24 and 8 the
    mesh with a stream a shard against the serial reference
    (``concurrent_vs_serial``: 10 repeats of 30 captured steps, 1-step
    windows, 5 traced replays of each)."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops import grid
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.parallel import gspmd, mesh as mesh_mod
    t_phase = time.perf_counter()
    cfg_k, params, _ = wst.scenes.build("reference-cube", device="cuda")
    cfg = dataclasses.replace(cfg_k, neighbor_mode="bucket_grid",
                              sorted_state=False)
    mesh = mesh_mod.make_mesh(shards, "cuda")
    sh = gspmd.shard_state(state100, mesh)
    slabs = gspmd.build_slabs(mesh, cfg, sh, [params] * shards)
    want = grid.build_bucket_grid(state100.predicted, state100.vel, params,
                                  cfg)
    nc_loc = grid.num_cells(cfg) // shards
    for d, g in enumerate(slabs.grids):
        cells = slice(d * nc_loc, (d + 1) * nc_loc)
        check(all(same_bits(getattr(g, f), getattr(want, f)[..., cells]
                            .contiguous())
                  for f in ("cell_pos", "cell_vel", "cell_mask")),
              f"gspmd: slab {d} differs from the single-device build")
    del slabs, want

    step = gspmd.make_sharded_step(mesh, cfg)
    base = float(state100.overflow_total)
    torch.cuda.synchronize()
    mesh.reset_traffic()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e = step(sh, params)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    moved, largest = dict(mesh.moved), dict(mesh.largest)
    plane = cfg.cell_capacity * grid.num_cells(cfg) * 4
    check(max(largest.values()) <= plane,
          f"gspmd: a transfer larger than one (cap, nc) plane: {largest}")
    for _ in range(steps - 1):
        e = step(e, params)
    got = gspmd.unshard_state(e)
    pos_err = float((got.pos - single.pos).abs().max())
    vel_err = float((got.vel - single.vel).abs().max())
    check(bool(torch.allclose(got.pos, single.pos, rtol=1e-4, atol=1e-5))
          and bool(torch.allclose(got.vel, single.vel, rtol=1e-3,
                                  atol=1e-4)),
          f"gspmd: {steps} steps vs single device, max |dpos| {pos_err:.3e}"
          f" |dvel| {vel_err:.3e}")
    check(float(got.overflow_total) == base, "gspmd: overflow_total grew")
    bits = all(same_bits(getattr(got, f), getattr(single, f))
               for f in ("pos", "vel", "density", "acc"))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    g = graph_mod.ShardedGraph(step, [s.clone() for s in sh], params, mesh)
    g.run(steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grid_launches("gspmd reference-cube", paths, launches_now(), steps, True,
                  shards)
    check(all(same_state(a, b) and same_bits(a.acc, b.acc)
              for a, b in zip(g.states, e)),
          "gspmd: captured != eager")
    state = {"eager": e}

    def eager(k):
        for _ in range(k):
            state["eager"] = step(state["eager"], params)

    ms_e, ms_c = alternate(eager, g.run, pairs=2, steps=3)
    log(f"[gspmd] reference-cube bucket_grid on {shards} shards of the card "
        f"({cfg.grid_dims[0] // shards} x layers each) from step 100: slabs "
        f"= the single-device build bit for bit; {steps} eager steps vs the "
        f"single-device step: max |dpos| {pos_err:.3e}, |dvel| "
        f"{vel_err:.3e}, bit-identical {bits}; overflow_total "
        f"{float(got.overflow_total) - base}; captured = eager bit for bit; "
        f"ms/step eager {ms_e} captured {ms_c} (host clock, alternated "
        f"windows of 3 steps), capture {g.capture_s:.2f} s, peak memory "
        f"{peak:.2f} GiB; bytes a step {moved}, largest transfer {largest} "
        f"(one (cap, nc) plane {plane}); launches "
        f"{paths['gspmd reference-cube'][0]}")
    del g, e, state

    def against_serial(c):
        def graph_of(serial):
            m = mesh_mod.make_mesh(shards, "cuda", serial=serial)
            return graph_mod.ShardedGraph(
                gspmd.make_sharded_step(m, c), gspmd.shard_state(state100, m),
                _map_tensors(params, torch.clone), m)

        concurrent_vs_serial(
            "gspmd", f"reference-cube bucket_grid cell capacity "
            f"{c.cell_capacity} on {shards} slabs from step 100", graph_of,
            window=1, trace=5, names=STEP_KERNEL_NAMES[2:])

    against_serial(cfg)

    cfg8 = dataclasses.replace(cfg, cell_capacity=8)
    step8 = gspmd.make_sharded_step(mesh, cfg8)
    with recording_rescue() as calls:
        step8(sh, params)
    torch.cuda.synchronize()
    err = hold_rescue("gspmd cap 8", calls)
    for name, e_k in err.items():
        record.setdefault(name, {})["gspmd reference-cube cap 8"] = dict(
            max_abs_err=e_k)
    del calls
    reset_launches()
    g8 = graph_mod.ShardedGraph(step8, [s.clone() for s in sh], params,
                                mesh)
    g8.run(5)
    torch.cuda.synchronize()
    grid_launches("gspmd reference-cube cap 8", paths, launches_now(), 5,
                  True, shards)
    got8 = gspmd.unshard_state(g8.states)
    single8 = wst.rollout(state100, params, cfg8, 5)
    err8 = float((got8.pos - single8.pos).abs().max())
    check(bool(torch.allclose(got8.pos, single8.pos, rtol=1e-4, atol=1e-5)),
          f"gspmd cap 8: 5 steps vs single device, max |dpos| {err8:.3e}")
    del g8
    against_serial(cfg8)
    log(f"[gspmd] cell capacity 8: R1/R2 vs plain on the sharded path's "
        f"inputs max_abs_err {err}, 5 captured steps vs the single-device "
        f"step max |dpos| {err8:.3e} (bit-identical "
        f"{same_bits(got8.pos, single8.pos)}), launches "
        f"{paths['gspmd reference-cube cap 8'][0]}, phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def mode_state(mode: str, scene: str, start: int, steps: int = 10,
               **kw) -> None:
    """One [modes] line: ``scene`` in ``neighbor_mode=mode`` at full width
    (``kw`` replaces SimConfig fields) from the state ``start`` steps past
    the lattice: the eager step under sync debug "error", ``steps``
    replays of its captured step (a StepGraph) against ``steps`` eager
    steps bit for bit, launching no hand kernel but the coefficients' and
    the integrate's,
    warm-up and capture seconds, peak memory above the scene's tensors
    (eager and captured), ms/step eager and captured in alternated 5-step
    windows, the kernels a replay and busy share of 20 traced replays, and
    the hash runs truncated (``overflow``: the emulation's limit, as in the
    JAX package)."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    t0 = time.perf_counter()
    label = f"{mode} {scene} step {start}"
    cfg, params, state = wst.scenes.build(scene, device="cuda",
                                          neighbor_mode=mode, **kw)
    if start:
        state = wst.rollout(state, params, cfg, start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e = wst.step(state, params, cfg)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(steps - 1):
        e = wst.step(e, params, cfg)
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 2**20
    total0 = float(state.overflow_total)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = graph_mod.StepGraph(state.clone(), _map_tensors(params, torch.clone),
                            cfg)
    reset_launches()
    g.run(steps)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    launches = {k: v for k, v in launches_now().items() if v}
    check(g.graph is not None, f"[modes] {label}: no graph")
    check(same_state(g.state, e) and same_bits(g.state.acc, e.acc)
          and same_bits(g.state.overflow_total, e.overflow_total),
          f"[modes] {label}: {steps} captured steps != {steps} eager steps")
    check(launches == {"sph_coeffs": steps, "sph_integrate": steps}
          and g.per_replay == {"sph_coeffs": 1, "sph_integrate": 1},
          f"[modes] {label}: hand kernels launched {launches}")
    check(bool(torch.isfinite(g.state.pos).all()),
          f"[modes] {label}: non-finite positions")
    truncated = int(g.state.overflow)
    grown = float(g.state.overflow_total) - total0
    state = {"eager": e}

    def eager(k):
        for _ in range(k):
            state["eager"] = wst.step(state["eager"], params, cfg)

    ms_e, ms_c = alternate(eager, g.run)
    del state, e
    prof = profile_replays(g, names=())
    log(f"[modes] {label}: n={cfg.n}, dim {cfg.dim}, eager step under sync "
        f"debug \"error\", {steps} captured steps = {steps} eager bit for "
        f"bit, no hand kernel but the coefficients' and the integrate's "
        f"(once a replay); warm-up "
        f"+ capture {g.capture_s:.2f} s; peak "
        f"memory above the scene's tensors: captured (capture + {steps} "
        f"replays) {peak:.1f} MiB, {steps} eager steps {peak_eager:.1f} MiB; "
        f"ms/step eager {ms_e} captured {ms_c} (host clock, alternated "
        f"windows of 5 steps); {prof['steps']} traced replays: ATen kernels "
        f"a replay {prof['kernels']:.1f}, device ms a step "
        f"{prof['device_ms']:.4f}, busy share {fmt(prof['busy'])}, host "
        f"clock a step {prof['wall_ms']:.4f} untraced; hash runs truncated "
        f"(overflow) {truncated} at the last step, overflow_total "
        f"+{grown} over {steps} steps ({time.perf_counter() - t0:.1f} s)")


# [modes]: the plain neighbour modes' captured steps, (mode, scene, steps
# from the lattice, SimConfig overrides). The flagships ride in bucket
# order under the kernel pipeline only (sorted_state=True there).
MODE_STATES = (
    ("dense", "mini-3d", 0, {}),
    ("dense", "dam-break-2d-4k", 0, {}),
    ("dense", "dam-break-2d-4k", 100, {}),
    ("hash_grid", "mini-3d", 0, {}),
    ("hash_grid", "reference-cube", 0, dict(sorted_state=False)),
    ("hash_grid", "moving-container-256k", 0, dict(sorted_state=False)),
)


def phase_modes() -> None:
    """The "dense" and "hash_grid" steps on the device only ([modes]):
    ``mode_state`` for each of MODE_STATES; the bench's fingerprint of a
    short ``bench.measure`` in each mode says ``"step": "captured"``; one
    ``cli run mini-3d --neighbor-mode dense --steps 4`` subprocess, which
    launches no hand kernel but the coefficients' and the integrate's, once
    a step."""
    from water_sandbox_tpu_torch import bench
    t_phase = time.perf_counter()
    for mode, scene, start, kw in MODE_STATES:
        mode_state(mode, scene, start, **kw)
    for mode in ("dense", "hash_grid"):
        sim, rate, _, done = bench.measure("mini-3d", mode, chunk=10,
                                           settle=20, device="cuda")
        fp = bench.fingerprint(sim)
        check(fp["step"] == "captured" and fp["neighbor_mode"] == mode,
              f"[modes] bench {mode}: fingerprint {fp}")
        log(f"[modes] bench.measure mini-3d {mode} (10-step windows, "
            f"settled at {done}): {rate:.1f} particle-steps/s, fingerprint "
            f"step {fp['step']!r}")
        del sim
    t0 = time.perf_counter()
    lines, launches = run_front("water_sandbox_tpu_torch.cli", "run",
                                "--scene", "mini-3d", "--neighbor-mode",
                                "dense", "--steps", "4")
    stats = json.loads(next(ln for ln in lines if ln.startswith("{")))
    check(stats["step"] == 4
          and {k: v for k, v in launches.items() if v} == {
              "sph_coeffs": 4, "sph_integrate": 4},
          f"[modes] cli run dense: step {stats['step']}, launches {launches}")
    log(f"[modes] cli run mini-3d --neighbor-mode dense --steps 4: step 4, "
        f"ke {stats['kinetic_energy']:.2f}, no hand kernel but the "
        f"coefficients' and the integrate's "
        f"({time.perf_counter() - t0:.1f} s); phase passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


# The dense 1,000-step pin's three summation orders: the scene's own row
# order and two seeded permutations of the initial rows (ids with them).
DENSE_ORDERS = (None, 1, 2)


def permuted(state, seed: int):
    """``state`` with its rows in a seeded random order, ``ids`` with
    them."""
    import dataclasses
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        state.n)).to(state.device)
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[perm]
        for f in dataclasses.fields(state)
        if getattr(state, f.name).dim() > 0})


def phase_golden_dense(steps: int = 1000) -> None:
    """The port's 1,000-step pin of ``dam-break-2d-4k`` in "dense" made on
    the card, through Simulation.run (the captured dense step): the
    scene's own order twice (bit for bit), two seeded permutations of the
    rows (other summation orders of the same pairs), each within the pin's
    bars (the larger of the JAX package's and twice the spread over the
    three orders), and the planted physics bug tripping it; the JAX
    package's TPU pin printed beside it. Every run prints its statistics
    before any check fails."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch import golden
    scene, mode = "dam-break-2d-4k", "dense"
    key = (scene, mode, steps)
    pin = golden.GOLDEN.get(key)
    t_phase = time.perf_counter()

    def run(label, seed=None):
        t0 = time.perf_counter()
        cfg, params, state = wst.scenes.build(scene, device="cuda",
                                              neighbor_mode=mode)
        if seed is not None:
            state = permuted(state, seed)
        sim = wst.Simulation(cfg, params, state, name=scene)
        done = 0
        while done < steps:                 # golden.run's 50-step chunks
            sim.run(min(50, steps - done), block=False)
            done += 50
        torch.cuda.synchronize()
        got = golden.summarize(sim.state)
        log(f"[golden] {scene} {mode} {steps} steps, {label}: "
            f"{json.dumps(got)} ({time.perf_counter() - t0:.1f} s)")
        return sim.state, got

    reset_launches()
    first, picked = run("the scene's order")
    launches = {k: v for k, v in launches_now().items() if v}
    again, _ = run("the scene's order again")
    same = same_state(first, again) and same_bits(first.acc, again.acc)
    del again
    orders = {"the scene's order": picked}
    states = [first]
    for seed in DENSE_ORDERS[1:]:
        s, orders[f"rows permuted, seed {seed}"] = run(
            f"rows permuted, seed {seed}", seed)
        states.append(s)
    differ = all(not np.array_equal(by_id(a, "pos"), by_id(b, "pos"))
                 for i, a in enumerate(states) for b in states[i + 1:])
    del states, first
    spread = spreads(orders.values())
    log(f"[golden] {scene} {mode}: spread over the three orders "
        f"{json.dumps(spread)}; 2x that "
        f"{json.dumps({k: 2 * v for k, v in spread.items()})}")
    with golden.flipped_near_derivative():
        _, flipped = run("pow3_der flipped")
    jax_pin = golden.JAX_GOLDEN[key]
    log(f"[golden] {scene} {mode} beside the JAX package's pin "
        f"(information only): tripped {golden.check(picked, jax_pin)}, "
        f"margins {json.dumps(rounded(golden.margins(picked, jax_pin)))}")

    check(pin is not None, f"golden {scene} {mode}: no pin for {key}")
    check(launches == {"sph_coeffs": steps, "sph_integrate": steps},
          f"golden {scene} {mode}: hand kernels {launches}")
    check(same, f"golden {scene} {mode}: two runs of one order differ")
    check(differ, f"golden {scene} {mode}: the three orders do not all "
          "differ")
    for label, got in orders.items():
        tripped = golden.check(got, pin)
        log(f"[golden] {scene} {mode}: {label} against the pin made on "
            f"{pin['made_on']}: tripped {tripped}, margins "
            f"{json.dumps(rounded(golden.margins(got, pin)))}")
        check(tripped == [], f"golden {scene} {mode}: {label} tripped "
              f"{tripped}")
    tripped = golden.check(flipped, pin)
    log(f"[golden] {scene} {mode}: pow3_der flipped trips {tripped}")
    check(bool(set(tripped) - {"overflow_total"}),
          f"golden {scene} {mode}: the flipped run tripped no statistic")
    log(f"[golden] {scene} {mode}: two runs of the scene's order "
        f"bit-identical, the three orders all different, no hand kernel "
        f"but the coefficients' and the integrate's (once a step), "
        f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_main_path(scene: str, steps: int, warmup: int):
    """Simulation.from_scene(scene).run(steps) on the card; returns the
    launch counts of the run and its steps."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    sim = wst.Simulation.from_scene(scene, device="cuda")
    reset_launches()
    sim.run(warmup)
    sim.run(steps - warmup)
    launches = launches_now()
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
    check_launches(scene, launches, steps)
    log(f"[main] {scene}: {steps} steps, n={s.n}, "
        f"ms/step {st['ms_per_step']:.3f} (timed over {st['steps_timed']} "
        f"steps after {warmup} warm-up), ke {st['kinetic_energy']:.2f}, "
        f"mean_rho {st['mean_density']:.3f}, launches {launches}")
    return launches, steps


def busy_intervals(dev) -> tuple:
    """(union, span) in us of device events ``dev``: the time covered by at
    least one event, and the time from the first event's start to the last
    one's end, both on the trace's device clock."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    union, (lo, hi) = 0.0, iv[0]
    for a, b in iv[1:]:
        if a > hi:
            union += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return union + hi - lo, iv[-1][1] - iv[0][0]


def stream_overlaps(dev) -> tuple:
    """(pairs of kernels on different streams whose intervals overlap, the
    streams the kernels ran on) among device events ``dev``, from each
    event's ``device_resource_id`` (its stream); (None, 0) when the trace
    names no stream."""
    ev = sorted((e.time_range.start, e.time_range.end, e.device_resource_id)
                for e in dev
                if getattr(e, "device_resource_id", None) is not None
                and not e.name.lower().startswith(("memcpy", "memset")))
    if not ev:
        return None, 0
    pairs, live = 0, []
    for start, end, stream in ev:
        live = [(e, s) for e, s in live if e > start]
        pairs += sum(1 for _, s in live if s != stream)
        live.append((end, stream))
    return pairs, len({s for _, _, s in ev})


STEP_KERNEL_NAMES = ("sph_density_kernel", "sph_force_kernel",
                     "rescue_density_kernel", "rescue_force_kernel")
DOMAIN_KERNEL_NAMES = ("sph_density_kernel", "sph_force_kernel",
                       "domain_density_kernel", "domain_force_kernel")


def profile_replays(g, steps: int = 20, names=STEP_KERNEL_NAMES):
    """torch.profiler (``profiling.traced``: idle margins around the span,
    so that the trace keeps the first replays' events) over ``steps``
    replays of ``g`` (a StepGraph or a DomainGraph), launched back to
    back: device ms a step (the device
    events' times summed), kernels a step, how many times each kernel of
    ``names`` appears (the kernels run inside the replays), the 8 largest
    device times a step by name, and the busy share on the trace's own
    clock: the union of the device events' intervals over
    the span from the first event's start to the last one's end (at most 1;
    gaps between kernels and between replays count as idle). With shards
    on their own streams the summed device time can exceed the union: the
    share reads the union only. Also the pairs of kernels on different
    streams that overlap in the trace (``stream_overlaps``), and the host
    clock a step of the traced replays
    and of as many replays run again without the profiler (launch to
    synchronisation)."""
    from torch.autograd import DeviceType
    from water_sandbox_tpu_torch.runtime.profiling import traced
    with traced() as prof:
        t0 = time.perf_counter()
        g.run(steps)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    found = {k: sum(1 for e in dev if k in e.name) for k in names}
    summed_us = sum(e.time_range.end - e.time_range.start for e in dev)
    union_us, span_us = busy_intervals(dev) if dev else (0.0, 0.0)
    kernels = sum(1 for e in dev
                  if not e.name.lower().startswith(("memcpy", "memset")))
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    overlaps, streams = stream_overlaps(dev)
    t0 = time.perf_counter()
    g.run(steps)
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t0)
    return dict(device_ms=summed_us / 1e3 / steps, kernels=kernels / steps,
                found=found, busy=union_us / span_us if span_us else None,
                union_ms=union_us / 1e3 / steps,
                span_ms=span_us / 1e3 / steps, steps=steps,
                overlaps=overlaps, streams=streams,
                wall_ms=alone_ms / steps, traced_ms=traced_ms / steps,
                top=[(name[:60], us / 1e3 / steps) for name, us in top])


def same_bits(a, b) -> bool:
    """Bit for bit (unwritten plane slots may hold NaN)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def same_state(a, b) -> bool:
    return all(same_bits(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "density", "ids"))


def phase_capture(scene: str, state100=None, pairs: int = 10,
                  window: int = 50) -> None:
    """The step as a captured CUDA graph (ops/cuda/graph.py) on ``scene``
    at full size: the capture succeeds (it raises on any host read in the
    step); the eager step runs under torch.cuda.set_sync_debug_mode
    ("error"); captured against eager bit for bit (pos, vel, density, ids)
    over steps 100-200 from ``state100`` (reference-cube: the rescue
    fires), then over ``window`` settled steps from step 600; launches a
    replay (counters and profiler trace), peak memory, and ms/step of
    eager and captured windows alternated ``pairs`` times."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    t_phase = time.perf_counter()
    cfg, params, state = wst.scenes.build(scene, device="cuda")
    cfg = cfg.resolved()

    def graph_at(s):
        return graph_mod.StepGraph(s.clone(), _map_tensors(params,
                                                           torch.clone), cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g = graph_at(state)
    g.capture()
    check(g.graph is not None, f"capture {scene}: no graph")
    check(g.per_replay == {k: 1 for k in STEP_KERNELS},
          f"capture {scene}: launches a replay {g.per_replay}")
    g.run(window)
    torch.cuda.synchronize()
    peak_captured = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"[capture] {scene}: n={state.n}, captured in {g.capture_s:.2f} s "
        f"({graph_mod.WARMUP_STEPS} warm-up steps on a side stream, then "
        f"one step), launches a replay {g.per_replay}, peak memory above "
        f"the scene's tensors {peak_captured:.1f} MiB (capture + "
        f"{window} replays)")

    torch.cuda.set_sync_debug_mode("error")
    try:
        wst.step(state, params, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[capture] {scene}: the eager step ran under "
        "torch.cuda.set_sync_debug_mode('error'): no synchronisation")

    if state100 is not None:
        # steps 100-200: eager and captured, each step synced and timed
        gi = graph_at(state100)
        gi.run(1)                                   # captures
        graph_mod.copy_state(gi.state, state100)
        e = state100
        t_e, t_c, rescued = [], [], 0
        for _ in range(100):
            rescued += int(sb._build_core(e.predicted, e.vel, params, cfg,
                                          time=e.time)[5]) > 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = wst.step(e, params, cfg)
            torch.cuda.synchronize()
            t_e.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            gi.run(1)
            torch.cuda.synchronize()
            t_c.append(1e3 * (time.perf_counter() - t0))
        check(same_state(gi.state, e),
              f"capture {scene}: steps 100-200 captured and eager differ")
        check(float(e.overflow_total) == float(state100.overflow_total),
              f"capture {scene}: steps 100-200 left particles unrescued")
        log(f"[capture] {scene} steps 100-200: captured and eager "
            f"bit-identical (pos, vel, density, ids); the rescue fired on "
            f"{rescued} of 100 steps")
        log(f"[rescue] {scene} steps 100-200, host clock a synced step: "
            f"captured mean {statistics.mean(t_c):.4f} median "
            f"{statistics.median(t_c):.4f} max {max(t_c):.4f} ms/step; eager "
            f"mean {statistics.mean(t_e):.4f} median "
            f"{statistics.median(t_e):.4f} max {max(t_e):.4f} (the first "
            f"eager step with the torch-op rescue, PERF.md §5: mean 8.271, "
            f"median 2.912)")
        check(rescued > 0, f"capture {scene}: no rescue in steps 100-200")
        del gi

    # settle to step 600, then eager against captured from one state
    g.run(600 - int(g.state.step_count))
    settled = g.state.clone()
    e = settled
    for _ in range(window):
        e = wst.step(e, params, cfg)
    g.run(window)
    torch.cuda.synchronize()
    check(same_state(g.state, e),
          f"capture {scene}: {window} settled steps captured and eager "
          "differ")
    log(f"[capture] {scene}: {window} steps from step "
        f"{int(settled.step_count)}, captured and eager bit-identical (pos, "
        f"vel, density, ids)")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(window):
        e = wst.step(e, params, cfg)
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 2**20

    times = {"eager": [], "captured": []}
    for i in range(pairs):
        for mode in (("eager", "captured") if i % 2 == 0
                     else ("captured", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                for _ in range(window):
                    e = wst.step(e, params, cfg)
            else:
                g.run(window)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0) / window)
    med = {k: statistics.median(v) for k, v in times.items()}
    ratios = [a / b for a, b in zip(times["eager"], times["captured"])]
    log(f"[capture] {scene} settled, {pairs} pairs of {window}-step windows "
        f"alternated (host clock, synced at each window's end): captured "
        f"median {med['captured']:.4f} ms/step (windows "
        f"{', '.join(f'{x:.4f}' for x in times['captured'])}); eager median "
        f"{med['eager']:.4f} (windows "
        f"{', '.join(f'{x:.4f}' for x in times['eager'])}); eager/captured "
        f"median ratio {statistics.median(ratios):.3f}; peak memory of "
        f"{window} eager steps above their state {peak_eager:.1f} MiB")
    prof = profile_replays(g)
    log(f"[capture] {scene} torch.profiler over {prof['steps']} settled "
        f"replays: device ms a step {prof['device_ms']:.4f} (events "
        f"summed), kernels a step {prof['kernels']:.1f}, step kernels found "
        f"{prof['found']}, busy share {fmt(prof['busy'])} on the trace's "
        f"clock (device events' union {prof['union_ms']:.4f} over the span "
        f"{prof['span_ms']:.4f} ms a step); host clock a step "
        f"{prof['wall_ms']:.4f} without the profiler, "
        f"{prof['traced_ms']:.4f} traced")
    if prof["kernels"] == 0:
        # then bit-identity with the eager step above is the proof that
        # the replays run the kernels
        log(f"[capture] {scene}: this torch's trace records no kernels "
            "inside a CUDA graph")
    else:
        check(all(v == prof["steps"] for v in prof["found"].values()),
              f"capture {scene}: the trace of {prof['steps']} replays holds "
              f"the step kernels {prof['found']} times")
    log(f"[capture] {scene}: phase passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


# The incremental path against the rebuild path at JAX's own bars
# (tests/test_incremental.py:98): (k, steps, position bar, velocity bar).
INC_PARITY = ((1, 4, 1e-5, 1e-4), (4, 6, 5e-3, 5e-2))


def inc_consistency(label, state, cache, cfg) -> None:
    """The cache mirrors the particle-order state: live addresses unique,
    occupied slots equal to the live particles, the planes' rows equal to
    the state's bit for bit, top >= occupancy in every lane, the state
    finite."""
    from water_sandbox_tpu_torch.ops.cuda import incremental as inc
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    dim = cfg.dim
    cap_p = sb._cap_pad(cfg.cell_capacity)
    live = cache.addr != cap_p * sb._geometry(cfg).L
    a = cache.addr[live].long()
    check(torch.unique(a).numel() == a.numel(),
          f"{label}: a live address repeats")
    occupied = cache.planes[0] < 0.5 * sb._FAR
    check(int(occupied.sum()) == a.numel(),
          f"{label}: occupied slots differ from the live particles")
    rows = cache.planes.reshape(2 * dim, -1)[:, a].T.contiguous()
    want = torch.cat([state.predicted, state.vel], dim=1)[live]
    check(torch.equal(rows.view(torch.int32), want.view(torch.int32)),
          f"{label}: the planes do not mirror the state")
    top, _ = inc._top_row(cache.planes, cap_p)
    check(bool((top[0] >= occupied.sum(dim=0)).all()),
          f"{label}: top below the occupancy of a lane")
    check(all(bool(torch.isfinite(getattr(state, f)).all())
              for f in ("pos", "vel", "predicted", "acc", "density")),
          f"{label}: non-finite state")


def phase_incremental(record, paths) -> None:
    """The incremental plane-resident path (ops/cuda/incremental.py) at
    reference-cube's full width, 65,536 particles, in particle order (the
    mode refuses the sorted state, and the flagship's container frame).
    From one state settled 600 steps on the rebuild path: JAX's parity bars
    against the rebuild path; the cache invariants over 20 materialized
    steps; K1 and K2 against their plain versions on the next step's
    re-inserted planes, which have holes (counts = top); the captured step
    (IncrementalGraph, its branches IF conditional nodes) against the eager
    one bit for bit over 20 steps with rebuilds and drop steps
    (``capture_vs_eager``); keep-or-drop windows of 50 steps for k = 0
    (the rebuild path), 4, 8, 16 and the scene's own sorted rebuild step,
    every one a replayed graph, alternating, three rounds, with what each k
    did (rescue steps, rebuilds, movers, hole debt) from one untimed eager
    window each; for each, capture seconds, peak memory, kernels a replay
    (the branches' apart) and torch.profiler's device ms, kernels and busy
    share of a 20-step run. Last, Simulation.from_scene with cell capacity
    8 and with incremental_rebuild=8, replaying one capture, with their
    launches counted and the drop steps read from the graph's device
    counts."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import KernelCoeffs, _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.ops.cuda import incremental as inc
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    t_phase = time.perf_counter()
    cfg_sorted, params, state = wst.scenes.build("reference-cube",
                                                 device="cuda")
    cfg0 = dataclasses.replace(cfg_sorted, sorted_state=False)
    g = sb._geometry(cfg0)
    cap_p = sb._cap_pad(cfg0.cell_capacity)
    h = float(params.smoothing_radius)

    def cfg_k(k):
        return dataclasses.replace(cfg0, incremental_rebuild=k)

    settled = wst.rollout(state, params, cfg0, 600)
    torch.cuda.synchronize()
    log(f"[incremental] reference-cube (n={settled.n}, particle order) "
        f"settled 600 steps on the rebuild path in "
        f"{time.perf_counter() - t_phase:.1f} s, overflow_total "
        f"{float(settled.overflow_total)}")

    for k, steps, tol_p, tol_v in INC_PARITY:
        ref = wst.rollout(settled, params, cfg0, steps)
        out = wst.rollout(settled, params, cfg_k(k), steps)
        errs = []
        for f, tol in (("pos", tol_p), ("vel", tol_v)):
            o, r = getattr(out, f), getattr(ref, f)
            err = (o - r).abs()
            check(bool((err <= tol + tol * r.abs()).all()),
                  f"incremental k={k}: {f} max err {float(err.max()):.3e} "
                  f"past JAX's bar {tol}")
            errs.append(float(err.max()))
        check(int(out.step_count) == int(ref.step_count),
              f"incremental k={k}: step count")
        log(f"[incremental] parity k={k}, {steps} steps against the rebuild "
            f"path: max |dpos| {errs[0]:.3e} (bar {tol_p}), max |dvel| "
            f"{errs[1]:.3e} (bar {tol_v})")

    cfg8 = cfg_k(8)
    st = settled
    cache = inc.build_cache(st.predicted, st.vel, params, cfg8)
    inc_consistency("incremental build", st, cache, cfg8)
    for i in range(20):
        st, cache = inc.step_inc(st, cache, params, cfg8, True)
        inc_consistency(f"incremental step {i + 1}", st, cache, cfg8)
    log(f"[incremental] k=8: cache invariants held after each of 20 "
        f"materialized steps (ticks {int(cache.ticks)})")

    # the kernels' inputs of the next step: the re-inserted planes
    pred_c, vel_c, _ = inc.read_state(st, cache, params, cfg8)
    planes_r, addr_r, nm, _, _ = inc.reinsert(pred_c, vel_c, cache, params,
                                              cfg8)
    top, occ = inc._top_row(planes_r, cap_p)
    debt = float(top.sum()) - int(occ)
    check(debt > 0, "incremental: no holes in the re-inserted planes")
    pv = sb._param_vector(params, KernelCoeffs.from_radius(
        params.smoothing_radius, cfg8.dim))
    dens_k = sb.run_density(planes_r, top, addr_r, pv, cfg8)
    dens_p = sb.density_plain(planes_r, top, addr_r, pv, cfg8)
    # A clear writes _FAR into plane 0 only, so a slot cleared this step at
    # the top of its lane keeps its stale y and z: plane 0 alone holds the
    # far fill at every empty slot, and it alone makes the distance test
    # fail there.
    hold_and_time("reference-cube incremental step 621 (holes)", record,
                  planes_r, top, addr_r, pv, cfg8, h, dens_k, dens_p,
                  far_planes=1)
    log(f"[kernels] reference-cube incremental step 621: counts = top, hole "
        f"debt {debt:.0f} slots, movers re-inserted {int(nm)}, live rows "
        f"{int((addr_r < cap_p * g.L).sum())}")
    del planes_r, dens_k, dens_p

    capture_vs_eager(settled, params, dataclasses.replace(
        cfg_k(4), cell_capacity=8))

    variants = {"k=0": cfg0, "k=4": cfg_k(4), "k=8": cfg8,
                "k=16": cfg_k(16), "sorted rebuild": cfg_sorted}

    # every variant replays one captured step, as Simulation.run does: the
    # rebuild steps (k = 0, sorted) a StepGraph, k = 4, 8, 16 an
    # IncrementalGraph, whose run builds the cache on entry and
    # materializes its last step (as rollout_inc); each window starts from
    # the settled state. Captured on their first (5-step) window, with the
    # memory that capture and window take above the tensors already there.
    graphs, peak = {}, {}
    for name, c in variants.items():
        kind = (graph_mod.IncrementalGraph if c.incremental_rebuild
                else graph_mod.StepGraph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        graphs[name] = kind(settled.clone(), _map_tensors(params, torch.clone),
                            c)
        window(graphs[name], 5)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        check(graphs[name].graph is not None, f"{name}: not captured")
    times = {name: [] for name in variants}
    for r in range(3):
        order = list(variants)
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(window(graphs[name]))

    def what_it_did(name, c, steps=50):
        """Untimed: steps that rescued, rebuilds, mean movers a step and the
        final hole debt over one window from the settled state (eager)."""
        s = settled
        if not c.incremental_rebuild:
            over = []
            for _ in range(steps):
                over.append(sb._build_core(s.predicted, s.vel, params, c,
                                           time=s.time)[5])
                s = wst.step(s, params, c)
            return dict(rescued=sum(int(o) > 0 for o in over))
        cache = inc.build_cache(s.predicted, s.vel, params, c)
        movers, ticks, over = [], [], []
        for i in range(steps):
            pred, _, _ = inc.read_state(s, cache, params, c)
            newcol = inc._new_columns(pred, cache.origin, params, c, g.S_pad)
            movers.append((newcol != cache.addr % g.L - g.PAD).sum())
            s, cache = inc.step_inc(s, cache, params, c, i == steps - 1)
            ticks.append(int(cache.ticks))
            over.append(s.overflow)
        top, occ = inc._top_row(cache.planes, cap_p)
        return dict(
            rescued=sum(int(o) > 0 for o in over),
            rebuilds=sum(ticks[i] <= ticks[i - 1] for i in range(1, steps)),
            movers=float(torch.stack(movers).float().mean()),
            debt=float(top.sum()) - int(occ))

    med = {name: statistics.median(t) for name, t in times.items()}
    for name, c in variants.items():
        t = times[name]
        did = what_it_did(name, c)
        extra = ""
        if "rebuilds" in did:
            extra = (f", rebuilds {did['rebuilds']}, mean movers a step "
                     f"{did['movers']:.1f}, final hole debt "
                     f"{did['debt']:.0f} slots")
        log(f"[incremental] {name}: median ms/step {med[name]:.4f} (rounds "
            f"{', '.join(f'{x:.4f}' for x in t)}; host clock over 50 synced "
            f"replays of its captured step from the settled state; k > 0: "
            f"the cache built on entry, the last step materializing), "
            f"{med[name] / med['k=0']:.3f} of k=0 and "
            f"{med[name] / med['sorted rebuild']:.3f} of the sorted step; "
            f"rescue steps {did['rescued']} of 50{extra} (eager, untimed)")

    for name in variants:
        gr = graphs[name]
        graph_mod.copy_state(gr.state, settled)
        fired0 = gr.fired() if name in ("k=4", "k=8", "k=16") else None
        prof = profile_replays(gr)
        branch = ""
        if fired0 is not None:
            fired = gr.fired()
            ran = {k: fired[k] - fired0[k] for k in fired}
            branch = (f"; branch bodies over the {2 * prof['steps']} steps "
                      f"(traced and untraced runs) {ran}, their launches "
                      f"a run {gr.branches.launches}")
            check(prof["found"]["sph_density_kernel"] == prof["steps"]
                  and prof["found"]["sph_force_kernel"] == prof["steps"]
                  or prof["kernels"] == 0,
                  f"incremental {name}: K1/K2 not once a replay in the "
                  f"trace: {prof['found']}")
        log(f"[incremental] {name} captured: capture {gr.capture_s:.3f} s "
            f"({graph_mod.WARMUP_STEPS} warm-up steps, every branch forced, "
            f"then one step), peak memory above the state "
            f"{peak[name]:.1f} MiB (capture and a 5-step window), kernels "
            f"a replay outside the branches {gr.per_replay}{branch}; "
            f"torch.profiler over a {prof['steps']}-step run: device ms a "
            f"step {prof['device_ms']:.4f}, kernels a step "
            f"{prof['kernels']:.1f}, step kernels found {prof['found']}, "
            f"busy share {fmt(prof['busy'])} (union {prof['union_ms']:.4f} "
            f"over span {prof['span_ms']:.4f} ms a step), host clock a step "
            f"{prof['wall_ms']:.4f} untraced; largest device ms a step "
            f"{prof['top'][:5]}")
    del graphs

    def run_counting_drops(sim, steps):
        """sim.run(steps) with the launches counted from 0, and the steps
        whose drop-step branch ran, from the graph's device counts."""
        fired0 = sim.graph.fired()
        reset_launches()
        sim.run(steps)
        launches = launches_now()
        fired = sim.graph.fired()
        return launches, fired["drop"] - fired0["drop"], (
            fired["rebuild"] - fired0["rebuild"])

    # the rescue on the incremental path: cell capacity 8 from the settled
    # state drops thousands of particles a step
    sim8 = wst.Simulation(dataclasses.replace(cfg8, cell_capacity=8),
                          params, settled)
    sim8.run(2)
    graph8 = sim8.graph.graph
    launches, rescued8, rebuilt8 = run_counting_drops(sim8, 10)
    check(sim8.graph.graph is graph8 is not None,
          "incremental cap 8: recaptured on a second run")
    check(rescued8 == 10, f"incremental cap 8: the rescue ran on {rescued8} "
          "of 10 steps")
    check_launches("reference-cube incremental cap 8", launches, 10,
                   rescued8, rebuilt8)
    check(bool(torch.isfinite(sim8.state.pos).all()),
          "incremental cap 8: non-finite")
    paths["reference-cube incremental cap 8"] = (launches, 10)
    log(f"[incremental] cell capacity 8: 10 replays after a 2-step run from "
        f"the settled state, the drop-step branch on {rescued8} (overflow "
        f"{int(sim8.state.overflow)} on the last), rebuilds {rebuilt8}, "
        f"launches {launches}")
    del sim8

    sim = wst.Simulation.from_scene("reference-cube", device="cuda",
                                    sorted_state=False, incremental_rebuild=8)
    check(isinstance(sim.graph, graph_mod.IncrementalGraph),
          "incremental: Simulation owns no IncrementalGraph")
    sim.run(5)
    captured = sim.graph.graph
    steps = 50
    launches, rescue_steps, rebuilt = run_counting_drops(sim, steps)
    check(captured is not None and sim.graph.graph is captured,
          "incremental: Simulation.run did not replay its first capture")
    check_launches("reference-cube incremental", launches, steps,
                   rescue_steps, rebuilt)
    paths["reference-cube incremental"] = (launches, steps)
    s = sim.state
    check(bool(torch.isfinite(s.pos).all()), "incremental: non-finite")
    check(bool((box_local(sim.params, s).abs()
                <= sim.params.container.half_size + 1e-4).all()),
          "incremental: particles outside the box")
    check(bool(torch.equal(s.ids, torch.arange(s.n, dtype=torch.int32,
                                               device=s.ids.device))),
          "incremental: rows left particle order")
    check(int(s.overflow) <= sim.cfg.rescue_capacity,
          "incremental: more dropped particles than the rescue takes")
    st = sim.stats()
    log(f"[main] reference-cube incremental (Simulation.from_scene, "
        f"sorted_state=False, incremental_rebuild=8): {steps} replays after "
        f"5, one capture, ms/step {st['ms_per_step']:.3f}, steps with "
        f"dropped particles {rescue_steps}, rebuilds {rebuilt}, ke "
        f"{st['kinetic_energy']:.2f}, launches {launches}")
    log(f"[incremental] phase passed in {time.perf_counter() - t_phase:.1f} s")


def window(gr, steps: int = 50) -> float:
    """ms/step of ``steps`` steps of graph ``gr`` from the state in its
    buffers at call time, copied back after (host clock, synced)."""
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    start = gr.state.clone()
    torch.cuda.synchronize()
    t = time.perf_counter()
    gr.run(steps)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / steps
    graph_mod.copy_state(gr.state, start)
    return ms


def capture_vs_eager(settled, params, cfg, steps: int = 20) -> None:
    """The captured incremental step (IncrementalGraph) against the eager
    one bit for bit over ``steps`` steps from ``settled`` (cell capacity 8:
    drop steps; k = 4: rebuilds), the eager steps under
    torch.cuda.set_sync_debug_mode("error") except device_if's own read of
    each branch's predicate; both runs' rebuild and drop steps from their
    device counts."""
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.ops.cuda import incremental as inc
    names = graph_mod.IncrementalGraph.BRANCHES
    br = graph_mod.Branches(settled.device, names)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e = settled
        cache = inc.build_cache(e.predicted, e.vel, params, cfg)
        for i in range(steps):
            e, cache = inc.step_inc(e, cache, params, cfg, i == steps - 1, br)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager_fired = {k: int(v) for k, v in br.fired.items()}
    gr = graph_mod.IncrementalGraph(settled.clone(),
                                    _map_tensors(params, torch.clone), cfg)
    gr.run(steps)
    torch.cuda.synchronize()
    fired = gr.fired()
    check(gr.graph is not None, "incremental: no graph captured")
    same = same_state(gr.state, e) and all(
        same_bits(a, b) for a, b in zip(gr.cache, cache))
    check(same, "incremental: captured and eager steps differ")
    check(fired == eager_fired, f"incremental: captured branches {fired} "
          f"against eager {eager_fired}")
    check(fired["rebuild"] >= 1 and fired["drop"] >= 1,
          f"incremental: the {steps} steps need a rebuild and a drop step: "
          f"{fired}")
    log(f"[incremental] captured against eager, k={cfg.incremental_rebuild} "
        f"cell capacity {cfg.cell_capacity}, {steps} steps from the settled "
        f"state: bit-identical (pos, vel, density, ids, and the cache's "
        f"planes, addr, origin, ticks); branches ran {fired} (eager: the "
        f"same); the eager steps ran under set_sync_debug_mode('error') "
        f"with only device_if's reads of the predicates; IF nodes captured "
        f"in {gr.capture_s:.3f} s, launches a replay outside the branches "
        f"{gr.per_replay}, inside them a run {gr.branches.launches}")


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


def cloned(x):
    """A copy of a call's argument: tensors cloned, named tuples of tensors
    (the domain rescue's Rows, Queries) rebuilt from clones, the rest as
    it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(cloned(e) for e in x))
    return x


def clone_args(args) -> list:
    return [cloned(a) for a in args]


@contextlib.contextmanager
def recording_domain_rescue():
    """D1's and D2's wrappers patched to keep a copy of every call's inputs
    before they run as before; yields {"density": [...], "force": [...]},
    a list of argument lists each."""
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    calls = {"density": [], "force": []}
    real = {"density": dr.rescue_density, "force": dr.rescue_force}

    def recorder(half):
        def rec(*args):
            calls[half].append(clone_args(args))
            real[half](*args)
        return rec

    dr.rescue_density = recorder("density")
    dr.rescue_force = recorder("force")
    try:
        yield calls
    finally:
        dr.rescue_density = real["density"]
        dr.rescue_force = real["force"]


def hold_domain_rescue(label, calls, check_changed=True) -> dict:
    """D1 and D2 against their plain versions on every recorded call (a
    shard each): D1's density planes at the residents' addresses and its
    rows' sums, D2's accelerations, rtol 2e-4 / atol 2e-4·max(1,
    max|plain|); two launches bit-identical; at count 0 the kernel's
    outputs bit for bit its inputs. Returns the worst |kernel - plain| of
    each kernel."""
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    err = {k: 0.0 for k in DOMAIN_KERNELS}
    for d, args in enumerate(calls["density"]):
        pred, walk, addr, q, feats, dens, qden, qnden, p, c, pv, cl = args
        k, again = clone_args(args), clone_args(args)
        dr.rescue_density(*k)
        dr.rescue_density(*again)
        want = clone_args(args)
        dr.density_plain(*want[:8], p, c, cl)
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(k[5:8], again[5:8])),
              f"{label} shard {d}: two launches of D1 differ")
        if int(q.count) == 0:
            check(all(same_bits(a, b) for a, b in zip(k[5:8], args[5:8])),
                  f"{label} shard {d}: D1 at count 0 changed its outputs")
            continue
        PL = dens[0].numel()
        res = addr[addr < PL].long()
        mine = q.valid[:qden.shape[0]]
        e = max([hold(f"{label} shard {d} D1 plane {i}",
                      k[5].view(6, -1)[i, res].cpu().numpy(),
                      want[5].view(6, -1)[i, res].cpu().numpy())
                 for i in range(6)]
                + [hold(f"{label} shard {d} D1 {name}",
                        k[j][mine].cpu().numpy(), want[j][mine].cpu().numpy())
                   for j, name in ((6, "qden"), (7, "qnden"))])
        err["sph_domain_rescue_density"] = max(
            err["sph_domain_rescue_density"], e)
    for d, args in enumerate(calls["force"]):
        k, again, want = clone_args(args), clone_args(args), clone_args(args)
        dr.rescue_force(*k)
        dr.rescue_force(*again)
        dr.force_plain(*want[:15], want[16])
        torch.cuda.synchronize()
        check(same_bits(k[12], again[12]),
              f"{label} shard {d}: two launches of D2 differ")
        if int(args[8].count) == 0:
            check(same_bits(k[12], args[12]),
                  f"{label} shard {d}: D2 at count 0 changed acc")
            continue
        e = hold(f"{label} shard {d} D2 acc", k[12].cpu().numpy(),
                 want[12].cpu().numpy())
        if check_changed:
            check(not torch.equal(k[12], args[12]),
                  f"{label} shard {d}: D2 changed nothing")
        err["sph_domain_rescue_force"] = max(
            err["sph_domain_rescue_force"], e)
    return err


def concurrent_vs_serial(tag: str, label: str, graph_of, steps: int = 30,
                         repeats: int = 10, pairs: int = 10, window: int = 10,
                         trace: int = 0, names=DOMAIN_KERNEL_NAMES) -> dict:
    """The mesh's shards on their own streams against the serial reference
    (``Mesh(serial=True)``: every shard on the caller's stream, one after
    another). ``graph_of(serial)`` gives a DomainGraph or ShardedGraph over
    fresh copies of one state. The serial graph's capture and ``steps``
    replays, then the concurrent graph's, ``repeats`` times from the same
    state, each held bit for bit against the serial one (a race shows as a
    repeat that differs) with the same launches a replay; the peak memory
    of each above what was allocated before it (buffers, capture,
    replays); ``pairs`` alternated windows of ``window`` replays of each,
    ms/step on the host clock (synced); with ``trace``, profile_replays
    over ``trace`` replays of each (summed and union device ms, busy share
    on the union, overlapping kernels of different streams). Logs one
    ``[tag]`` line (two with ``trace``) and returns the facts."""
    def same(g, ref):
        return (all(same_state(a, b) and same_bits(a.acc, b.acc)
                    for a, b in zip(g.states, ref[0]))
                and all(torch.equal(a, b)
                        for a, b in zip(getattr(g, "active", []), ref[1])))

    graphs, peak, capture = {}, {}, {}
    for mode in ("serial", "concurrent"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g = graphs[mode] = graph_of(mode == "serial")
        if mode == "serial":
            g.run(steps)
            ref = ([s.clone() for s in g.states],
                   [a.clone() for a in getattr(g, "active", [])])
        else:
            saved = g._save()
            equal = 0
            for r in range(repeats):
                if r:
                    g._restore(saved)
                g.run(steps)
                equal += same(g, ref)
            del saved
        torch.cuda.synchronize()
        peak[mode] = (torch.cuda.max_memory_allocated() - base) / 2**20
        capture[mode] = g.capture_s
    per_replay = {m: g.per_replay for m, g in graphs.items()}
    check(equal == repeats, f"{tag} {label}: {repeats - equal} of {repeats} "
          f"repeats of {steps} concurrent steps differ from the serial ones")
    check(per_replay["serial"] == per_replay["concurrent"],
          f"{tag} {label}: launches a replay {per_replay}")
    times = {"serial": [], "concurrent": []}
    for i in range(pairs):
        for mode in (("serial", "concurrent") if i % 2 == 0
                     else ("concurrent", "serial")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graphs[mode].run(window)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0) / window)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"[{tag}] {label}: shards on their own streams against the serial "
        f"reference: {equal} of {repeats} repeats of {steps} captured steps "
        f"bit for bit; launches a replay {per_replay['concurrent']} (serial "
        f"the same); capture s concurrent {capture['concurrent']:.2f} serial "
        f"{capture['serial']:.2f}; peak MiB concurrent "
        f"{peak['concurrent']:.1f} serial {peak['serial']:.1f}; ms/step over "
        f"{pairs} alternated pairs of {window}-replay windows (host clock, "
        f"synced): concurrent median {med['concurrent']:.4f} (windows "
        f"{', '.join(f'{x:.4f}' for x in times['concurrent'])}), serial "
        f"median {med['serial']:.4f} (windows "
        f"{', '.join(f'{x:.4f}' for x in times['serial'])})")
    out = dict(equal=equal, peak=peak, times=times, med=med,
               capture=capture)
    if trace:
        prof = out["prof"] = {m: profile_replays(g, steps=trace, names=names)
                              for m, g in graphs.items()}
        log(f"[{tag}] {label}: torch.profiler over {trace} replays, "
            "concurrent / serial: " + "; ".join(
                f"{k} {fmt(prof['concurrent'][k])} / "
                f"{fmt(prof['serial'][k])}"
                for k in ("device_ms", "union_ms", "span_ms", "busy",
                          "kernels", "overlaps", "streams", "wall_ms"))
            + " (device_ms: the events' times summed a step, which shards "
            "on their own streams can make exceed union_ms, the time a "
            "step with a device event running; busy = union over span; "
            "overlaps: pairs of kernels of different streams overlapping in "
            f"the trace); kernels found {prof['concurrent']['found']}")
    return out


def phase_domain_parity(dev, use_pallas=None) -> None:
    """__graft_entry__.py::dryrun_multichip on the port: 8 shards of a
    128-particle cube in rightward flow (real migration), then forced
    overflow at cell capacity 2 and 1, then at cell capacity 1 at rest with
    the lattice shifted by 0.05 so that one shard alone overflows, each
    against the single-device step from the same state. On the kernels
    D1 and D2 launch once a shard a step where the rescue is on, and are
    held against their plain versions on the first step's inputs (at cell
    capacity 1 and in the one-shard case; there the overflowing shard's
    neighbours open their gates with nothing of their own dropped).
    ``use_pallas=False`` runs the shards' plain pair-block passes
    (ops/grid.py) in place of the kernels, at the same bars. At cell
    capacity 1 the mesh with a stream a shard is held against the serial
    reference (``concurrent_vs_serial``)."""
    import dataclasses
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import Container, _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    nsh = 8
    gx = 3 * nsh
    pts = wst.cube_fluid(8, 4, 4)
    flow = np.zeros_like(pts)
    flow[:, 0] = 3.0
    params = wst.SimParams.create(
        dim=3, device=dev, container=Container.create(
            (0.0, 0.0, 0.0), (gx * 0.25 - 1.0, 1.8, 1.8), device=dev))
    cfg = wst.SimConfig(n=pts.shape[0], dim=3, grid_dims=(gx, 8, 8),
                        cell_capacity=16)
    cap1 = dataclasses.replace(cfg, cell_capacity=1, rescue_capacity=512)
    mesh = mesh_mod.make_mesh(nsh, dev)
    cases = (("flow", cfg, 8, 0.0, flow),
             ("rescue cap 2", dataclasses.replace(
                 cfg, cell_capacity=2, rescue_capacity=512), 6, 0.0, flow),
             ("rescue cap 1", cap1, 6, 0.0, flow),
             ("rescue one shard", cap1, 6, 0.05, np.zeros_like(pts)))
    kernels = use_pallas is not False
    for label, c, steps, shift, vel in cases:
        state0 = wst.init_state(pts + np.float32(shift), vel, device=dev)
        states, active = domain.shard_state(state0, mesh, c, params,
                                            slack=float(nsh))
        raw = [int(o) for o in domain.halo_planes(
            [s.predicted for s in states], [s.vel for s in states], active,
            [params] * nsh, c, gx // nsh, mesh)[3]]
        step = domain.make_domain_step(mesh, c, use_pallas=use_pallas)
        before = [int(a.sum()) for a in active]
        lost = ovf = 0.0
        reset_launches()
        with recording_domain_rescue() as calls:
            states, active, lost_step = step(states, active, params)
        lost += float(lost_step)
        ovf += float(states[0].overflow)
        for _ in range(steps - 1):
            states, active, lost_step = step(states, active, params)
            lost += float(lost_step)
            ovf += float(states[0].overflow)
        after = [int(a.sum()) for a in active]
        counted = launches_now()
        want = {k: nsh * steps if kernels else 0
                for k in ("sph_build", "sph_density", "sph_force",
                          "sph_param_vector")}
        want.update({k: nsh * steps if kernels and c.rescue_capacity else 0
                     for k in DOMAIN_KERNELS})
        want["sph_integrate"] = want["sph_coeffs"] = nsh * steps
        check(all(counted[k] == v for k, v in want.items()),
              f"domain {label}: launches {counted}, expected {want}")
        single = wst.rollout(state0, params, c, steps)
        err = float(np.abs(sharded_by_id(states, active)
                           - by_id(single, "pos")).sum(axis=1).max())
        # the same steps captured (make_domain_rollout, a DomainGraph: the
        # plain pair-block step too, since its walk reads nothing on the
        # host) against the eager ones bit for bit
        states0, active0 = domain.shard_state(state0, mesh, c, params,
                                              slack=float(nsh))
        rolled, rolled_act, _ = domain.make_domain_rollout(
            mesh, c, use_pallas=use_pallas)(states0, active0, params, steps)
        check(all(same_state(a, b) for a, b in zip(rolled, states))
              and all(torch.equal(a, b) for a, b in zip(rolled_act, active)),
              f"domain {label}: captured != eager")
        path = "plain passes" if use_pallas is False else "kernels"
        if label == "rescue cap 1":
            def graph_of(serial, c=c, state0=state0):
                m = mesh_mod.make_mesh(nsh, dev, serial=serial)
                return graph_mod.DomainGraph(
                    domain.make_domain_step(m, c, use_pallas=use_pallas),
                    *domain.shard_state(state0, m, c, params,
                                        slack=float(nsh)),
                    _map_tensors(params, torch.clone), m)

            concurrent_vs_serial(
                "domain", f"parity {label} ({path}) on {nsh} shards",
                graph_of)
        gates = [int(a[3].count) for a in calls["density"]]
        log(f"[domain] parity {label} ({path}): {steps} steps (captured "
            f"= eager bit for bit), per-shard "
            f"counts {before} -> {after}, overflowing at step 0 by shard "
            f"{raw}, query rows (gates) at step 0 {gates or 'none'}, lost "
            f"{lost}, unrescued {ovf}, max |dpos| by id {err:.3e}, "
            f"launches {counted}")
        check(lost == 0.0, f"domain {label}: lost {lost} particles")
        check(ovf == 0.0, f"domain {label}: {ovf} unrescued")
        check(float(single.overflow_total) == 0.0,
              f"domain {label}: the single-device reference overflowed")
        check(err <= DOMAIN_TOL, f"domain {label}: parity {err:.3e}")
        if label == "flow":
            check(after != before, "domain flow: no shard crossing")
        if label.startswith("rescue"):
            check(sum(raw) > 0, f"domain {label} must overflow")
        if label == "rescue one shard":
            hot = [d for d, o in enumerate(raw) if o]
            check(len(hot) == 1, f"domain {label}: overflowing {raw}")
            if kernels:
                nb = [d for d in (hot[0] - 1, hot[0] + 1) if 0 <= d < nsh]
                check(all(gates[d] == raw[hot[0]] for d in nb),
                      f"domain {label}: neighbours' gates {gates}")
        if kernels and label in ("rescue cap 1", "rescue one shard"):
            errs = hold_domain_rescue(f"domain {label}", calls,
                                      check_changed=False)
            log(f"[domain] parity {label}: D1 and D2 against their plain "
                f"versions on step 1's inputs, every shard (count 0 "
                f"unchanged bit for bit where the gate is 0): max_abs_err "
                f"{errs}")


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


def phase_domain_full(record, scene="sharded-1m", dev="cuda",
                      pairs: int = 10, window: int = 10):
    """DistributedSimulation on ``scene``, 4 shards on the card, its step a
    replayed CUDA graph: 10 steps held by id against the single-device step
    from the same state (the first run warms up and captures), the kernels
    against their plain versions on halo-filled planes, one eager step
    under torch.cuda.set_sync_debug_mode("error"), 20 captured steps
    against 20 eager ones from the same state bit for bit, ``pairs``
    alternated windows of ``window`` eager and captured steps,
    torch.profiler over 20 replays (kernels a replay, summed and union
    device ms, busy share, overlapping kernels of different streams), and
    the mesh with a stream a shard against the serial reference
    (``concurrent_vs_serial``, 20 traced replays each). Then the forced
    rescue (phase_domain_rescue) and the migration settled
    (domain_migration). Returns the kernel launches of the
    30 captured steps and 30."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
    from water_sandbox_tpu_torch.runtime.distributed import (
        DistributedSimulation)
    t_phase = time.perf_counter()
    nsh, warm, same = 4, 10, 20
    cfg, params, state = wst.scenes.build(scene, device=dev)
    single = wst.rollout(state, params, cfg, warm)
    want = by_id(single, "pos")
    check(float(single.overflow_total) == 0.0,
          f"{scene}: the single-device reference overflowed")
    del single, state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sim = DistributedSimulation.from_scene(scene, n_shards=nsh, device=dev)
    check(sim.execution == "captured", f"{scene}: the step is not captured")

    reset_launches()
    sim.run(warm)
    launches = launches_now()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    g = sim.graph
    err = float(np.abs(sharded_by_id(sim.states, sim.active) - want)
                .sum(axis=1).max())
    log(f"[domain] {scene}: n={sim.cfg.n}, {warm} steps on {nsh} shards "
        f"(gx_loc {sim.cfg.grid_dims[0] // nsh}), max |dpos| by id vs "
        f"single device {err:.3e}; captured in {g.capture_s:.2f} s "
        f"(2 warm-up steps on a side stream, then one step), launches a "
        f"replay {g.per_replay}, peak memory above the shards' tensors "
        f"{peak:.1f} MiB (capture + {warm} replays)")
    check(err <= DOMAIN_TOL, f"{scene}: parity {err:.3e}")
    check(g.per_replay == {k: nsh for k in PARAM_KERNELS + (
                               "sph_build", "sph_density", "sph_force",
                               "sph_integrate") + DOMAIN_KERNELS},
          f"{scene}: launches a replay {g.per_replay}")
    domain_build_vs_plain(sim, 1, record)
    domain_kernels_vs_plain(sim, 1, record)

    def eager_copy():
        return ([s.clone() for s in sim.states],
                [a.clone() for a in sim.active])

    e_states, e_active = eager_copy()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.step(*eager_copy(), sim.params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for _ in range(same):
        e_states, e_active, _ = g.step(e_states, e_active, sim.params)
    reset_launches()
    sim.run(same)
    for k, v in launches_now().items():
        launches[k] += v
    check(all(same_state(a, b) and same_bits(a.acc, b.acc)
              for a, b in zip(sim.states, e_states))
          and all(torch.equal(a, b) for a, b in zip(sim.active, e_active)),
          f"{scene}: {same} captured and eager steps differ")
    log(f"[domain] {scene}: the eager step ran under "
        f"torch.cuda.set_sync_debug_mode('error'); {same} captured steps "
        f"from step {warm} equal {same} eager ones bit for bit (pos, vel, "
        f"density, ids, acc, active)")

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    e_states, e_active = eager_copy()
    for _ in range(window):
        e_states, e_active, _ = g.step(e_states, e_active, sim.params)
    torch.cuda.synchronize()
    peak_eager = (torch.cuda.max_memory_allocated() - base) / 2**20
    times = {"eager": [], "captured": []}
    for i in range(pairs):
        for mode in (("eager", "captured") if i % 2 == 0
                     else ("captured", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                for _ in range(window):
                    e_states, e_active, _ = g.step(e_states, e_active,
                                                   sim.params)
            else:
                g.run(window)
            torch.cuda.synchronize()
            times[mode].append(1e3 * (time.perf_counter() - t0) / window)
    med = {k: statistics.median(v) for k, v in times.items()}
    ratios = [a / b for a, b in zip(times["eager"], times["captured"])]
    log(f"[main] {scene} on {nsh} shards, {pairs} pairs of {window}-step "
        f"windows alternated (host clock, synced at each window's end): "
        f"captured median {med['captured']:.4f} ms/step (windows "
        f"{', '.join(f'{x:.4f}' for x in times['captured'])}); eager median "
        f"{med['eager']:.4f} (windows "
        f"{', '.join(f'{x:.4f}' for x in times['eager'])}); eager/captured "
        f"median ratio {statistics.median(ratios):.3f}; peak memory of "
        f"{window} eager steps above their state {peak_eager:.1f} MiB")
    del e_states, e_active
    prof = profile_replays(g, names=DOMAIN_KERNEL_NAMES)
    log(f"[domain] {scene} torch.profiler over {prof['steps']} replays: "
        f"device ms a step {prof['device_ms']:.4f} (events summed), "
        f"kernels a step {prof['kernels']:.1f}, step kernels found "
        f"{prof['found']}, busy share {fmt(prof['busy'])} on the trace's "
        f"clock (device events' union {prof['union_ms']:.4f} over the span "
        f"{prof['span_ms']:.4f} ms a step; the summed device ms may "
        f"exceed the union with the shards on their own streams); kernel "
        f"pairs of different streams overlapping in the trace "
        f"{fmt(prof['overlaps'])} over {prof['streams']} streams; host "
        f"clock a step {prof['wall_ms']:.4f} without the profiler, "
        f"{prof['traced_ms']:.4f} traced; the 8 largest by name, device ms "
        f"a step: " + "; ".join(f"{n} {ms:.4f}" for n, ms in prof["top"]))
    if prof["kernels"] > 0:
        check(all(v == nsh * prof["steps"] for v in prof["found"].values()),
              f"{scene}: the trace of {prof['steps']} replays holds the "
              f"domain kernels {prof['found']} times")
        check(prof["overlaps"] is None or prof["overlaps"] > 0,
              f"{scene}: no two shards' kernels overlap in the trace")

    def graph_of(serial):
        m = mesh_mod.make_mesh(nsh, dev, serial=serial)
        return graph_mod.DomainGraph(
            domain.make_domain_step(m, sim.cfg, mig_cap=1024),
            [s.clone() for s in sim.states], [a.clone() for a in sim.active],
            _map_tensors(sim.params, torch.clone), m)

    concurrent_vs_serial(
        "domain", f"{scene} on {nsh} shards from step "
        f"{int(sim.states[0].step_count)}", graph_of, trace=20)

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
    for k in PARAM_KERNELS + ("sph_build", "sph_density", "sph_force",
                              "sph_integrate") + DOMAIN_KERNELS:
        check(launches[k] == nsh * (warm + same),
              f"{scene}: {k} launched {launches[k]} times in "
              f"{warm + same} steps on {nsh} shards")
    log(f"[main] {scene} on {nsh} shards ({st['execution']}): "
        f"DistributedSimulation ms/step {st['ms_per_step']:.3f} (host clock "
        f"over the runs after the first), lost_total "
        f"{st['lost_particles']}, overflow_total {st['overflow_total']}, "
        f"per-shard counts {st['per_shard_counts']}, ke "
        f"{st['kinetic_energy']:.2f}, launches {launches}")
    phase_domain_rescue(sim, record)
    domain_migration(sim, scene)
    log(f"[domain] phase passed in {time.perf_counter() - t_phase:.1f} s")
    return launches, warm + same


def carried_gaps(got, want, params, rows) -> tuple:
    """The carried fields of ``got`` against ``want`` (states in id order)
    on the rows ``rows`` marks, by the benchmark check's gaps
    (``sphbench/check.py``): the worst of the densities and pressures,
    relative to the wanted density (k times it for pressures), and of the
    accelerations, over the wanted ones' rms on those rows."""
    from sphbench import check as bench_check, inputs
    prm = {k: float(getattr(params, k)) for k in inputs.PARAM_NAMES}
    prm["gravity"] = [float(x) for x in params.gravity]
    keep = rows.cpu().numpy()

    def on_rows(state):
        d = bench_check.by_id(state)
        return {k: v[keep] if isinstance(v, np.ndarray) else v
                for k, v in d.items()}
    g, w = on_rows(got), on_rows(want)
    w.update(predicted_alt=w["predicted"], vel_alt=w["vel"])
    gaps = bench_check._gaps(g, w, prm, int(got.step_count))
    return gaps["density"], gaps["acc"]


def domain_migration(sim, scene: str, settle: int = 600,
                     window: int = 50) -> None:
    """The migration of ``sim`` (a DistributedSimulation) on the settled
    scene: the particles that change shards a step, by the graph's
    counter over ``window`` replays from step ``settle``; then one more
    step, whose moved particles' carried fields (density, near density,
    pressures, acceleration) are held by id against one single-device step
    from the same state (the migration once left them in the old slot,
    which read ~1 here)."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.parallel import domain
    g = sim.graph
    sim.run(max(1, settle - int(sim.states[0].step_count)))
    start, before = int(sim.states[0].step_count), int(g.migrated)
    sim.run(window)
    per_step = (int(g.migrated) - before) / window
    pre, shard_pre = domain.dense_by_id(sim.states, sim.active)
    check(torch.equal(pre.ids.long(),
                      torch.arange(pre.n, device=pre.ids.device)),
          f"{scene}: the sharded ids are no permutation")
    before = int(g.migrated)
    sim.run(1)
    post, shard_post = domain.dense_by_id(sim.states, sim.active)
    moved = shard_post != shard_pre
    single = wst.step(pre, sim.params, sim.cfg)
    gaps = carried_gaps(post, single, sim.params, moved)
    stayed = carried_gaps(post, single, sim.params, ~moved)
    n_moved = int(moved.sum())
    log(f"[domain] {scene} migration from step {start}: {per_step:.2f} "
        f"particles changed shards a step ({window} replays, "
        f"DomainGraph.migrated; stats()['migrated_particles'] "
        f"{sim.stats()['migrated_particles']} over every step run); one "
        f"more step moved {n_moved} (the counter: "
        f"{int(g.migrated) - before}), their carried fields by id against "
        f"one single-device step from the same state (densities and "
        f"pressures, acc): {gaps[0]:.3e}, {gaps[1]:.3e}; the rows that "
        f"stayed: {stayed[0]:.3e}, {stayed[1]:.3e}")
    check(n_moved > 0 and int(g.migrated) - before == n_moved,
          f"{scene}: {n_moved} moved, the counter read "
          f"{int(g.migrated) - before}")
    check(gaps[0] <= 1e-4 and gaps[1] <= 1e-2,
          f"{scene}: the moved particles' fields {gaps}")


def domain_rescue_bounds(args, cfg_loc, h):
    """Both bounds of D1 and D2 at one shard's recorded D1 inputs, from
    this run's data: (sweep, walk, facts).

    sweep: the all-pairs sweep's work (the plain versions'): every valid
    query row against every slot, the shard's own rows also against every
    halo slot and the neighbours' rows, 3·dim - 1 flops a distance test;
    bytes: every row's fields once. walk: the kernels' work: the rows in
    the valid query rows' clamped neighbour runs, tested once a side, the
    halo slots of the own rows' windows, the neighbours' rows; bytes: the
    rows in those runs and the halo slots read, each once (the residents
    among them written once), the query rows and their outputs. Both count
    the pairs within h at 7 (density) and 20 + 5·dim (force) flops a
    side."""
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    from water_sandbox_tpu_torch.ops.cuda import rescue as rk
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    pred, walk, addr, q = args[:4]
    n, dim = pred.shape
    R = q.row.shape[0]
    g = sb._geometry(cfg_loc)
    cap_p = sb._cap_pad(cfg_loc.cell_capacity)
    v = q.valid
    nv, mine = int(v.sum()), int(v[:R].sum())
    act = dr.active_rows(walk, cfg_loc)
    rows = pred[act]
    qp = q.pos[v]
    p_h = sum(int((torch.cdist(
        qp[i:i + 256], rows,
        compute_mode="donot_use_mm_for_euclid_dist") <= h).sum())
        for i in range(0, nv, 256))
    cols = q.col[v]
    lo, hi = rk.neighbour_runs(cols, cfg_loc)
    s64 = walk.skey.long()
    ok = lo <= hi
    b = torch.where(ok, torch.searchsorted(s64, lo), 0)
    e = torch.where(ok, torch.searchsorted(s64, hi + 1), 0)
    cand = int((e - b).sum())
    cand_mine = int((e - b)[:mine].sum())
    delta = torch.zeros(n + 1, dtype=torch.int64, device=pred.device)
    delta.index_add_(0, b.reshape(-1), torch.ones_like(b.reshape(-1)))
    delta.index_add_(0, e.reshape(-1), -torch.ones_like(e.reshape(-1)))
    covered = torch.cumsum(delta, 0)[:n] > 0             # by position
    res_sorted = (addr < cap_p * g.L)[walk.order.long()]
    u = int(covered.sum())
    u_res = int((covered & res_sorted).sum())
    # the own rows' halo lanes: the runs of their own x row, in the left
    # halo at x = 0 and the right one at x = gx - 1
    x = cols[:mine].long() // g.S_pad
    mids = slice(3, 6) if dim == 3 else slice(1, 2)
    width = torch.where(ok[:mine, mids], hi[:mine, mids] - lo[:mine, mids]
                        + 1, 0).sum(dim=1)
    sides = (x == 0).long() + (x == g.gx - 1).long()
    halo_items = int((width * sides).sum()) * cap_p
    lanes = []
    for side, at in ((0, g.PAD - g.S_pad), (g.gx - 1, g.PAD + g.gx * g.S_pad)):
        sel = x == side
        for r in range(mids.start, mids.stop):
            for o in range(3):
                lane = lo[:mine, r] + o
                keep = sel & ok[:mine, r] & (lane <= hi[:mine, r])
                lanes.append(at + lane[keep] - x[keep] * g.S_pad)
    halo_slots = (int(torch.unique(torch.cat(lanes)).numel()) * cap_p
                  if lanes else 0)
    Hn = 2 * cap_p * g.S_pad
    nq = 3 * R
    residents = int((addr < cap_p * g.L).sum())
    tests = (nv * n + mine * (Hn + 2 * R)) * (3 * dim - 1)
    walk_tests = (cand + cand_mine + halo_items + mine * 2 * R) * (
        3 * dim - 1)
    f_pair = 20 + 5 * dim
    sweep = {
        "sph_domain_rescue_density": bound(
            tests + 2 * 7 * p_h,
            n * (4 * dim + 4) + Hn * 4 * dim + nq * 4 * dim
            + residents * (4 + 8 + 24) + mine * 8),
        "sph_domain_rescue_force": bound(
            tests + 2 * f_pair * p_h,
            n * (8 * dim + 24) + Hn * (8 * dim + 8)
            + nq * 4 * (2 * dim + 4) + residents * 8 * dim
            + mine * 4 * dim),
    }
    walk_b = {
        # a row in the runs: pred, its key and position; a resident among
        # them: addr, den and nden read, 6 planes written; a halo slot:
        # its position; a query row: pos, column, its list entry; an own
        # row: den and nden written
        "sph_domain_rescue_density": bound(
            walk_tests + 2 * 7 * p_h,
            u * (4 * dim + 8) + u_res * (4 + 8 + 24)
            + halo_slots * 4 * dim + nq * (4 * dim + 12) + mine * 8),
        # a row in the runs: pred, vel, den, nden, prs, nprs, slot, key,
        # position; a resident: acc read and written; a halo slot: pos,
        # vel, den, nden; a query row: its 2·dim + 4 fields, column, entry;
        # an own row: its row index, acc written
        "sph_domain_rescue_force": bound(
            walk_tests + 2 * f_pair * p_h,
            u * (8 * dim + 28) + u_res * 8 * dim
            + halo_slots * (8 * dim + 8) + nq * (4 * (2 * dim + 4) + 12)
            + mine * (4 + 4 * dim)),
    }
    facts = dict(p_h=p_h, tests=tests, cand=cand, walk_rows=u,
                 halo_slots=halo_slots, query_rows=nv, own_rows=mine)
    return sweep, walk_b, facts


def phase_domain_rescue(sim, record, shard: int = 1) -> None:
    """[domain-rescue]: ``sim``'s state (sharded-1m after its captured
    steps), stepped once more with the rescue's inputs recorded: at the
    scene's cell capacity (no overflow: every gate 0; D1 and D2 change
    nothing, bit for bit, and are timed there), then at the highest cell
    capacity of 16, 12, 8, 6, 4, 3, 2 at which every shard drops at least
    R rows (every gate open). There D1 and D2 are held against their plain
    versions on every shard and timed on shard ``shard`` (event ms,
    profiler device ms, the plain versions' ms) beside both bounds
    (domain_rescue_bounds), and the rescue step is timed, captured and
    eager, from the same state."""
    import dataclasses
    from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.parallel import domain
    from water_sandbox_tpu_torch.core.params import _map_tensors
    t_phase = time.perf_counter()
    mesh, nsh = sim.mesh, sim.mesh.size
    gx_loc = sim.cfg.grid_dims[0] // nsh
    h = float(sim.params.smoothing_radius)
    P = sim.states[0].n
    R = min(256, sim.cfg.rescue_capacity, P)

    def copies():
        return ([s.clone() for s in sim.states],
                [a.clone() for a in sim.active])

    with recording_domain_rescue() as calls0:
        sim.graph.step(*copies(), sim.params)
    gates0 = [int(a[3].count) for a in calls0["density"]]
    check(max(gates0) == 0, f"[domain-rescue] count 0: gates {gates0}")
    hold_domain_rescue("[domain-rescue] count 0", calls0)
    zero = {"sph_domain_rescue_density": clone_args(calls0["density"][shard]),
            "sph_domain_rescue_force": clone_args(calls0["force"][shard])}

    for cap in (16, 12, 8, 6, 4, 3, 2):
        c = dataclasses.replace(sim.cfg, cell_capacity=cap)
        raw = [int(o) for o in domain.halo_planes(
            [s.predicted for s in sim.states], [s.vel for s in sim.states],
            sim.active, [sim.params] * nsh, c, gx_loc, mesh)[3]]
        if min(raw) >= R:
            break
    check(min(raw) >= R, f"[domain-rescue] no capacity drops {R} rows a "
          f"shard: {raw}")
    step = domain.make_domain_step(mesh, c, mig_cap=1024)
    with recording_domain_rescue() as calls:
        out, _, _ = step(*copies(), sim.params)
    gates = [int(a[3].count) for a in calls["density"]]
    errs = hold_domain_rescue(f"[domain-rescue] cap {cap}", calls)
    log(f"[domain-rescue] {sim.name} step {int(sim.states[0].step_count)} "
        f"at cell capacity {cap}: dropped rows by shard {raw}, R {R}, "
        f"query rows (gates) {gates}, unrescued after the step "
        f"{int(out[0].overflow)}; D1 and D2 against their plain versions "
        f"on every shard: max_abs_err {errs}; at cell capacity "
        f"{sim.cfg.cell_capacity} every gate 0 and both kernels left their "
        f"outputs bit for bit")

    cfg_loc = domain._local_cfg(c, gx_loc)
    sweep, walk_b, facts = domain_rescue_bounds(calls["density"][shard],
                                                cfg_loc, h)
    for name, half, plain_fn in (
            ("sph_domain_rescue_density", "density",
             lambda a: dr.density_plain(*a[:8], a[8], a[9], a[11])),
            ("sph_domain_rescue_force", "force",
             lambda a: dr.force_plain(*a[:15], a[16]))):
        args = calls[half][shard]
        kernel = dr.rescue_density if half == "density" else dr.rescue_force
        scratch, scratch0 = clone_args(args), zero[name]
        kname = name.replace("sph_", "").replace("_rescue", "") + "_kernel"
        rec = dict(max_abs_err=errs[name],
                   ms=cuda_ms(lambda: kernel(*scratch)),
                   device_ms=device_ms(lambda: kernel(*scratch), kname),
                   plain_ms=cuda_ms(lambda: plain_fn(clone_args(args)),
                                    reps=3),
                   library_ms=None,
                   ms_count0=cuda_ms(lambda: kernel(*scratch0)),
                   device_ms_count0=device_ms(lambda: kernel(*scratch0),
                                              kname),
                   cell_capacity=cap, **facts)
        rec["bound_ms"], rec["bound_by"] = walk_b[name]
        rec["sweep_bound_ms"], rec["sweep_bound_by"] = sweep[name]
        record.setdefault(name, {})[f"sharded-1m forced rescue shard "
                                    f"{shard}"] = rec
        log(f"[domain-rescue] {name} shard {shard} at cell capacity {cap}: "
            f"{facts['own_rows']} own and {facts['query_rows']} query rows "
            f"of {P} slots: kernel_ms={rec['ms']:.4f} device_ms="
            f"{fmt(rec['device_ms'])} plain_ms={rec['plain_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.3e} ({rec['bound_by']}; cell "
            f"list: {facts['cand']} candidate rows, {facts['walk_rows']} "
            f"rows in the runs, {facts['halo_slots']} halo slots) "
            f"sweep_bound_ms={rec['sweep_bound_ms']:.3e} "
            f"({rec['sweep_bound_by']}; {facts['tests']} distance-test "
            f"flops) library_ms=none; at count 0 (cell capacity "
            f"{sim.cfg.cell_capacity}): kernel_ms={rec['ms_count0']:.4f} "
            f"device_ms={fmt(rec['device_ms_count0'])} (pairs within h of "
            f"a query row {facts['p_h']})")

    # the rescue step, captured and eager, from the same state
    gr = graph_mod.DomainGraph(step, *copies(),
                               _map_tensors(sim.params, torch.clone), mesh)
    gr.run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gr.run(5)
    torch.cuda.synchronize()
    ms_c = 1e3 * (time.perf_counter() - t0) / 5
    e_states, e_active = copies()
    step(e_states, e_active, sim.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        e_states, e_active, _ = step(e_states, e_active, sim.params)
    torch.cuda.synchronize()
    ms_e = 1e3 * (time.perf_counter() - t0) / 5
    log(f"[domain-rescue] {sim.name} at cell capacity {cap}, a rescue on "
        f"every shard every step: captured {ms_c:.4f} ms/step (5 replays "
        f"after the capture, {gr.capture_s:.2f} s), eager {ms_e:.4f} "
        f"ms/step (5 steps after one), host clock, synced; launches a "
        f"replay {gr.per_replay}")
    del gr
    log(f"[domain-rescue] phase passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


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
            reset_launches()
            gk, gv = bs.sort_pairs(keys, vals)
            launches = launches_now()["bitonic_sort"]
            check(launches == 1, f"sort n={n} {kind}: {launches} launches")
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
    reset_launches()
    sk, order = bs.argsort_keys(keys)
    launches = launches_now()["bitonic_sort"]
    wk, worder = bs.sort_pairs_plain(
        keys, torch.arange(keys.shape[0], dtype=torch.int32, device=dev))
    check(bool(torch.equal(sk, wk) and torch.equal(order, worder)),
          "argsort_keys: kernel and plain differ")
    check(bool(torch.equal(keys[order.long()], sk)), "argsort_keys order")
    log(f"[sort] argsort_keys on reference-cube's {keys.shape[0]} cell "
        f"keys: bit-identical to the plain version, launches {launches}")
    check(launches == 1, "argsort_keys did not launch the kernel")
    return launches


# A front-end entry point (``python -m <module> <argv>``) in a subprocess on
# the card, with the kernel launch counts set to 0 before it and printed
# as its last line after it.
_COUNTED = """
import json, runpy, sys
from water_sandbox_tpu_torch.ops.cuda import _build
_build.reset_launches()
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
print("[launches] " + json.dumps(_build.LAUNCHES))
"""

ROOT = Path(__file__).resolve().parent
FRONT_OUT = ROOT / "build" / "chip_smoke"


def _front_env() -> dict:
    return {k: v for k, v in os.environ.items() if k != "WST_FORCE_CPU"}


def run_front(module: str, *argv: str, timeout: float = 600.0):
    """``python -m module argv`` on the card; returns its stdout lines (the
    counts' line taken off) and its kernel launches. Raises on a non-zero
    exit (the child is killed at ``timeout``)."""
    out = subprocess.run([sys.executable, "-c", _COUNTED, module, *argv],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_front_env(), timeout=timeout)
    if out.returncode != 0:
        log(out.stdout[-3000:])
        log(out.stderr[-3000:])
        raise AssertionError(f"{module} {' '.join(argv)}: exit "
                             f"{out.returncode}")
    lines = out.stdout.splitlines()
    check(lines[-1].startswith("[launches] "), f"{module}: no launch counts")
    return lines[:-1], json.loads(lines[-1][len("[launches] "):])


def check_launches(path: str, launches: dict, steps: int,
                   rescue_steps: int | None = None,
                   rebuilt: int | None = None) -> None:
    """The eight main-path kernels once a step (the coefficients', the
    parameter vector's, the build's, the density and force kernels, both
    halves of the rescue, which gate themselves on the device, and the
    integrate kernel), the sort never. The incremental
    path (one ``run()``, ``rescue_steps`` and ``rebuilt`` given, from the
    graph's device counts) launches the rescue's two and the integrate
    kernel (on the dropped rows) only inside its drop-step branches, on
    the steps that have dropped particles, and the build once on entry
    (the cache built from the state) and once a rebuild step."""
    for k in STEP_KERNELS:
        if rescue_steps is None:
            want = steps
        elif k == "sph_build":
            want = rebuilt + 1
        elif k in PARAM_KERNELS + ("sph_density", "sph_force"):
            want = steps
        else:
            want = rescue_steps
        check(launches[k] == want,
              f"{path}: {k} launched {launches[k]} times in {steps} steps "
              f"(expected {want})")
    check(launches["bitonic_sort"] == 0, f"{path}: the sort ran")
    for k in DOMAIN_KERNELS:
        check(launches.get(k, 0) == 0, f"{path}: {k} ran off the domain step")


def check_final(label: str, state, params, n: int) -> None:
    """A state a front end left: every particle there, finite, inside the
    box, none dropped."""
    check(state.n == n, f"{label}: {state.n} particles, not {n}")
    check(bool(torch.isfinite(state.pos).all()), f"{label}: non-finite")
    check(bool((box_local(params, state).abs()
                <= params.container.half_size + 1e-4).all()),
          f"{label}: particles outside the box")
    check(float(state.overflow_total) == 0.0, f"{label}: overflow_total > 0")


def phase_cli(paths: dict) -> None:
    """Every stepping subcommand of ``python -m water_sandbox_tpu_torch.cli``
    as a subprocess on the card: ``scenes``; ``run`` at its default scene
    (``dam-break-2d-4k``, 2-D) and at ``reference-cube``, each with a
    trajectory and a checkpoint; ``resume`` from the latter, held by id
    against the same continuation in this process; ``bench``."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.io.export import load_trajectory
    from water_sandbox_tpu_torch.runtime import checkpoint
    cli = "water_sandbox_tpu_torch.cli"
    shutil.rmtree(FRONT_OUT, ignore_errors=True)
    FRONT_OUT.mkdir(parents=True)

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", cli, "scenes"],
                         capture_output=True, text=True, cwd=ROOT,
                         env=_front_env(), timeout=120)
    check(out.returncode == 0, f"cli scenes: exit {out.returncode}")
    listed = sorted(ln.split()[0] for ln in out.stdout.splitlines())
    check(listed == wst.scenes.names(), f"cli scenes listed {listed}")
    log(f"[cli] scenes: {len(listed)} scenes ({time.perf_counter() - t0:.1f}"
        " s)")

    for scene, steps, every in (("dam-break-2d-4k", 300, 100),
                                ("reference-cube", 100, 50)):
        t0 = time.perf_counter()
        traj = FRONT_OUT / f"{scene}-traj.npz"
        ck = FRONT_OUT / f"{scene}-end.npz"
        argv = ["run", "--steps", str(steps), "--record-every", str(every),
                "--export", str(traj), "--checkpoint", str(ck)]
        if scene == "dam-break-2d-4k":
            argv.append("--preview")        # and the CLI's default scene
        else:
            argv += ["--scene", scene]
        lines, launches = run_front(cli, *argv)
        stats = json.loads(next(ln for ln in lines if ln.startswith("{")))
        check(stats["step"] == steps, f"cli run {scene}: step {stats['step']}")
        if scene == "dam-break-2d-4k":
            check(sum(ln.startswith("--- step") for ln in lines)
                  == steps // every, "cli run: preview frames")
        state, params, cfg = checkpoint.load(str(ck))
        check(int(state.step_count) == steps, f"cli run {scene}: checkpoint")
        check_final(f"cli run {scene}", state, params, cfg.n)
        pos, times, meta = load_trajectory(str(traj))
        check(pos.shape == (steps // every + 1, cfg.n, cfg.dim)
              and meta == {"scene": scene} and np.isfinite(pos).all(),
              f"cli run {scene}: trajectory {pos.shape}")
        check_launches(f"cli run {scene}", launches, steps)
        paths[f"cli run {scene}"] = (launches, steps)
        log(f"[cli] run {scene}: {steps} steps, n={cfg.n}, dim {cfg.dim}, "
            f"overflow_total 0, {pos.shape[0]} trajectory frames, ms/step "
            f"{stats['ms_per_step']:.3f} (its own stats), ke "
            f"{stats['kinetic_energy']:.2f}, launches {launches} "
            f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    ck = FRONT_OUT / "reference-cube-end.npz"
    resumed = FRONT_OUT / "reference-cube-resumed.npz"
    lines, launches = run_front(cli, "resume", "--checkpoint", str(ck),
                                "--steps", "20", "--out", str(resumed))
    stats = json.loads(next(ln for ln in lines if ln.startswith("{")))
    check(stats["step"] == 120, f"cli resume: step {stats['step']}")
    got, params, cfg = checkpoint.load(str(resumed))
    check_final("cli resume", got, params, cfg.n)
    state, params, cfg = checkpoint.load(str(ck))
    sim = wst.Simulation(cfg, params, state)
    sim.run(20)
    err = hold("cli resume vs in-process", by_id(got, "pos"),
               by_id(sim.state, "pos"))
    check_launches("cli resume", launches, 20)
    paths["cli resume"] = (launches, 20)
    log(f"[cli] resume reference-cube from step 100: step 120, max |dpos| "
        f"by id vs the same 20 steps in this process {err:.3e} (exactly 0: "
        f"{err == 0.0}), launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    lines, launches = run_front(cli, "bench", "--scene", "reference-cube",
                                "--steps", "20")
    res = json.loads(lines[-1])
    check(res["n"] == 65536 and res["particle_steps_per_s"] > 0,
          f"cli bench: {res}")
    check_launches("cli bench", launches, 21)
    paths["cli bench"] = (launches, 21)
    log(f"[cli] bench: {json.dumps(res)} ({time.perf_counter() - t0:.1f} s)")


def phase_profile(paths: dict) -> None:
    """runtime/profiling.py's device_trace around 5 steps of
    Simulation.from_scene("reference-cube").run after 5 of warm-up, five
    replays of the captured step: the trace must hold each of the step's
    eight kernels (the coefficients', the parameter vector's, the build's,
    K1, K2, R1, R2, the integrate's) 5 times, or 4 where the trace lost
    the first replay's head with the marker of the kernel's phase.
    The launch counts on a replayed path are the capture's counts times the
    replays, so this trace is what shows the replays run every kernel. The
    replays also carry the step's phase markers (``profiling.phase``), six
    a step in order, and no program span (``wst.*``, host only) is among
    the device's events."""
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.runtime import profiling
    sim = wst.Simulation.from_scene("reference-cube")
    sim.run(5)
    logdir = FRONT_OUT / "profile"
    reset_launches()
    with profiling.device_trace(str(logdir)):
        sim.run(5)
    launches = launches_now()
    check_launches("profile", launches, 5)
    paths["profile"] = (launches, 5)
    with open(logdir / "trace.json") as f:
        every = json.load(f)["traceEvents"]
    events = [e for e in every if e.get("cat") == "kernel"]
    marks = [e["name"][len("wst_phase_"):]
             for e in sorted(events, key=lambda e: e["ts"])
             if e["name"].startswith("wst_phase_")]
    step = ["build", "density", "rescue", "force", "rescue", "integrate"]
    # a profiler session after others in one process can lose its first
    # device events (PERF.md §7): only the head of the first replay may lack
    lost = len(step) * 5 - len(marks)
    check(0 <= lost < len(step) and marks == (step * 5)[lost:],
          f"profile: phase markers {marks[:12]}")
    on_device = {e["name"] for e in every
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset",
                                     "gpu_user_annotation")}
    check(not [n for n in on_device if n.startswith("wst.")],
          "profile: a program span among the device's events")
    check("wst.run" in {e.get("name") for e in every},
          "profile: no wst.run span")
    # each kernel by the index in ``step`` of the phase it runs in; the
    # names may be mangled C++ names: match the kernel's name inside
    phase_of = {"sph_coeffs_kernel": 0, "sph_build_kernel": 0,
                "sph_param_vector_kernel": 1, "sph_density_kernel": 1,
                "rescue_density_kernel": 2, "sph_force_kernel": 3,
                "rescue_force_kernel": 4, "sph_integrate_kernel": 5}
    found = {k: [e for e in events if k in e["name"]] for k in phase_of}
    for k, evs in found.items():
        # the lost head of the first replay takes the runs of the phases
        # whose markers it took
        least = 4 if phase_of[k] < lost else 5
        check(least <= len(evs) <= 5, f"profile: {k} {len(evs)} times in "
              f"the trace of {len(events)} kernels, {lost} phase markers "
              f"lost (first names: "
              f"{sorted({e['name'][:60] for e in events})[:8]})")
    total_us = sum(e.get("dur", 0.0) for e in events)
    each = ", ".join(f"{k} {len(evs)} times "
                     f"({sum(e['dur'] for e in evs) / 5e3:.4f} ms a step)"
                     for k, evs in found.items())
    log(f"[profile] reference-cube steps 6-10 under device_trace: "
        f"{len(events)} kernels in the trace ({len(marks)} phase markers "
        f"in order, {lost} lost at the trace's head), {each}, all kernels "
        f"{total_us / 5e3:.4f} ms a step, launches {launches}")


def phase_live(paths: dict) -> None:
    """viz/live.py::run_live on reference-cube for 3 frames of 4 steps, on
    a stub terminal that types w, then Space."""
    import io
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.viz import live
    keys = iter([["w"], [" "], []])

    class StubTerminal:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read_keys(self):
            return next(keys, [])

    sim = wst.Simulation.from_scene("reference-cube")
    k0 = float(sim.params.pressure_scalar)
    out = io.StringIO()
    saved, live._RawTerminal = live._RawTerminal, StubTerminal
    reset_launches()
    t0 = time.perf_counter()
    try:
        live.run_live(sim, steps_per_frame=4, max_frames=3, out=out)
    finally:
        live._RawTerminal = saved
    sec = time.perf_counter() - t0
    launches = launches_now()
    check(abs(float(sim.params.pressure_scalar) - (k0 + 0.1)) < 1e-5,
          "live: w did not raise the pressure")
    check(int(sim.state.step_count) == 4, "live: Space did not reset")
    text = out.getvalue()
    check("\x1b[48;5;" in text and "pressure_scalar -> " in text
          and "scene reset" in text, "live: frames")
    check_launches("live", launches, 12)
    paths["live"] = (launches, 12)
    log(f"[live] reference-cube, 3 frames of 4 steps: w raised "
        f"pressure_scalar to {float(sim.params.pressure_scalar):.2f}, Space "
        f"reset to step 0, step {int(sim.state.step_count)} at the end, "
        f"{len(text)} characters written, {sec:.2f} s, launches {launches}")


def _get(url: str) -> bytes:
    import urllib.request
    return urllib.request.urlopen(url, timeout=10).read()


def _next_frame(base: str, want=lambda f: True, wait: float = 30.0) -> dict:
    deadline = time.perf_counter() + wait
    while time.perf_counter() < deadline:
        body = _get(f"{base}/state.json")
        if body != b"{}":
            frame = json.loads(body)
            if want(frame):
                return frame
        time.sleep(0.02)
    raise AssertionError(f"viewer: no such frame within {wait} s")


def serve_and_check(scene: str, mode: str, paths: dict) -> None:
    """A ViewerServer on port 0 stepping ``scene`` in a thread: its first
    frame, the keymap and the mouse field over HTTP, its frame rate over a
    few seconds; stopped within 30 s."""
    import base64
    import threading
    import water_sandbox_tpu_torch as wst
    from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs
    from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
    from water_sandbox_tpu_torch.viz.server import ViewerServer
    sim = wst.Simulation.from_scene(scene)
    sim.run(4)
    server = ViewerServer(sim, port=0)
    check(server.render == mode, f"viewer {scene}: render {server.render}")
    step0 = int(sim.state.step_count)
    reset_launches()
    thread = threading.Thread(target=server.serve,
                              kwargs={"max_seconds": 120.0})
    thread.start()
    host, port = server.httpd.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        frame = _next_frame(base)
        if mode == "raster":
            den = np.frombuffer(base64.b64decode(frame["den"]), np.uint8)
            check(den.size == frame["rw"] * frame["rh"] and den.max() > 0,
                  f"viewer {scene}: empty density raster")
            what = (f"density raster {frame['rw']}x{frame['rh']}, "
                    f"{int((den > 0).sum())} lit pixels")
        else:
            pos = np.frombuffer(base64.b64decode(frame["pos"]), np.float32)
            check(pos.size == sim.cfg.n * sim.cfg.dim
                  and np.isfinite(pos).all(), f"viewer {scene}: points")
            what = f"{pos.size // sim.cfg.dim} points"
        k0 = float(sim.params.pressure_scalar)
        check("pressure_scalar" in _get(f"{base}/key?k=w").decode()
              and abs(float(sim.params.pressure_scalar) - (k0 + 0.1)) < 1e-5,
              f"viewer {scene}: /key?k=w")
        aim = [1.0, -0.5, 0.25][:sim.cfg.dim]
        q = "&".join(f"{a}={v}" for a, v in zip("xyz", aim))
        check("field" in _get(f"{base}/field?{q}&s=-20").decode()
              and float(sim.params.field.strength) == -20.0
              and np.allclose(sim.params.field.position.cpu().numpy(), aim),
              f"viewer {scene}: /field did not aim the field")
        _next_frame(base, lambda f: f.get("field", {}).get("s") == -20.0)
        check("off" in _get(f"{base}/field?off=1").decode()
              and float(sim.params.field.strength) == 0.0,
              f"viewer {scene}: /field?off=1")
        s1, t1 = int(sim.state.step_count), time.perf_counter()
        time.sleep(3.0)
        s2, t2 = int(sim.state.step_count), time.perf_counter()
        nbytes = len(_get(f"{base}/state.json"))
    finally:
        server.stop()
        thread.join(timeout=30)
    check(not thread.is_alive(), f"viewer {scene}: did not stop in 30 s")
    launches = launches_now()
    steps = int(sim.state.step_count) - step0
    check_launches(f"viewer {scene}", launches, steps)
    paths[f"viewer {scene}"] = (launches, steps)
    fps = (s2 - s1) / server.steps_per_frame / (t2 - t1)
    log(f"[viewer] {scene} ({mode}, n={sim.cfg.n}): first frame {what}; "
        f"/key?k=w raised pressure_scalar by 0.1, /field aimed and cleared "
        f"the field; {fps:.1f} frames served a second ({s2 - s1} steps of "
        f"{server.steps_per_frame} a frame in {t2 - t1:.2f} s), "
        f"{nbytes} bytes a frame; stopped; launches {launches} in {steps} "
        "steps")


def phase_bench(paths: dict) -> None:
    """python -m water_sandbox_tpu_torch.bench at its defaults (the flagship
    and the reference-cube head-to-head, settle 600, best of 3 x 50)."""
    t0 = time.perf_counter()
    lines, launches = run_front("water_sandbox_tpu_torch.bench", timeout=900)
    res = json.loads(lines[-1])
    log(json.dumps(res))
    check(res["value"] > 0 and res["config"]["n"] == 266112
          and res["reference_scene_ps_per_s"] > 0, "bench: result")
    check_launches("bench", launches, 2 * (600 + 3 * 50))
    paths["bench"] = (launches, 2 * (600 + 3 * 50))
    log(f"[bench] flagship {res['ms_per_step']:.4f} ms/step, reference-cube "
        f"{res['reference_scene_ms_per_step']:.4f} ms/step "
        f"({res['protocol']}), launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")


# reference-cube steps 100-200 through Simulation.run(1), each step synced
# (the landing cube, where the rescue fires), at the scene's settings
# updated by the JSON of argv[1]: only what every tree's port has, so it
# runs in an older checkout too
TRANSIENT = """
import json, statistics, sys, time
import water_sandbox_tpu_torch as wst
sim = wst.Simulation.from_scene("reference-cube", **json.loads(sys.argv[1]))
sim.run(100)
t = []
for _ in range(100):
    t0 = time.perf_counter()
    sim.run(1)
    t.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({"mean": statistics.mean(t), "median": statistics.median(t),
                  "max": max(t)}))
"""

# sharded-1m on 4 shards of the card in one tree, through the public
# runtime only (so it runs in an older checkout too): ms/step of
# DistributedSimulation.run over 20 steps after 10, and over 5 steps after
# 3 at the cell capacity of argv[1], where every shard drops more rows than
# the rescue takes (a rescue on every shard every step); each run's final
# shard states saved to the npz of argv[2]. Prints {label: ms/step}.
SHARDED = """
import json, sys, time
import numpy as np
from water_sandbox_tpu_torch.runtime.distributed import DistributedSimulation
out, saved = {}, {}
for label, kw, warm, timed in (
        ("sharded-1m", {}, 10, 20),
        ("forced rescue", {"cell_capacity": int(sys.argv[1])}, 3, 5)):
    sim = DistributedSimulation.from_scene("sharded-1m", n_shards=4, **kw)
    sim.run(warm)
    t0 = time.perf_counter()
    sim.run(timed)
    out[label] = 1e3 * (time.perf_counter() - t0) / timed
    for i, (s, a) in enumerate(zip(sim.states, sim.active)):
        for f in ("pos", "vel", "density", "ids"):
            saved[f"{label}_{i}_{f}"] = getattr(s, f).cpu().numpy()
        saved[f"{label}_{i}_active"] = a.cpu().numpy()
    del sim
np.savez(sys.argv[2], **saved)
print(json.dumps(out))
"""

# The incremental step in one tree, through the public runtime only (so it
# runs in an older checkout too): reference-cube in particle order at
# incremental_rebuild 8, at its cell capacity and at 8 (a drop step every
# step), Simulation.run(50) after run(20) (each run builds the cache on
# entry), its final state saved to the npz of argv[1]. Prints {label:
# ms/step}.
INCREMENTAL = """
import json, sys, time
import numpy as np, torch
import water_sandbox_tpu_torch as wst
out, saved = {}, {}
for label, kw in (("k=8", {}), ("k=8 cap 8", {"cell_capacity": 8})):
    sim = wst.Simulation.from_scene("reference-cube", sorted_state=False,
                                    incremental_rebuild=8, **kw)
    sim.run(20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(50)
    torch.cuda.synchronize()
    out[label] = 1e3 * (time.perf_counter() - t0) / 50
    for f in ("pos", "vel", "density", "ids"):
        saved[f"{label}_{f}"] = getattr(sim.state, f).cpu().numpy()
    del sim
np.savez(sys.argv[1], **saved)
print(json.dumps(out))
"""

# The cell capacity at which every shard of sharded-1m drops more rows than
# the domain rescue takes a step (R = 256), from its first step on (its
# lattice puts up to 8 particles in a cell; ~6,800 rows a shard drop at 4).
FORCED_CAP = 4

# R1 and R2 in one tree, through the public step only (so it runs in an
# older checkout too): reference-cube at step 100 stepped once at cell
# capacity 8 (its outputs saved to the npz of argv[1]) and timed by the
# profiler at the budgets of COMPARE_BUDGETS and at count 0; the flagship
# at step 10 past its own budget, at the highest cell capacity of 8, 6, 4,
# 3, 2 that leaves rows unrescued (outputs saved to argv[1] too). Prints
# {label: {kernel: device ms a step}}.
COMPARE_BUDGETS = (8192,) + RESCUE_SWEEP
RESCUE = """
import json, sys
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import water_sandbox_tpu_torch as wst
NAMES = ("rescue_density_kernel", "rescue_force_kernel")
FIELDS = ("pos", "vel", "predicted", "acc", "density", "near_density",
          "ids", "overflow")

def kernel_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {k: sum((getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages() if k in e.key) for k in NAMES}
    return {k: v / reps / 1e3 if v > 0 else None for k, v in us.items()}

saved, res = {}, {}
cfg, params, state = wst.scenes.build("reference-cube")
state100 = wst.rollout(state, params, cfg, 100)
for budget in %s + (None,):
    kw = (dict(cell_capacity=8, rescue_capacity=budget) if budget
          else dict(cell_capacity=64))
    c, p, _ = wst.scenes.build("reference-cube", **kw)
    s = wst.step(state100, p, c)
    label = f"budget {budget}" if budget else "count 0"
    if budget == 8192:
        saved.update({"cube_" + f: getattr(s, f).cpu().numpy()
                      for f in FIELDS})
    res[label] = kernel_ms(lambda: wst.step(state100, p, c))
    res[label]["unrescued"] = int(s.overflow)
cfg, params, state = wst.scenes.build("moving-container-256k")
state10 = wst.rollout(state, params, cfg, 10)
for cap in (8, 6, 4, 3, 2):
    c, p, _ = wst.scenes.build("moving-container-256k", cell_capacity=cap)
    s = wst.step(state10, p, c)
    if int(s.overflow) > 0:
        break
saved.update({"flagship_" + f: getattr(s, f).cpu().numpy() for f in FIELDS})
res["flagship"] = kernel_ms(lambda: wst.step(state10, p, c), reps=5)
res["flagship"].update(unrescued=int(s.overflow), cell_capacity=cap)
np.savez(sys.argv[1], **saved)
print(json.dumps(res))
""" % (COMPARE_BUDGETS,)


# One process a tree for replay_cost: the settled flagship, then a window
# of replays a line read from stdin ("off N" or "on N": N replays enqueued
# at once, timed by CUDA events from before the first to after the last;
# "on" with a CPU-only profiler open, which turns the step's phase markers
# on), its device ms a step printed as a line.
REPLAYS = """
import contextlib, json, sys, torch
from torch.profiler import ProfilerActivity, profile
import water_sandbox_tpu_torch as wst
sim = wst.Simulation.from_scene("moving-container-256k")
sim.run(600)
torch.cuda.synchronize()
print(json.dumps({"ready": True}), flush=True)
for line in sys.stdin:
    mode, n = line.split()
    n = int(n)
    prof = (profile(activities=[ProfilerActivity.CPU]) if mode == "on"
            else contextlib.nullcontext())
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with prof:
        a.record()
        sim.run(n, block=False)
        b.record()
        b.synchronize()
    print(json.dumps({"ms": a.elapsed_time(b) / n}), flush=True)
"""
REPLAY_WINDOW = 250
REPLAY_ROUNDS = 8


def replay_cost(other: Path, rounds: int = REPLAY_ROUNDS,
                window: int = REPLAY_WINDOW) -> dict:
    """``--replay-cost DIR`` (and the end of ``--compare DIR``): the
    settled flagship's device time a step in this tree and in DIR, both
    processes alive at once and taking turns on the card (REPLAYS), in
    ``rounds`` rounds of four windows of ``window`` replays each: the
    markers off, then on (a CPU-only profiler open), in each tree, the
    tree that goes first alternating from round to round. Reports each
    tree's median ms a step by mode, and per round the change's cost
    against DIR (off, on) and the markers' cost in this tree (on - off),
    as medians over the rounds."""
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    procs = {}
    for label, tree in (("parent", other.resolve()), ("change", ROOT)):
        procs[label] = subprocess.Popen(
            [sys.executable, "-c", REPLAYS], cwd=tree, env=_front_env(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        for label, p in procs.items():
            line = p.stdout.readline()
            check(bool(line) and json.loads(line).get("ready"),
                  f"replay-cost: {label} did not start")
        ms = {(label, mode): [] for label in procs for mode in ("off", "on")}
        for r in range(rounds):
            order = ("parent", "change") if r % 2 == 0 else ("change",
                                                              "parent")
            for label in order:
                for mode in ("off", "on"):
                    p = procs[label]
                    p.stdin.write(f"{mode} {window}\n")
                    p.stdin.flush()
                    line = p.stdout.readline()
                    check(bool(line), f"replay-cost: {label} stopped")
                    ms[(label, mode)].append(json.loads(line)["ms"])
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)

    def pct(a, b):
        return [100.0 * (x / y - 1.0) for x, y in zip(a, b)]
    out = {f"{label} {mode}": statistics.median(v)
           for (label, mode), v in ms.items()}
    out["change vs parent, off (%)"] = statistics.median(
        pct(ms[("change", "off")], ms[("parent", "off")]))
    out["change vs parent, on (%)"] = statistics.median(
        pct(ms[("change", "on")], ms[("parent", "on")]))
    out["markers on - off, change (us)"] = statistics.median(
        1e3 * (a - b) for a, b in zip(ms[("change", "on")],
                                      ms[("change", "off")]))
    out["profiler on - off, parent (us)"] = statistics.median(
        1e3 * (a - b) for a, b in zip(ms[("parent", "on")],
                                      ms[("parent", "off")]))
    out["replays a tree and mode"] = rounds * window
    log(f"[replay-cost] moving-container-256k settled, device ms a step by "
        f"CUDA events, {rounds} rounds of {window}-replay windows: "
        + json.dumps(out))
    log("[replay-cost] rounds: " + json.dumps(
        {f"{k[0]} {k[1]}": v for k, v in ms.items()}))
    return out


def compare(other: Path) -> int:
    """``--compare DIR``: this tree against the checkout in DIR (an older
    commit unpacked with ``git archive``) on one card, in the order DIR,
    this tree, this tree, DIR, each as subprocesses started in the tree
    they measure: ``python -m water_sandbox_tpu_torch.bench``,
    ``reference-cube`` steps 100-200 (TRANSIENT) at the scene's cell
    capacity and at 8 (the rescue on every step), R1/R2's device time
    a step (RESCUE) at cell capacity 8 and the budgets of COMPARE_BUDGETS,
    at count 0 and at the flagship past its budget, and sharded-1m's
    ms/step on 4 shards at its cell capacity and at FORCED_CAP (SHARDED),
    and the incremental step's ms/step at k = 8 (INCREMENTAL). Checks that
    the sorted step's rescue at cell capacity 8 gives the same bits in
    every run; reports whether the flagship's, the domain step's and the
    incremental step's do. Ends with ``replay_cost``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    other = other.resolve()
    check((other / "water_sandbox_tpu_torch").is_dir(),
          f"--compare {other}: no port there")
    FRONT_OUT.mkdir(parents=True, exist_ok=True)
    cap8 = json.dumps({"cell_capacity": 8, "rescue_capacity": 8192})
    outs = []
    for i, (label, tree) in enumerate((("parent", other), ("change", ROOT),
                                       ("change", ROOT), ("parent", other))):
        runs = {}
        npz = FRONT_OUT / f"compare_{i}_{label}.npz"
        npz_sh = FRONT_OUT / f"compare_{i}_{label}_sharded.npz"
        npz_inc = FRONT_OUT / f"compare_{i}_{label}_incremental.npz"
        for name, argv in (
                ("bench", ["-m", "water_sandbox_tpu_torch.bench"]),
                ("steps 100-200", ["-c", TRANSIENT, "{}"]),
                ("steps 100-200 cap 8", ["-c", TRANSIENT, cap8]),
                ("rescue", ["-c", RESCUE, str(npz)]),
                ("sharded", ["-c", SHARDED, str(FORCED_CAP), str(npz_sh)]),
                ("incremental", ["-c", INCREMENTAL, str(npz_inc)])):
            out = subprocess.run([sys.executable, *argv], cwd=tree,
                                 capture_output=True, text=True,
                                 env=_front_env(), timeout=900)
            if out.returncode != 0:
                log(out.stderr[-3000:])
            check(out.returncode == 0,
                  f"--compare {label} {name}: exit {out.returncode}")
            runs[name] = json.loads(out.stdout.strip().splitlines()[-1])
        b = runs["bench"]
        log(f"[compare] {label} ({tree}): bench settle600+best3x50 flagship "
            f"{b['ms_per_step']} ms/step, reference-cube "
            f"{b['reference_scene_ms_per_step']}, step "
            f"{b['config'].get('step')}")
        for name in ("steps 100-200", "steps 100-200 cap 8"):
            t = runs[name]
            log(f"[compare] {label}: reference-cube {name}, host clock a "
                f"synced step: mean {t['mean']:.4f} median "
                f"{t['median']:.4f} max {t['max']:.4f} ms/step")
        for at, r in runs["rescue"].items():
            where = (f"moving-container-256k step 10 cell capacity "
                     f"{r['cell_capacity']}" if at == "flagship" else
                     f"reference-cube step 100 cell capacity 8 {at}")
            log(f"[compare] {label}: R1/R2 device ms a step at {where}: R1 "
                f"{fmt(r['rescue_density_kernel'])} R2 "
                f"{fmt(r['rescue_force_kernel'])} (unrescued "
                f"{r['unrescued']})")
        sh = runs["sharded"]
        log(f"[compare] {label}: sharded-1m on 4 shards, "
            f"DistributedSimulation.run host clock (synced): "
            f"{sh['sharded-1m']:.4f} ms/step over 20 steps after 10; at "
            f"cell capacity {FORCED_CAP} (a rescue on every shard every "
            f"step) {sh['forced rescue']:.4f} ms/step over 5 after 3")
        inc_ms = runs["incremental"]
        log(f"[compare] {label}: reference-cube incremental (particle "
            f"order, k=8), Simulation.run(50) after run(20), host clock "
            f"(synced): {inc_ms['k=8']:.4f} ms/step; at cell capacity 8 "
            f"(a drop step every step) {inc_ms['k=8 cap 8']:.4f}")
        outs.append((label, {**{k: v for k, v in np.load(npz).items()},
                             **{"sharded_" + k: v
                                for k, v in np.load(npz_sh).items()},
                             **{"incremental_" + k: v
                                for k, v in np.load(npz_inc).items()}}))
    base_label, base = outs[0]
    for label, got in outs[1:]:
        for scene, what in (("cube", "rescue step"),
                            ("flagship", "rescue step"),
                            ("sharded", "domain step (both runs)"),
                            ("incremental", "incremental step (both runs)")):
            keys = [k for k in base if k.startswith(scene + "_")]
            same = all(base[k].dtype == got[k].dtype
                       and base[k].tobytes() == got[k].tobytes()
                       for k in keys)
            worst = max(float(np.abs(base[k].astype(np.float64)
                                     - got[k].astype(np.float64)).max())
                        for k in keys)
            log(f"[compare] {label} against the first {base_label}: "
                f"{scene} {what} {'bit for bit' if same else 'differs'}"
                f" (max |diff| {worst:.3e})")
            if scene == "cube":
                check(same, f"--compare: {label}'s rescue step at cell "
                      "capacity 8 differs from the first parent run")
    replay_cost(other)
    log(smi)
    return 0


def trace_margin(trials: int, steps: int = 20) -> int:
    """``--trace-margin TRIALS``: how often a torch.profiler trace of
    ``steps`` back-to-back replays of ``reference-cube``'s captured step
    lacks some of them, TRIALS traces with no idle time around the span
    and TRIALS with ``profiling.traced``'s margins, alternated. For each
    short trace: the replays seen (K1's events), and where its first
    device event and its first ``cudaGraphLaunch`` lie (us after the
    trace's start). Fails if a trace with the margins is short."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import water_sandbox_tpu_torch as wst
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from water_sandbox_tpu_torch.core.params import _map_tensors
    from water_sandbox_tpu_torch.ops.cuda import _build
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    from water_sandbox_tpu_torch.runtime import profiling
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build()
    cfg, params, state = wst.scenes.build("reference-cube", device="cuda")
    g = graph_mod.StepGraph(state, _map_tensors(params, torch.clone),
                            cfg.resolved())
    g.capture()
    g.run(50)

    @contextlib.contextmanager
    def bare():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield prof
            torch.cuda.synchronize()

    short = {"none": [], "margins": []}
    for _ in range(trials):
        for label, ctx in (("none", bare), ("margins", profiling.traced)):
            with ctx() as prof:
                g.run(steps)
            events = prof.events()
            dev = [e.time_range.start for e in events
                   if e.device_type == DeviceType.CUDA]
            seen = sum(1 for e in events if e.device_type == DeviceType.CUDA
                       and "sph_density_kernel" in e.name)
            launched = [e.time_range.start for e in events
                        if e.name == "cudaGraphLaunch"]
            if seen != steps:
                short[label].append(dict(
                    seen=seen,
                    first_device_us=min(dev, default=float("nan")),
                    first_launch_us=min(launched, default=float("nan"))))
    for label, rows in short.items():
        log(f"[trace-margin] {label} (margin "
            f"{0.0 if label == 'none' else profiling.TRACE_MARGIN_S} s a "
            f"side): {len(rows)} of {trials} traces of {steps} replays "
            f"short; " + "; ".join(
                f"{r['seen']} seen, first device event "
                f"{r['first_device_us']:.1f} us, first cudaGraphLaunch "
                f"{r['first_launch_us']:.1f} us" for r in rows))
    log(smi)
    return 1 if short["margins"] else 0


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
    state3 = wst.rollout(state3, params3, cfg3, 10)
    kernels_vs_plain("moving-container-256k step 10", cfg3, params3, state3,
                     record, crossing=True)
    phase_rescue_flagship(cfg3, params3, state3, record)
    del state3

    # 3b. the build after the sort and the integrate against their plain
    # versions
    phase_build(record, cfg, params, state100)
    phase_integrate(record, cfg, params, state100)
    phase_params(record)

    # 4. exact rescue on the card, its kernels against their plain versions
    phase_rescue(state100, record)

    # 4b. the step as a captured CUDA graph against the eager step
    phase_capture("reference-cube", state100)
    phase_capture("moving-container-256k")

    # 5. golden pins, the oracle and the plain neighbour modes
    paths: dict = {}
    phase_oracle(*phase_golden())
    single = phase_bucket_grid(state100, paths)
    phase_gspmd(state100, single, record, paths)
    del single
    phase_modes()

    # 5b. the port's 1,000-step pins made on the card
    for scene in GOLDEN_1K:
        phase_golden_1k(scene, paths)
    phase_golden_dense()

    # 6. single-device path
    paths["reference-cube"] = phase_main_path("reference-cube", 200,
                                              warmup=20)
    paths["moving-container-256k"] = phase_main_path(
        "moving-container-256k", 50, warmup=10)

    # 6b. the incremental plane-resident path
    phase_incremental(record, paths)

    # 7. domain-decomposed path
    phase_domain_parity("cuda:0")
    phase_domain_parity("cuda:0", use_pallas=False)
    paths["sharded-1m"] = phase_domain_full(record)

    # 8. the bitonic sort and its own path (launches per call, not step)
    paths["argsort_keys"] = ({"bitonic_sort": phase_sort(record)}, 1)

    # 9. the front end: CLI, profiling, terminal and browser viewers, bench
    for label, phase in (("cli", phase_cli), ("profile", phase_profile),
                         ("live", phase_live),
                         ("viewer", lambda p: serve_and_check(
                             "moving-container-256k", "raster", p)),
                         ("viewer", lambda p: serve_and_check(
                             "dam-break-2d-4k", "points", p)),
                         ("bench", phase_bench)):
        t0 = time.perf_counter()
        phase(paths)
        log(f"[{label}] phase passed in {time.perf_counter() - t0:.1f} s")

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
            **({"sweep_bound_ms": rec["sweep_bound_ms"]}
               if "sweep_bound_ms" in rec else {}),
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
    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--params"]:
        sys.exit(params_against(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--replay-cost"]:
        replay_cost(Path(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--trace-margin"]:
        sys.exit(trace_margin(int(sys.argv[2])))
    sys.exit(main())
