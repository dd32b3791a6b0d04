"""Run one cell of the benchmark once and print its result.

    python3 -m sphbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. It builds the cell's inputs from the seed, sets up and warms the
program (``water_sandbox_tpu_torch``), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error. Anything else goes to standard error.
Without CUDA, or with fewer cards than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package got loaded, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton_cache",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "water_sandbox_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's or the JAX package's, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, the metrics
    and the check. Returns the result object, with the compared numbers
    under ``_numbers``; with ``control``, also the lower-precision
    control's numbers on the same samples under ``_control`` and its
    verdict under the cell's limits, by the same comparison, under
    ``_control_correct``."""
    import torch

    from . import cell as cell_mod, check, drive, trace as trace_mod
    from .copies import fingerprint, true_pairs

    device = torch.device(device)
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    sim, start_gap, snaps = drive.setup(cell, seed, device)
    run = drive.Run(loop=cell.traffic["loop"], n=cell.config["n"],
                    device_name=name, start_gap=start_gap)
    run.setup_s = time.perf_counter() - t0
    loop = drive.closed if run.loop == "closed" else drive.open_loop
    loop(sim, cell.traffic, seconds, seed, trace, run, snaps)
    del snaps
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    log(f"[run] {cell.name} seed {seed}: {run.attempted} attempted, "
        f"{run.failed} failed, {run.steps} steps in {run.wall_s:.3f} s, "
        f"setup {run.setup_s:.3f} s, peak {run.memory_peak_bytes} B")
    if run.rescued_rows is not None:
        log(f"[run] {run.rescued_rows} rows rescued in the window, "
            f"{run.resets} resets")
    if run.frame_ms:
        q = statistics.quantiles(run.frame_ms, n=100, method="inclusive")
        log(f"[run] frame ms p50 {q[49]:.4f} p90 {q[89]:.4f} p95 {q[94]:.4f}"
            f" p99 {q[98]:.4f} max {max(run.frame_ms):.4f}; over one frame "
            f"{sum(f > 1e3 / cell.traffic['rate_hz'] for f in run.frame_ms)};"
            f" generator late: median {statistics.median(run.late_ms):.4f} "
            f"ms, max {max(run.late_ms):.4f} ms")
    log("[fingerprint] " + json.dumps(fingerprint(sim)))
    for sm in run.samples:
        state = sm.pre if sm.steps_done else sm.post
        log(f"[sample] {sm.index}: {sm.steps_done} steps done, "
            f"{check.rescued_rows(state, cell.config, sm.steps_done)} rows "
            f"beyond the cell capacity, keys {''.join(sm.keys)}")
    h = sim.params.smoothing_radius.clone()
    del sim
    gc.collect()
    breakdown = None
    if trace and run.prof is not None:
        run.trace = trace_mod.reduce(run.prof, run.traced_steps)
        run.prof = None
        run.pairs = [true_pairs(p.predicted, h) for p in run.traced_pred]
        breakdown = trace_mod.breakdown(run.trace)
        if cuda:
            run.power = power_limit()
        log(f"[trace] {run.traced_steps} steps, {len(run.trace.device)} "
            f"device events, pairs {run.pairs}, card {run.power}")
    run.traced_pred = []
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    got = check.numbers(run.samples, cell.config, seed, device,
                        run.start_gap)
    log(f"[check] {len(run.samples)} samples in "
        f"{time.perf_counter() - t_check:.3f} s")
    correct, checks = check.judge(got, cell.limits)
    correct = correct and run.failed == 0 and run.attempted > 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell_mod.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["_numbers"] = got
    if control:
        out["_control"] = check.numbers(run.samples, cell.config, seed,
                                        device, None, control=True)
        out["_control_correct"], _ = check.judge(out["_control"],
                                                 cell.limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
        (ROOT / rel).mkdir(parents=True, exist_ok=True)

    import torch

    from . import cell as cell_mod
    cell = cell_mod.load(args.workload, ROOT)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T0)
    del out["_numbers"]
    found = loaded_forbidden()
    if found:
        log(f"JAX or the JAX package is loaded: {found}")
        return 3
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
