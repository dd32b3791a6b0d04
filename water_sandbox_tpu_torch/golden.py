"""Golden-trajectory pins of the port — the counterpart of the JAX package's
``tools/gen_goldens.py`` and its pin table (``tests/test_golden.py``).

A pin is a set of summary statistics of a fixed scene after a fixed number
of steps: centre of mass, kinetic energy, bounding box, mean density and
the 10/50/90% quantiles of speed and density. They are robust to a benign
reordering of float sums over a short horizon and catch a physics
regression. Each pipeline and each device sums in its own order, and the
differences grow chaotically, so the port pins its own trajectories rather
than the JAX package's: ``GOLDEN`` records where each pin was made
(``made_on``). ``JAX_GOLDEN`` copies the JAX package's pins that the port
also meets or prints beside its own.

Regenerate a pin after an intentional physics change::

    python -m water_sandbox_tpu_torch.golden mini-3d dense 60 --device cpu
    python -m water_sandbox_tpu_torch.golden reference-cube pallas 1000
    python -m water_sandbox_tpu_torch.golden dam-break-2d-4k dense 1000 \
        --device cuda

The last two run on the card (the default device; it raises without one).
The printed line is ``{"scene|mode|steps": stats}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .core import device as device_mod
from .core.params import KernelCoeffs
from .models import scenes
from .runtime.runner import Simulation

# Bars of tests/test_golden.py: (rtol, atol) a statistic, as
# np.testing.assert_allclose applies them against the pin (its default
# rtol 1e-7 where the test gives only atol).
BARS = {"com": (1e-7, 2e-3), "ke": (2e-3, 0.0), "bbox_lo": (1e-7, 5e-3),
        "bbox_hi": (1e-7, 5e-3), "mean_rho": (2e-3, 0.0),
        "vq": (2e-3, 1e-3), "rq": (2e-3, 0.0)}

# Pin names as benchmarks/golden_sensitivity.json reports a tripped pin
# (the two bbox statistics are one pin there).
_PIN_OF = {"com": "com", "ke": "ke", "bbox_lo": "bbox", "bbox_hi": "bbox",
           "mean_rho": "mean_rho", "vq": "vq", "rq": "rq"}

# The card the 1,000-step card pins were made on (``made_on("cuda")``).
_H100 = "NVIDIA H100 80GB HBM3, 700.00 W; torch 2.11.0+cu128; CUDA 12.8"

# The port's own pins. ``kw`` overrides SimConfig fields of the scene;
# ``bars`` widens a statistic's bar to an absolute tolerance (see check).
# The CPU pins were made on one intra-op thread with torch 2.13.0+cpu.
GOLDEN = {
    # -- fast pins (the default CPU suite) ----------------------------------
    ("dam-break-2d-4k", "bucket_grid", 40): dict(
        com=[-5.3896, -2.26121], ke=67053.41,
        bbox_lo=[-7.95, -4.45], bbox_hi=[-1.99915, 1.46529],
        mean_rho=200.5307,
        vq=[3.29267, 6.45606, 6.73625], rq=[114.2306, 132.0224, 427.9813],
        made_on="cpu"),
    ("mini-3d", "dense", 60): dict(
        com=[0.0, -3.79511, 0.0], ke=10585.85,
        bbox_lo=[-2.28083, -4.4, -2.28083],
        bbox_hi=[2.28083, -3.10759, 2.28083], mean_rho=156.2291,
        vq=[1.79224, 5.23462, 8.81627], rq=[152.7888, 152.7888, 168.9143],
        made_on="cpu"),
    ("mini-3d", "bucket_grid", 60): dict(
        com=[0.0, -3.79511, 0.0], ke=10585.82,
        bbox_lo=[-2.28083, -4.4, -2.28083],
        bbox_hi=[2.28083, -3.10759, 2.28083], mean_rho=156.2293,
        vq=[1.79217, 5.23464, 8.81628], rq=[152.7888, 152.7888, 168.9206],
        kw=dict(grid_dims=(20, 16, 16), chunk=256), made_on="cpu"),
    # -- long pins (WST_SLOW=1) ---------------------------------------------
    # the interaction field of the scene is active
    ("interactive-2d-16k", "bucket_grid", 200): dict(
        com=[-0.00023, -3.9234], ke=108427.16,
        bbox_lo=[-11.95, -5.95], bbox_hi=[11.95, -0.28927],
        mean_rho=157.4196,
        vq=[0.82471, 3.37146, 5.17264], rq=[112.1357, 145.752, 223.4131],
        made_on="cpu"),
    ("mini-3d", "dense", 1000): dict(
        com=[0.69849, -4.39891, -0.24945], ke=36.71,
        bbox_lo=[-7.88721, -4.4, -4.39991],
        bbox_hi=[7.9, -4.24498, 4.39398], mean_rho=152.7937,
        vq=[0.1141, 0.23444, 0.51454], rq=[152.7888, 152.7888, 152.7888],
        made_on="cpu"),
    ("dam-break-2d-4k", "bucket_grid", 1000): dict(
        com=[-0.07202, -3.94311], ke=9655.55,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -3.1263],
        mean_rho=212.4052,
        vq=[0.59965, 1.72117, 3.53695], rq=[143.8734, 217.5981, 270.0872],
        made_on="cpu"),
    # the kernel pipeline's plain versions on the CPU
    ("dam-break-2d-4k", "pallas", 200): dict(
        com=[-2.40526, -2.94829], ke=60679.95,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -0.26948],
        mean_rho=132.6252,
        vq=[1.61062, 4.2811, 9.01769], rq=[83.9625, 129.3216, 185.625],
        made_on="cpu"),
    # -- the flagship scenes on the card (chip_smoke.py's [golden] phase) ----
    # The kernel pipeline with its own row group (G = 2 threads a row at
    # 65,536 rows, G = 1 at 266,112 on 132 SMs). ``bars``: twice the largest
    # spread of a statistic over the kernels' three row groups G = 1, 2, 4
    # (three summation orders of the same pairs), where that is wider than
    # the JAX package's bar.
    ("reference-cube", "pallas", 1000): dict(
        com=[0.00073, -3.76547, -0.00177], ke=1276.13,
        bbox_lo=[-7.9, -4.4, -4.4], bbox_hi=[7.9, -2.26419, 4.4],
        mean_rho=332.9438,
        vq=[0.01039, 0.0256, 0.38013], rq=[161.6517, 316.0713, 535.6669],
        bars=dict(com=0.00804, ke=6.84, bbox_hi=0.1487, mean_rho=0.294,
                  vq=0.00712, rq=0.9168),
        made_on=_H100),
    ("moving-container-256k", "pallas", 1000): dict(
        com=[2.7029, -2.93646, -0.03091], ke=223285.31,
        bbox_lo=[-18.26894, -4.9, -10.10571],
        bbox_hi=[23.26892, -0.26624, 10.10571],
        mean_rho=178.7255,
        vq=[0.52895, 1.09877, 1.93041], rq=[153.8196, 174.4238, 210.2949],
        bars=dict(com=0.00828, ke=1224.16, bbox_hi=0.02616, mean_rho=0.2198,
                  vq=0.00878, rq=0.624),
        made_on=_H100),
    # The dense oracle through its captured step (chip_smoke.py's [golden]
    # dam-break-2d-4k dense lines). ``bars``: twice the largest spread of a
    # statistic over three summation orders of the same pairs (the scene's
    # row order and two seeded permutations of the initial rows), where
    # that is wider than the JAX package's bar.
    ("dam-break-2d-4k", "dense", 1000): dict(
        com=[-0.10786, -3.9302], ke=8703.93,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -3.05077],
        mean_rho=209.6719,
        vq=[0.58858, 1.63902, 3.29854], rq=[143.1299, 209.5872, 275.4879],
        bars=dict(com=0.15556, ke=1525.78, bbox_hi=0.25668, mean_rho=11.1674,
                  vq=0.39308, rq=15.4976),
        made_on=_H100),
}

# The JAX package's pins the port is held to or printed beside
# (tests/test_golden.py:58-63, :80-85, :100-123; a test keeps this copy
# equal to that table). The flagships' 1,000-step pins were made on a TPU
# v5e.
JAX_GOLDEN = {
    ("mini-3d", "pallas", 60): dict(
        com=[0.0, -3.79511, 0.0], ke=10585.89,
        bbox_lo=[-2.28083, -4.4, -2.28083],
        bbox_hi=[2.28083, -3.10759, 2.28083], mean_rho=156.2288,
        vq=[1.79178, 5.23468, 8.81625], rq=[152.7888, 152.7888, 168.9195],
        kw=dict(grid_dims=(20, 16, 16))),
    ("reference-cube", "pallas", 1000): dict(
        com=[0.00245, -3.76489, 0.00057], ke=1276.51,
        bbox_lo=[-7.9, -4.4, -4.4], bbox_hi=[7.9, -2.23074, 4.4],
        mean_rho=332.9723,
        vq=[0.01156, 0.03055, 0.37969], rq=[161.8073, 315.4169, 536.8668]),
    ("dam-break-2d-4k", "dense", 1000): dict(
        com=[-0.14036, -3.93962], ke=9659.11,
        bbox_lo=[-7.95, -4.45], bbox_hi=[7.95, -2.85276],
        mean_rho=214.1837,
        vq=[0.70559, 1.81522, 3.3783], rq=[140.9755, 212.3918, 285.7992]),
    ("moving-container-256k", "pallas", 1000): dict(
        com=[2.6997, -2.93742, -0.02899], ke=223845.0,
        bbox_lo=[-18.26894, -4.9, -10.10571],
        bbox_hi=[23.26892, -0.19998, 10.10571],
        mean_rho=178.8224,
        vq=[0.52844, 1.10135, 1.93467], rq=[153.8768, 174.4156, 210.5659]),
}


def run(name: str, mode: str, steps: int, device=device_mod.DEFAULT,
        progress: bool = False, **kw):
    """``steps`` steps of scene ``name`` in ``neighbor_mode=mode`` on
    ``device`` (the card unless the caller names the CPU); ``kw`` replaces
    SimConfig fields. Runs what ``Simulation.run`` runs (on the card, the
    mode's captured step, captured here under whatever context the caller
    has open), in 50-step chunks as the JAX tool does. Returns
    (cfg, params, state)."""
    cfg, params, state = scenes.build(name, device=device,
                                      neighbor_mode=mode, **kw)
    sim = Simulation(cfg, params, state, name=name)
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        chunk = min(50, steps - done)
        sim.run(chunk, block=progress)
        done += chunk
        if progress:
            print(f"# {done}/{steps} ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
    return cfg, sim.params, sim.state


def summarize(state) -> dict:
    """The pinned statistics of ``state``, with the keys and rounding of
    tools/gen_goldens.py. Permutation-invariant, so sorted-state safe."""
    pos = state.pos.cpu().numpy()
    vel = state.vel.cpu().numpy()
    speed = np.sqrt((vel ** 2).sum(axis=1))
    rho = state.density.cpu().numpy()
    return {
        "com": [round(float(x), 5) for x in pos.mean(0)],
        "ke": round(float(0.5 * (vel ** 2).sum()), 2),
        "bbox_lo": [round(float(x), 5) for x in pos.min(0)],
        "bbox_hi": [round(float(x), 5) for x in pos.max(0)],
        "mean_rho": round(float(rho.mean()), 4),
        "vq": [round(float(np.quantile(speed, q)), 5)
               for q in (0.1, 0.5, 0.9)],
        "rq": [round(float(np.quantile(rho, q)), 4)
               for q in (0.1, 0.5, 0.9)],
        "overflow": int(state.overflow),
        "overflow_total": float(state.overflow_total),
    }


def stats(name: str, mode: str, steps: int, device=device_mod.DEFAULT,
          **kw) -> dict:
    """``summarize`` of ``run(name, mode, steps, device, **kw)``."""
    return summarize(run(name, mode, steps, device, **kw)[2])


def margins(stats: dict, pin: dict) -> dict:
    """For each statistic the pin holds, the largest |stats - pin| over its
    elements as a fraction of its bar (above 1: tripped). The bar of an
    element is atol + rtol·|pin| (``BARS``), or the pin's own
    ``bars[statistic]`` where that is wider."""
    out = {}
    for key, (rtol, atol) in BARS.items():
        if key not in pin:
            continue
        want = np.asarray(pin[key], np.float64)
        got = np.asarray(stats[key], np.float64)
        bar = np.maximum(atol + rtol * np.abs(want),
                         pin.get("bars", {}).get(key, 0.0))
        out[key] = float(np.max(np.abs(got - want) / bar))
    return out


def check(stats: dict, pin: dict) -> list:
    """Names of the pins ``stats`` trips, as the golden sensitivity check
    reports them: ``overflow_total`` when any particle was dropped on any
    step, then each statistic past its bar (``margins``). Empty: held."""
    tripped = [] if stats["overflow_total"] == 0.0 else ["overflow_total"]
    for key, m in margins(stats, pin).items():
        if not m <= 1.0 and _PIN_OF[key] not in tripped:
            tripped.append(_PIN_OF[key])
    return tripped


@contextlib.contextmanager
def flipped_near_derivative():
    """The golden suite's planted physics bug, for the sensitivity check
    (as benchmarks/golden_sensitivity.py plants it in the JAX package):
    ``KernelCoeffs.from_radius`` returns ``pow3_der`` negated while the
    context is open, which turns the near-pressure repulsion into
    attraction. Every pipeline reads its coefficients from that factory
    (ops/step.py), the kernels through their parameter vector."""
    orig = KernelCoeffs.__dict__["from_radius"]

    def mutated(h, dim):
        k = orig.__func__(h, dim)
        return dataclasses.replace(k, pow3_der=-k.pow3_der)

    KernelCoeffs.from_radius = staticmethod(mutated)
    try:
        yield
    finally:
        KernelCoeffs.from_radius = orig


def made_on(device) -> str:
    """Where a pin is made: ``"cpu"``, or the card as ``nvidia-smi`` names
    it with its power limit, and the torch and CUDA versions."""
    dev = device_mod.resolve(device)
    if dev.type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()
    return f"{smi}; torch {torch.__version__}; CUDA {torch.version.cuda}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m water_sandbox_tpu_torch.golden",
        description="Print the golden statistics of a scene after a number "
                    "of steps as one JSON line keyed scene|mode|steps.")
    ap.add_argument("scene")
    ap.add_argument("mode")
    ap.add_argument("steps", type=int)
    ap.add_argument("kw", nargs="?", default="{}",
                    help="SimConfig overrides as a JSON object")
    ap.add_argument("--device", default=device_mod.DEFAULT,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in json.loads(a.kw).items()}
    dev = device_mod.resolve(a.device)
    if dev.type == "cpu":
        # the tests run the plain pipelines on one intra-op thread
        # (tests/_torch_fixtures.py); CPU pins are made the same way
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = summarize(run(a.scene, a.mode, a.steps, dev, progress=True,
                        **kw)[2])
    print(f"# made_on: {made_on(dev)}; {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    print(json.dumps({f"{a.scene}|{a.mode}|{a.steps}": out}))


if __name__ == "__main__":
    main()
