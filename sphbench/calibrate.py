"""The readings that the limits of ``sphbench/limits/<workload>.json``
are set from, on the card, in one process:

    python3 -m sphbench.calibrate --workload <name> --seconds <s> \
        --seeds <a,b,...> --control-seeds <c,d,e>

For each seed, one run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the samples it draws), and the numbers the check
compares. For each control seed, the same numbers of the lower-precision
control, the bfloat16 reference put in the program's place on the same
samples. Each run prints one JSON line: the workload, the seed, ``numbers``
and ``control`` (null where not run), ``correct`` under the limits as they
stand, ``control_correct``, the control's verdict by the same comparison
(``check.judge``; null where not run, false where the control fails), and
``failed``. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .run import ROOT, log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from . import cell as cell_mod
    from .run import run_cell
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = cell_mod.load(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        out = run_cell(cell, seed, args.seconds, False, "cuda:0",
                       time.perf_counter(), control=seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": out["_numbers"],
                          "control": out.get("_control"),
                          "control_correct": out.get("_control_correct"),
                          "correct": out["correct"],
                          "failed": out["failed"],
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
