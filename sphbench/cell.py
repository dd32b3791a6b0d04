"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration, traffic mix and
metrics; each lives in a file of its own under ``sphbench/``:

    configs/<config>.json    the deployment, as it is run
    traffic/<traffic>.json   the parameters the one generator (drive.py) reads
    limits/<workload>.json   the limit of each number the check compares
    metrics/<metric>.py      a reader: ``read(run)`` returns the value or None

A cell, configuration, traffic mix or metric is added by adding its file
and its entry in ``BENCHMARK.json``; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether a metric entry belongs to this workload: listed under its
    ``workloads`` key, or, without the key, reported everywhere (a
    per-layer metric then where its end-to-end metric is)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    here = root / "sphbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(name=workload, chips=w["chips"],
                config=_load_json(here / "configs" / f"{w['config']}.json"),
                traffic=_load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(here / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``sphbench/metrics/<metric>.py``."""
    path = root / "sphbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "sphbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
