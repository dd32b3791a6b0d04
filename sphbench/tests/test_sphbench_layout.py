"""The benchmark's files: names, units, what BENCHMARK.json asks of each
cell, that every piece is found by its name, that a piece added as a file
is picked up with no file that is there edited, and that nothing the
benchmark runs imports JAX, the JAX package or (the reference) the
program."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sphbench import cell as cell_mod

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "water_sandbox_tpu"}


def test_names_and_units_use_the_allowed_characters():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("end_to_end", "per_layer", "workloads", "configs"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        c = cell_mod.load(w["name"], ROOT)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert c.per_layer, w["name"]
        for m in c.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
        assert w["chips"] == 1


def test_every_piece_is_found_by_its_name():
    for w in BENCH["workloads"]:
        c = cell_mod.load(w["name"], ROOT)
        assert c.config["name"] == w["config"]
        assert c.traffic["loop"] in ("open", "closed")
        for m in c.end_to_end + c.per_layer:
            assert callable(cell_mod.reader(m["name"], ROOT))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("sphbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []


def test_a_piece_added_as_a_file_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "sphbench", root / "sphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "sphbench").rglob("*")
              if p.is_file()}
    conf = json.loads((root / "sphbench/configs/reference-cube.json")
                      .read_text())
    conf["name"] = "small-cube"
    (root / "sphbench/configs/small-cube.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "sphbench/traffic/settled.json").read_text())
    traffic["chunk"] = 10
    (root / "sphbench/traffic/short.json").write_text(json.dumps(traffic))
    (root / "sphbench/limits/small.short.json").write_text(
        (root / "sphbench/limits/flagship.settled.json").read_text())
    (root / "sphbench/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench["configs"].append(dict(bench["configs"][0], name="small-cube",
                                 file="sphbench/configs/small-cube.json"))
    bench["workloads"].append({"name": "small.short", "config": "small-cube",
                               "traffic": "short", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "runtime", "moves": "ms_per_step",
                               "workloads": ["small.short"]})
    bench["end_to_end"][0]["workloads"].append("small.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cell_mod.load("small.short", root)
    assert c.config["name"] == "small-cube" and c.traffic["chunk"] == 10
    assert [m["name"] for m in c.per_layer] == ["steps_done"]

    class Run:
        steps = 7
    assert cell_mod.reader("steps_done", root)(Run()) == 7.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "sphbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "sphbench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "water_sandbox_tpu_torch" not in tops, path
        assert not tops & FORBIDDEN, path


_PROBE = """
import json, pkgutil, sys
import sphbench, sphbench.reference.sph
ref = sorted(m for m in sys.modules if m.split(".")[0].startswith("water"))
import sphbench.run, sphbench.calibrate, sphbench.drive, sphbench.check
import sphbench.copies, sphbench.trace, sphbench.roofline
from sphbench import cell
for m in json.load(open("BENCHMARK.json"))["per_layer"]:
    cell.reader(m["name"])
import water_sandbox_tpu_torch.runtime.keymap
print(json.dumps({"ref": ref, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in %r)}))
""" % (tuple(FORBIDDEN),)


def test_loading_the_benchmark_loads_no_jax_in_a_fresh_interpreter():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref": [], "loaded": []}


def test_the_command_refuses_without_a_card(tmp_path):
    """Without CUDA the command prints no result and exits non-zero; so it
    does in a directory that holds only the benchmark's own files."""
    out = subprocess.run([sys.executable, "-m", "sphbench.run", "--workload",
                          "flagship.settled", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copytree(ROOT / "sphbench", alone / "sphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "sphbench.run", "--workload",
                          "flagship.settled", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=alone,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["moving-container-256k", "reference-cube"])
def test_each_configuration_is_the_ports_scene(name):
    """The configuration file holds the scene's values as the port's
    registry builds them (``water_sandbox_tpu_torch/models/scenes.py``)."""
    import torch

    from sphbench import inputs
    from water_sandbox_tpu_torch.models import scenes

    conf = json.loads((ROOT / f"sphbench/configs/{name}.json").read_text())
    cfg, prm, state = scenes.build(name, device="cpu")
    lattice = inputs.start_positions(dict(conf, jitter=0.0), 1, "cpu")
    assert torch.equal(lattice, state.pos)
    for k, v in conf["sim_config"].items():
        want = getattr(cfg, k)
        assert (list(want) if isinstance(want, tuple) else want) == v, k
    assert cfg.n == conf["n"]
    for k in inputs.PARAM_NAMES:
        assert float(getattr(prm, k)) == inputs.params(conf)[k], k
    assert [float(x) for x in prm.gravity] == inputs.params(conf)["gravity"]
    box = inputs.box(conf)
    c = prm.container
    assert [float(x) for x in c.center] == box["center"]
    assert [2 * float(x) for x in c.half_size] == box["size"]
    assert [float(x) for x in c.velocity] == box["velocity"]
    assert float(c.angular_velocity) == box["angular_velocity"]
    assert float(prm.field.strength) == 0.0
