"""The port's runtime against the JAX package's keys, and the port's
examples (``examples/torch_dam_break.py``, ``examples/torch_multichip.py``,
the counterparts of ``examples/dam_break.py`` and ``examples/multichip.py``)
run on the CPU at a few steps."""

import ast
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

import water_sandbox_tpu_torch as wt

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _distributed_runner_setup(pkg, **kw):
    """tests/test_distributed_runner.py:17-27's scene in package ``pkg``."""
    pts = pkg.scenes.cube_fluid(6, 4, 4)
    params = pkg.SimParams.create(
        dim=3, container=pkg.Container.create((0, 0, 0), (4.0, 3.0, 3.0),
                                              **kw), **kw)
    cfg = pkg.SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                        grid_dims=(24, 16, 16), cell_capacity=16)
    return pkg.DistributedSimulation(cfg, params, pkg.init_state(pts, **kw),
                                     n_devices=8, slack=8.0, **kw)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_distributed_stats_hold_the_jax_keys():
    """Code written against the JAX runtime reads ``per_device_counts``:
    the port's stats() holds every key of the JAX package's, one count a
    mesh position (a shard), the same as its own ``per_shard_counts``. Two
    runs each: the port records its first run as warm-up, and its timed
    steps' keys appear from the second."""
    import water_sandbox_tpu as wj
    jsim = _distributed_runner_setup(wj)
    sim = _distributed_runner_setup(wt, device="cpu")
    for s in (jsim, sim):
        s.run(1)
        s.run(1)
    want = set(jsim.stats())
    st = sim.stats()
    assert want <= set(st), want - set(st)
    assert len(st["per_device_counts"]) == 8
    assert sum(st["per_device_counts"]) == sim.cfg.n
    assert st["per_device_counts"] == st["per_shard_counts"]


def _example(name: str):
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return path, mod


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_torch_dam_break_example_runs_on_the_cpu(tmp_path):
    path, mod = _example("torch_dam_break")
    assert not _imported(path) & {"jax", "water_sandbox_tpu"}
    st = mod.main(device="cpu", frames=2, steps=2, out_dir=str(tmp_path))
    assert st["step"] == 4 and np.isfinite(st["kinetic_energy"])
    assert (tmp_path / "dam_break_traj.npz").stat().st_size > 0
    assert (tmp_path / "dam_break.gif").stat().st_size > 1000


def test_torch_multichip_example_runs_on_the_cpu(capsys):
    path, mod = _example("torch_multichip")
    assert not _imported(path) & {"jax", "water_sandbox_tpu"}
    st = mod.main(device="cpu", n_shards=2, rounds=2, steps=2)
    assert st["step"] == 4 and st["lost_particles"] == 0.0
    assert sum(st["per_device_counts"]) == st["active_particles"] == 768
    assert "per-device" in capsys.readouterr().out
