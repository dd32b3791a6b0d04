"""The port's command line, trajectory export and checkpoints against the
JAX package's: ``python -m water_sandbox_tpu_torch.cli`` on the CPU
(``WST_FORCE_CPU=1``) end to end, its files read by the JAX package and
the JAX package's files read by it, and its refusal to fall back to the
CPU without that switch. Three CLI subprocesses in all; the other
subcommands run in-process through ``cli.main``.

Bar: positions by particle id within rtol = atol = 2e-4 of the JAX
package's run (tests/test_torch_step.py's bar)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.io import export as jexport
from water_sandbox_tpu.runtime import checkpoint as jcheckpoint
from water_sandbox_tpu.runtime.runner import Simulation as JSimulation
from water_sandbox_tpu_torch import cli
from water_sandbox_tpu_torch.io import export
from water_sandbox_tpu_torch.runtime import checkpoint

TOL = dict(rtol=2e-4, atol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, cpu=True):
    env = dict(os.environ)
    env.pop("WST_FORCE_CPU", None)
    if cpu:
        env["WST_FORCE_CPU"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "water_sandbox_tpu_torch.cli", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)


def _stats(stdout):
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][0])


def _by_id(pos, ids):
    out = np.empty_like(np.asarray(pos))
    out[np.asarray(ids)] = np.asarray(pos)
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's mini-3d dense run: its checkpoint at step 4 and
    its positions by id at steps 4 and 6."""
    d = tmp_path_factory.mktemp("jax")
    sim = JSimulation.from_scene("mini-3d", neighbor_mode="dense")
    sim.run(4)
    ck = str(d / "jax4.npz")
    jcheckpoint.save(ck, sim.state, sim.params, sim.cfg)
    pos4 = sim.positions()
    sim.run(2)
    return dict(checkpoint=ck, pos4=pos4, pos6=sim.positions())


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """``cli run`` on the CPU: 4 steps recorded every 2, with a trajectory
    and a checkpoint."""
    d = tmp_path_factory.mktemp("port")
    traj, ck = str(d / "traj.npz"), str(d / "end.npz")
    out = _cli("run", "--scene", "mini-3d", "--neighbor-mode", "dense",
               "--steps", "4", "--record-every", "2", "--export", traj,
               "--checkpoint", ck)
    assert out.returncode == 0, out.stderr
    return dict(stdout=out.stdout, trajectory=traj, checkpoint=ck, dir=d)


def test_cli_run_matches_jax(port_run, jax_run):
    assert _stats(port_run["stdout"])["step"] == 4
    state, params, cfg = jcheckpoint.load(port_run["checkpoint"])
    assert int(state.step_count) == 4 and cfg.neighbor_mode == "dense"
    assert float(state.overflow_total) == 0.0
    np.testing.assert_allclose(_by_id(state.pos, state.ids),
                               jax_run["pos4"], **TOL)
    positions, times, meta = jexport.load_trajectory(port_run["trajectory"])
    assert positions.shape == (3, 512, 3) and meta == {"scene": "mini-3d"}
    np.testing.assert_allclose(positions[-1], jax_run["pos4"], **TOL)
    assert times[0] == 0.0 and (np.diff(times) > 0).all()


def test_cli_resume_from_jax_checkpoint(jax_run, tmp_path):
    out_ck = str(tmp_path / "resumed.npz")
    out = _cli("resume", "--checkpoint", jax_run["checkpoint"], "--steps",
               "2", "--out", out_ck)
    assert out.returncode == 0, out.stderr
    assert _stats(out.stdout)["step"] == 6
    state, _, _ = checkpoint.load(out_ck, device="cpu")
    np.testing.assert_allclose(_by_id(state.pos.numpy(), state.ids.numpy()),
                               jax_run["pos6"], **TOL)


def test_cli_without_cpu_switch_needs_cuda(tmp_path):
    """No CPU fallback: without WST_FORCE_CPU the run asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the run would use it")
    out = _cli("run", "--scene", "mini-3d", "--steps", "1", cpu=False)
    assert out.returncode != 0
    assert "needs a CUDA device and none is present" in out.stderr


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_trajectory_loads_in_the_other_package(writer_pkg, tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((3, 50, 2)).astype(np.float64)
    meta = {"scene": "dam-break-2d-4k", "note": [1, 2]}
    path = str(tmp_path / "traj.npz")
    writer, reader = ((export, jexport) if writer_pkg == "port"
                      else (jexport, export))
    w = writer.TrajectoryWriter(path, meta)
    for i, f in enumerate(frames):
        w.add_frame(f, 0.5 * i)
    w.write()
    with np.load(path) as data:
        files = {k: (data[k].dtype, data[k].shape) for k in data.files}
    positions, times, got_meta = reader.load_trajectory(path)
    want_pos, want_times, want_meta = writer.load_trajectory(path)
    assert files == {"positions": (np.float32, (3, 50, 2)),
                     "times": (np.float32, (3,)),
                     "metadata": (files["metadata"][0], ())}
    assert got_meta == want_meta == meta
    np.testing.assert_array_equal(positions, want_pos)
    np.testing.assert_array_equal(positions, frames.astype(np.float32))
    np.testing.assert_array_equal(times, want_times)


def test_cli_other_subcommands_in_process(port_run, monkeypatch, capsys):
    """scenes, bench, live, serve and render through cli.main on the CPU."""
    from water_sandbox_tpu_torch.viz import live

    monkeypatch.setenv("WST_FORCE_CPU", "1")
    cli.main(["scenes"])
    assert "reference-cube" in capsys.readouterr().out

    cli.main(["bench", "--scene", "mini-3d", "--neighbor-mode", "dense",
              "--steps", "2"])
    bench = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench["n"] == 512 and bench["particle_steps_per_s"] > 0

    class FakeTerm:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read_keys(self):
            return ["w"]

    monkeypatch.setattr(live, "_RawTerminal", FakeTerm)
    cli.main(["live", "--scene", "mini-3d", "--neighbor-mode", "dense",
              "--max-frames", "2", "--steps-per-frame", "1", "--no-color"])
    assert _stats(capsys.readouterr().out.splitlines()[-1])["step"] == 2

    cli.main(["serve", "--scene", "mini-3d", "--neighbor-mode", "dense",
              "--port", "0", "--max-seconds", "0.3", "--steps-per-frame",
              "1"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("viewer at http://127.0.0.1:")
    assert _stats(lines[-1])["step"] >= 1

    gif = str(port_run["dir"] / "anim.gif")
    cli.main(["render", "--trajectory", port_run["trajectory"], "--out",
              gif, "--fps", "5"])
    assert capsys.readouterr().out.strip() == f"gif -> {gif}"
    assert os.path.getsize(gif) > 1000
