"""The port's bench (``water_sandbox_tpu_torch/bench.py``) and profiling
hooks (``runtime/profiling.py``) on the CPU: the bench's protocol runs and
gives a positive rate, its pair count is exact (a direct count on the same
positions) and within 1e-4 relative of the JAX bench's ``true_pairs``
expression, its fingerprint's tile is the JAX bench's, and the device
trace is written."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.models import scenes as jscenes
from water_sandbox_tpu.ops.pallas import sph_bucket as jsb
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch import bench
from water_sandbox_tpu_torch.runtime import profiling


def _jax_true_pairs(pos, h):
    """The JAX bench's pair count (bench.py, ``true_pairs``), verbatim."""
    n = pos.shape[0]
    c = 8192
    n_pad = -(-n // c) * c
    padded = jnp.pad(pos, ((0, n_pad - n), (0, 0)), constant_values=1e15)
    chunks = padded.reshape(n_pad // c, c, -1)

    def body(tot, cpos):
        d2 = jnp.sum((cpos[:, None, :] - pos[None, :, :]) ** 2, -1)
        return tot + jnp.sum(d2 <= h * h), None

    tot, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), chunks)
    return tot


def test_measure_gives_a_positive_rate():
    sim, rate, transient, done = bench.measure(
        "mini-3d", "dense", chunk=2, settle=4, device="cpu")
    assert rate > 0 and transient > 0
    assert done == 4 and int(sim.state.step_count) == 4 + 3 * 2
    fp = bench.fingerprint(sim)
    assert fp["n"] == 512 and fp["neighbor_mode"] == "dense"
    assert fp["kernels"] is None and fp["tile"] is None
    json.dumps(fp)


@pytest.mark.parametrize("dim,n", [(3, 3000), (2, 2500)])
def test_true_pairs_is_exact(dim, n):
    """Small temporaries (many row chunks) on a seeded cloud dense enough
    for ~20 neighbours a particle, with pairs exactly at h."""
    rng = np.random.default_rng(dim)
    side = (n / 20.0 * 4.19 * 0.25 ** 3) ** (1 / 3) if dim == 3 else (
        n / 20.0 * 3.14 * 0.25 ** 2) ** 0.5
    pos = (rng.random((n, dim)) * side).astype(np.float32)
    pos[1] = pos[0]
    pos[2] = pos[0] + np.float32(0.25) * np.eye(dim, dtype=np.float32)[0]
    h = torch.tensor(0.25)
    got = bench.true_pairs(torch.from_numpy(pos), h, temp_bytes=4 * n * 97)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    direct = int((d2 <= np.float32(0.25) * np.float32(0.25)).sum())
    assert got == direct and got > 15 * n
    jax_count = float(_jax_true_pairs(jnp.asarray(pos), jnp.float32(0.25)))
    assert abs(got - jax_count) <= 1e-4 * jax_count


@pytest.mark.parametrize("scene", ["moving-container-256k", "reference-cube"])
def test_fingerprint_tile_is_the_jax_benchs(scene):
    """The port's _geometry picks the JAX bench's ``tile`` for both bench
    scenes (the flagship pins 1024 lanes)."""
    jcfg, _, _ = jscenes.build(scene)
    tcfg, _, _ = wt.scenes.build(scene, device="cpu")
    assert (wt.ops.cuda.sph_bucket._geometry(tcfg).T
            == jsb._geometry(jcfg).T)


def test_device_trace_writes_a_trace(tmp_path):
    sim = wt.Simulation.from_scene("mini-3d", neighbor_mode="dense",
                                   device="cpu")
    logdir = str(tmp_path / "trace")
    with profiling.device_trace(logdir) as prof:
        sim.run(2)
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(prof.key_averages()) > 0


def test_traced_idles_around_the_span_on_the_card(monkeypatch):
    """With a card, ``traced`` synchronises it and idles TRACE_MARGIN_S
    before and after the span, inside the profiler (the trace keeps the
    span's first kernels); on the CPU it adds nothing."""
    from torch.profiler import ProfilerActivity
    seen = []
    monkeypatch.setattr(profiling.time, "sleep",
                        lambda s: seen.append(("sleep", s)))
    with profiling.traced([ProfilerActivity.CPU]):
        seen.append("span")
    assert seen == ["span"]
    seen.clear()
    monkeypatch.setattr(profiling.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling.torch.cuda, "synchronize",
                        lambda: seen.append("sync"))
    with profiling.traced([ProfilerActivity.CPU]) as prof:
        seen.append("span")
        torch.ones(3).sum()
    margin = ("sleep", profiling.TRACE_MARGIN_S)
    assert profiling.TRACE_MARGIN_S > 0
    assert seen == ["sync", margin, "span", "sync", margin]
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
