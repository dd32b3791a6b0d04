"""The port's interactive layer: the HUD keymap against the JAX package's
(the same keys into a JAX and a port Simulation: every SimParams leaf bit
for bit, the same phases and replies), the headless live loop, and the
browser viewer's point and raster roundtrips (the mirrors of
tests/test_interactive.py)."""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.runtime import keymap as jkeymap
from water_sandbox_tpu.runtime.runner import Simulation as JSimulation
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.runtime import keymap
from water_sandbox_tpu_torch.runtime.runner import SimPhase

# every bound key, "1" until the radius floor refuses it, then Space and p
KEYS = ["2", "q", "w", "w", "a", "s", "z", "x", "x", "e", "r", "r", "3", "4",
        "4", "0", "9", "3", "1", "1", "1", "1", "p", "Q", "\x1b", " ", "p",
        "k"]


@pytest.fixture(scope="module")
def sim():
    return wt.Simulation.from_scene("mini-3d", neighbor_mode="dense",
                                    device="cpu")


def test_keymap_matches_jax():
    jsim = JSimulation.from_scene("mini-3d", neighbor_mode="dense")
    tsim = wt.Simulation.from_scene("mini-3d", neighbor_mode="dense",
                                    device="cpu")
    jsim.run(1)
    tsim.run(1)
    replies = []
    for key in KEYS:
        want = jkeymap.apply_key(jsim, key)
        got = keymap.apply_key(tsim, key)
        assert got == want, key
        assert tsim.phase.value == jsim.phase.value, key
        for i, (g, w) in enumerate(zip(
                convert.params_to_numpy(tsim.params),
                jax.tree.leaves(jsim.params))):
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{key!r} leaf {i}")
        assert keymap.params_line(tsim) == jkeymap.params_line(jsim)
        replies.append(got)
    assert "smoothing radius at minimum" in replies
    assert replies[-1] is None
    assert tsim.phase is SimPhase.READY and int(tsim.state.step_count) == 0


def test_live_loop_headless(sim, monkeypatch):
    """run_live with a stub terminal feeding keys: w raises the pressure,
    Space resets at frame 2, one step after it."""
    from water_sandbox_tpu_torch.viz import live

    keys = iter([["w"], [" "], []])

    class FakeTerm:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read_keys(self):
            return next(keys, [])

    monkeypatch.setattr(live, "_RawTerminal", FakeTerm)
    out = io.StringIO()
    sim.reset()
    k0 = float(sim.params.pressure_scalar)
    live.run_live(sim, width=32, height=8, steps_per_frame=1, max_frames=3,
                  color=False, out=out)
    assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)
    assert int(sim.state.step_count) == 1
    assert "step" in out.getvalue()
    sim.tune(pressure_scalar=k0)


def _serve(server):
    t = threading.Thread(target=server.serve, kwargs={"max_seconds": 30.0})
    t.start()
    host, port = server.httpd.server_address[:2]
    return t, f"http://{host}:{port}"


def _get(url):
    return urllib.request.urlopen(url, timeout=5).read()


def _first_frame(base):
    for _ in range(300):
        body = _get(f"{base}/state.json")
        if body != b"{}":
            return json.loads(body)
        time.sleep(0.05)
    raise AssertionError("no frame served")


def test_viewer_server_roundtrip(sim):
    from water_sandbox_tpu_torch.viz.server import ViewerServer

    sim.reset()
    server = ViewerServer(sim, port=0, steps_per_frame=1)  # ephemeral port
    t, base = _serve(server)
    try:
        frame = _first_frame(base)
        assert frame["mode"] == "points" and frame["dim"] == 3
        pos = np.frombuffer(base64.b64decode(frame["pos"]), np.float32)
        assert pos.size == 3 * sim.cfg.n and np.isfinite(pos).all()
        assert "hud" in frame and "h=" in frame["hud"]
        assert "canvas" in _get(base).decode()

        k0 = float(sim.params.pressure_scalar)
        assert "pressure_scalar" in _get(f"{base}/key?k=w").decode()
        assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)

        # /field aims the InteractionField, the next frame advertises it,
        # /field?off=1 disables it
        desc = _get(f"{base}/field?x=0.5&y=-0.25&z=0.1&s=-20").decode()
        assert "field" in desc
        assert float(sim.params.field.strength) == pytest.approx(-20.0)
        np.testing.assert_allclose(sim.params.field.position.numpy(),
                                   [0.5, -0.25, 0.1], atol=1e-6)
        assert float(sim.params.field.radius) > 0
        for _ in range(300):
            frame = json.loads(_get(f"{base}/state.json"))
            if "field" in frame:
                break
            time.sleep(0.05)
        assert frame["field"]["s"] == pytest.approx(-20.0)
        assert frame["field"]["p"] == pytest.approx([0.5, -0.25, 0.1])
        assert "off" in _get(f"{base}/field?off=1").decode()
        assert float(sim.params.field.strength) == 0.0
    finally:
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive()
    sim.tune(pressure_scalar=k0)


def test_viewer_handlers_take_the_simulations_lock(sim):
    """A key request waits while the Simulation's lock is held (in the
    viewer, by the stepping thread around a frame), so a tune or a reset
    never lands between two steps of one frame."""
    from water_sandbox_tpu_torch.viz.server import ViewerServer

    server = ViewerServer(sim, port=0)
    server.thread.start()                   # requests only, no stepping
    host, port = server.httpd.server_address[:2]
    k0 = float(sim.params.pressure_scalar)
    got = {}

    def press():
        got["desc"] = _get(f"http://{host}:{port}/key?k=w").decode()

    try:
        with sim.lock:
            t = threading.Thread(target=press)
            t.start()
            t.join(0.3)
            assert t.is_alive(), "the key was applied under a held lock"
            assert float(sim.params.pressure_scalar) == k0
        t.join(10)
        assert "pressure_scalar" in got["desc"]
        assert float(sim.params.pressure_scalar) == pytest.approx(k0 + 0.1)
    finally:
        server.httpd.shutdown()
        server.httpd.server_close()
        sim.tune(pressure_scalar=k0)


def test_viewer_server_raster_mode(sim):
    """The raster stream: a density/speed image made on the sim's device in
    place of a point cloud."""
    from water_sandbox_tpu_torch.viz.server import ViewerServer

    server = ViewerServer(sim, port=0, steps_per_frame=1, render="raster",
                          raster_size=(96, 54))
    t, base = _serve(server)
    try:
        frame = _first_frame(base)
        assert frame["mode"] == "raster"
        den = np.frombuffer(base64.b64decode(frame["den"]), np.uint8)
        assert den.size == frame["rw"] * frame["rh"] == 96 * 54
        assert den.max() > 0
        spd = np.frombuffer(base64.b64decode(frame["spd"]), np.uint8)
        assert spd.size == den.size
    finally:
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive()


def test_viewer_raster_follows_the_moving_container():
    """The raster's bounds are the box's at the sim's time (center +
    velocity·t), as in the JAX viewer, so a moving box stays in frame."""
    from water_sandbox_tpu_torch.viz import raster
    from water_sandbox_tpu_torch.viz.server import ViewerServer

    cfg, params, state = wt.scenes.build("mini-3d", neighbor_mode="dense",
                                         device="cpu")
    box = dataclasses.replace(params.container,
                              velocity=torch.tensor([1.5, -0.5, 0.0]))
    sim = wt.Simulation(cfg, dataclasses.replace(params, container=box),
                        state)
    sim.run(30)
    server = ViewerServer(sim, port=0, render="raster", raster_size=(64, 36))
    try:
        server._snapshot()
    finally:
        server.httpd.server_close()
    frame = json.loads(server.frame["json"])
    center = box.center + box.velocity * float(sim.state.time)
    np.testing.assert_allclose(frame["center"], center.numpy(), rtol=1e-6)
    lo, hi = (center - box.half_size)[:2], (center + box.half_size)[:2]
    den = raster.raster2d(sim.state.pos, sim.state.density, (lo, hi), 64,
                          36).numpy()
    want = np.clip(den / max(float(np.percentile(den, 99.5)), 1e-6) * 255.0,
                   0, 255).astype(np.uint8)
    got = np.frombuffer(base64.b64decode(frame["den"]), np.uint8)
    np.testing.assert_array_equal(got, want.reshape(-1))
