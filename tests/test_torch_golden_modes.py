"""The port's own golden pins (``water_sandbox_tpu_torch/golden.py``) on the
CPU, the mirror of tests/test_golden.py for the port.

Each pipeline sums its pairs in its own order and the differences grow
chaotically over a few dozen steps, so the port pins its own trajectories,
made with ``python -m water_sandbox_tpu_torch.golden ... --device cpu`` on
one intra-op thread, at the JAX package's bars. Where the port's run also
meets the JAX package's own pin at those bars, it is held to that pin too.
The planted physics bug of the sensitivity check (the near-pressure
derivative negated) must trip at least one pin in each fast case. The long
pins run only with WST_SLOW=1, as tests/test_golden.py's do."""

import functools
import importlib.util
import json
import os

import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from test_golden import GOLDEN as JAX_PINS

from water_sandbox_tpu_torch import golden
from water_sandbox_tpu_torch.core.params import KernelCoeffs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

slow = pytest.mark.skipif(not os.environ.get("WST_SLOW"),
                          reason="long golden; set WST_SLOW=1")

FAST = [("dam-break-2d-4k", "bucket_grid", 40), ("mini-3d", "dense", 60),
        ("mini-3d", "bucket_grid", 60)]
SLOW = [("interactive-2d-16k", "bucket_grid", 200),
        ("mini-3d", "dense", 1000),
        ("dam-break-2d-4k", "bucket_grid", 1000),
        ("dam-break-2d-4k", "pallas", 200)]
# the port's runs that also meet the JAX package's pin at its bars
MEETS_JAX = [("mini-3d", "dense", 60), ("mini-3d", "bucket_grid", 60)]
# the sensitivity check's CPU cases (("mini-3d", "pallas", 60) is checked
# on the card by chip_smoke.py)
FLIP = [("mini-3d", "dense", 60), ("dam-break-2d-4k", "bucket_grid", 40)]


@functools.lru_cache(maxsize=None)
def _stats(key, flipped=False):
    """The port's statistics for pin ``key`` on the CPU (one run a key per
    test process; the tests only read the result)."""
    name, mode, steps = key
    kw = golden.GOLDEN[key].get("kw", {})
    if not flipped:
        return golden.stats(name, mode, steps, device="cpu", **kw)
    with golden.flipped_near_derivative():
        return golden.stats(name, mode, steps, device="cpu", **kw)


@pytest.mark.parametrize("key", FAST + [pytest.param(k, marks=slow)
                                        for k in SLOW])
def test_port_pin_holds(key):
    got = _stats(key)
    assert golden.check(got, golden.GOLDEN[key]) == [], (
        golden.margins(got, golden.GOLDEN[key]))


@pytest.mark.parametrize("key", MEETS_JAX)
def test_port_run_meets_the_jax_pin(key):
    got = _stats(key)
    assert golden.check(got, JAX_PINS[key]) == [], (
        golden.margins(got, JAX_PINS[key]))


@pytest.mark.parametrize("key", FLIP)
def test_flipped_near_derivative_trips_a_pin(key):
    tripped = golden.check(_stats(key, flipped=True), golden.GOLDEN[key])
    print(f"{'|'.join(map(str, key))}: tripped {tripped}")
    assert tripped


@slow
def test_dam_break_miss_of_the_jax_pin_is_chaos():
    """The port's ("dam-break-2d-4k", "bucket_grid", 40) run misses the JAX
    package's pin (on rq) by rounding grown chaotically, not by a fault:
    it tracks the JAX run to rounding over the first steps, the gap grows
    by orders of magnitude after, and the JAX package's own kernel
    pipeline misses that pin by more."""
    import numpy as np
    from water_sandbox_tpu.models import scenes as jscenes
    from water_sandbox_tpu.ops.step import rollout as jrollout
    import water_sandbox_tpu_torch as wt

    key = ("dam-break-2d-4k", "bucket_grid", 40)
    jcfg, jparams, js = jscenes.build(key[0], neighbor_mode=key[1])
    cfg, params, s = wt.scenes.build(key[0], device="cpu",
                                     neighbor_mode=key[1])
    gap, done = {}, 0
    for step in (1, 10, 20, 30, 40):
        js = jrollout(js, jparams, jcfg, step - done)
        s = wt.rollout(s, params, cfg, step - done)
        done = step
        # both keep particle order: compare row by row
        gap[step] = float(np.abs(np.asarray(js.pos) - s.pos.numpy()).max())
    c2, p2, js2 = jscenes.build(key[0], neighbor_mode="pallas")
    js2 = jrollout(js2, p2, c2, 40)
    jax_pallas = golden.summarize(wt.FluidState(**{
        f: torch.from_numpy(np.asarray(getattr(js2, f)).copy())
        for f in wt.FluidState.__dataclass_fields__}))
    port = golden.margins(golden.summarize(s), JAX_PINS[key])
    other = golden.margins(jax_pallas, JAX_PINS[key])
    print(f"max |dpos| port vs JAX by step {gap}; port against the JAX pin "
          f"{port}; JAX's pallas pipeline against it {other}")
    assert gap[1] < 1e-6 and gap[10] < 1e-5
    assert gap[40] > 1e3 * gap[10]
    assert max(other.values()) > 1.0
    assert max(port.values()) < max(other.values())


def test_flip_patches_the_factory_only_while_open():
    h = torch.tensor(0.35)
    plain = KernelCoeffs.from_radius(h, 3)
    with golden.flipped_near_derivative():
        flipped = KernelCoeffs.from_radius(h, 3)
    after = KernelCoeffs.from_radius(h, 3)
    assert torch.equal(flipped.pow3_der, -plain.pow3_der)
    assert torch.equal(flipped.pow2_der, plain.pow2_der)
    assert torch.equal(after.pow3_der, plain.pow3_der)


def test_check_applies_the_bars_and_a_pins_own_bars():
    pin = dict(golden.GOLDEN[("mini-3d", "dense", 60)])
    got = dict(pin, overflow_total=0.0)
    assert golden.check(got, pin) == []
    # ke's bar is rtol 2e-3: 1.5e-3 holds, 2.5e-3 trips
    assert golden.check(dict(got, ke=pin["ke"] * 1.0015), pin) == []
    assert golden.check(dict(got, ke=pin["ke"] * 1.0025), pin) == ["ke"]
    # bbox_hi's bar is atol 5e-3; the pin's own bar widens it
    hi = [pin["bbox_hi"][0], pin["bbox_hi"][1] + 0.01, pin["bbox_hi"][2]]
    assert golden.check(dict(got, bbox_hi=hi), pin) == ["bbox"]
    assert golden.check(dict(got, bbox_hi=hi),
                        dict(pin, bars={"bbox_hi": 0.02})) == []
    assert golden.check(dict(got, overflow_total=1.0), pin) == [
        "overflow_total"]


# the pins made on the card (chip_smoke.py's [golden] phases)
CARD = [("reference-cube", "pallas", 1000),
        ("moving-container-256k", "pallas", 1000),
        ("dam-break-2d-4k", "dense", 1000)]


def test_every_pin_records_where_it_was_made():
    assert set(golden.GOLDEN) == set(FAST) | set(SLOW) | set(CARD)
    for key, pin in golden.GOLDEN.items():
        made = pin["made_on"]
        if key in FAST or key in SLOW:
            assert made == "cpu", key
        else:
            assert "H100" in made and "W" in made and "torch" in made \
                and "CUDA" in made, (key, made)
            # bars from the spread of the card's summation orders
            assert set(pin["bars"]) <= set(golden.BARS), key


def test_jax_pin_copy_matches_the_jax_table():
    # every card pin is printed beside the JAX package's pin of its key
    assert set(CARD) <= set(golden.JAX_GOLDEN)
    for key, pin in golden.JAX_GOLDEN.items():
        want = {k: v for k, v in JAX_PINS[key].items() if k != "marks"}
        assert pin == want, key


def test_stats_have_the_keys_and_rounding_of_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "gen_goldens", os.path.join(REPO, "tools", "gen_goldens.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.stats("mini-3d", "dense", 5)
    got = golden.stats("mini-3d", "dense", 5, device="cpu")
    assert list(got) == list(want)
    digits = dict(com=5, ke=2, bbox_lo=5, bbox_hi=5, mean_rho=4, vq=5, rq=4)
    for key, d in digits.items():
        vals = got[key] if isinstance(got[key], list) else [got[key]]
        assert all(round(v, d) == v for v in vals), key
    assert isinstance(got["overflow"], int)
    assert isinstance(got["overflow_total"], float)
    # five steps of the same physics: well inside the bars
    assert golden.check(got, want) == [], golden.margins(got, want)


def test_cli_prints_one_json_line_keyed_scene_mode_steps(capsys):
    golden.main(["mini-3d", "dense", "3", '{"chunk": 128}', "--device",
                 "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["mini-3d|dense|3"]
    assert out["mini-3d|dense|3"] == golden.stats("mini-3d", "dense", 3,
                                                  device="cpu", chunk=128)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        golden.main(["mini-3d", "dense", "3"])
