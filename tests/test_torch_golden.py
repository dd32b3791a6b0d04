"""The port's 60-step ``mini-3d`` run (bucket-kernel pipeline, plain
versions on the CPU) against the JAX package's golden pin
("mini-3d", "pallas", 60) at that pin's own tolerances (``golden.check``
applies tests/test_golden.py's bars)."""

import pytest

import water_sandbox_tpu_torch as wt
from test_golden import GOLDEN
from water_sandbox_tpu_torch import golden


@pytest.mark.parametrize("sorted_state", [False, True])
def test_mini_3d_pallas_golden(sorted_state):
    g = GOLDEN[("mini-3d", "pallas", 60)]
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode="pallas",
                                         sorted_state=sorted_state,
                                         **g["kw"])
    got = golden.summarize(wt.rollout(state, params, cfg, 60))
    assert golden.check(got, g) == [], golden.margins(got, g)
