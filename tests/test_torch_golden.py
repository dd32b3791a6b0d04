"""The port's 60-step ``mini-3d`` run (bucket-kernel pipeline, plain
versions on the CPU) against the JAX package's golden pin
("mini-3d", "pallas", 60) at that pin's own tolerances."""

import numpy as np
import pytest

import water_sandbox_tpu_torch as wt
from test_golden import GOLDEN


@pytest.mark.parametrize("sorted_state", [False, True])
def test_mini_3d_pallas_golden(sorted_state):
    g = GOLDEN[("mini-3d", "pallas", 60)]
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode="pallas",
                                         sorted_state=sorted_state,
                                         **g["kw"])
    s = wt.rollout(state, params, cfg, 60)
    pos, vel = s.pos.numpy(), s.vel.numpy()
    rho = s.density.numpy()
    assert float(s.overflow_total) == 0.0
    np.testing.assert_allclose(pos.mean(0), g["com"], atol=2e-3)
    np.testing.assert_allclose(0.5 * (vel ** 2).sum(), g["ke"], rtol=2e-3)
    np.testing.assert_allclose(pos.min(0), g["bbox_lo"], atol=5e-3)
    np.testing.assert_allclose(pos.max(0), g["bbox_hi"], atol=5e-3)
    np.testing.assert_allclose(rho.mean(), g["mean_rho"], rtol=2e-3)
    speed = np.sqrt((vel ** 2).sum(axis=1))
    np.testing.assert_allclose(np.quantile(speed, (0.1, 0.5, 0.9)), g["vq"],
                               rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.quantile(rho, (0.1, 0.5, 0.9)), g["rq"],
                               rtol=2e-3)
