"""The port's CUDA kernels on a CUDA device: each kernel against its plain
PyTorch version, and one main-path step on the card against the same step
on the CPU (plain versions). Without a CUDA device each test skips (the
``cuda_device`` fixture decides, at run time). This file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bar: rtol = atol = 2e-4 (the kernels sum pairs in another order; the force
kernel uses rsqrtf)."""

import numpy as np
import pytest
import torch

import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core.params import KernelCoeffs, SimConfig
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _at(planes, occ):
    return planes.reshape(planes.shape[0], -1)[:, occ].cpu().numpy()


@pytest.mark.parametrize("dim", [2, 3])
def test_kernels_match_plain(cuda_device, dim):
    rng = np.random.default_rng(5)
    pred = ((rng.random((2000, dim)) - 0.5) * 2.5).astype(np.float32)
    vel = rng.standard_normal((2000, dim)).astype(np.float32)
    params = wt.SimParams.create(dim=dim, device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(n=pred.shape[0], dim=dim, grid_dims=(14,) * dim,
                    cell_capacity=16)
    planes, counts, addr, _ = sb._build_slab_buckets(
        torch.from_numpy(pred).to(cuda_device),
        torch.from_numpy(vel).to(cuda_device), params, cfg)
    pv = sb._param_vector(params, coeffs)
    occ = addr[addr < sb._cap_pad(cfg.cell_capacity)
               * sb._geometry(cfg).L].long()
    sb.reset_launches()
    dens = sb.run_density(planes, counts, addr, pv, cfg)
    out = sb.run_force(planes, dens, counts, addr, pv, cfg)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == {"sph_density": 1, "sph_force": 1}
    dens_p = sb.density_plain(planes, counts, addr, pv, cfg)
    out_p = sb.force_plain(planes, dens, counts, addr, pv, cfg)
    np.testing.assert_allclose(_at(dens, occ), _at(dens_p, occ), **TOL)
    np.testing.assert_allclose(_at(out, occ), _at(out_p, occ), **TOL)


def test_step_matches_cpu(cuda_device):
    cfg, params, state = wt.scenes.build("mini-3d", sorted_state=True,
                                         rescue_capacity=64)
    state = wt.rollout(state, params, cfg, 20)
    sb.reset_launches()
    got = wt.step(state.to(cuda_device), params.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == {"sph_density": 1, "sph_force": 1}
    want = wt.step(state, params, cfg)
    np.testing.assert_array_equal(got.ids.cpu().numpy(), want.ids.numpy())
    for f in ("pos", "vel", "acc", "density", "near_density", "pressure"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), **TOL,
                                   err_msg=f)


def test_wrappers_refuse_mixed_devices(cuda_device):
    cfg, params, state = wt.scenes.build("mini-3d", device=cuda_device)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, 3)
    planes, counts, addr, _ = sb._build_slab_buckets(
        state.predicted, state.vel, params, cfg)
    pv = sb._param_vector(params, coeffs)
    with pytest.raises(ValueError, match="one device"):
        sb.run_density(planes, counts.cpu(), addr, pv, cfg)
