"""The port's two kernels (water_sandbox_tpu_torch/ops/cuda/sph_bucket.py):
their plain PyTorch versions against the JAX package's Pallas kernels (run
in interpret mode, as its own tests run them on the CPU), and the wrappers'
CPU path, input checks and launch counters.

Inputs: 96 particles made by numpy from a seed, grid 8³, cell capacity 8.
Bar: rtol = atol = 2e-4 at occupied slots (the passes sum pairs in other
orders; outputs at empty slots are unspecified). The kernels themselves are
held against their plain versions in test_torch_cuda.py, on a CUDA device."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from water_sandbox_tpu.core.params import KernelCoeffs as JKernelCoeffs
from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.ops.pallas import sph_bucket as jsb
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.core.params import KernelCoeffs, SimConfig
from water_sandbox_tpu_torch.ops.cuda import _build
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(dim=3, n=96, seed=0, spread=1.6):
    rng = np.random.default_rng(seed)
    pred = ((rng.random((n, dim)) - 0.5) * spread).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    return pred, vel


@pytest.fixture(scope="module")
def case():
    """Both packages' inputs for one bucket build, and the JAX density
    kernel's output (one interpret-mode Pallas call, shared)."""
    dim = 3
    pred, vel = _inputs(dim)
    jparams = JSimParams.create(dim=dim)
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, dim)
    jcfg = JSimConfig(n=pred.shape[0], dim=dim, neighbor_mode="pallas",
                      grid_dims=(8,) * dim, cell_capacity=8)
    jplanes, jcounts, jaddr, _ = jsb._build_slab_buckets(
        jnp.asarray(pred), jnp.asarray(vel), jparams, jcfg)
    own, m0 = jsb.occupancy_bounds(jcounts, jsb._geometry(jcfg))
    jpv = jsb._param_vector(jparams, jcoeffs)
    jdens = jsb._run_density(jplanes, own, m0, jpv, jcfg, interpret=True)

    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)],
        device="cpu")
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, dim)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    planes, counts, addr, _ = sb._build_slab_buckets(
        torch.from_numpy(pred), torch.from_numpy(vel), params, cfg)
    pv = sb._param_vector(params, coeffs)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    occ = addr[addr < sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L]
    return dict(jcfg=jcfg, jplanes=jplanes, own=own, m0=m0, jpv=jpv,
                jdens=jdens, cfg=cfg, planes=planes, counts=counts,
                addr=addr, pv=pv, occ=occ.long())


def _at(planes, occ):
    p = torch.as_tensor(np.array(planes))
    return p.reshape(p.shape[0], -1)[:, occ].numpy()


def test_density_plain_matches_pallas(case):
    got = sb.density_plain(case["planes"], case["counts"], case["addr"],
                           case["pv"], case["cfg"])
    want = _at(case["jdens"], case["occ"])
    assert want.shape == (6, case["occ"].shape[0]) and want.shape[1] > 80
    np.testing.assert_allclose(_at(got, case["occ"]), want, **TOL)


@pytest.mark.parametrize("gate", [("qsym", 8), ("qrow3", 8)])
def test_force_plain_matches_pallas(case, gate):
    """K2 (qsym, the single-chip production gate) and K3 (qrow3, the
    domain-decomposed gate) share one output contract, which force_plain
    and the port's sph_force kernel compute."""
    jout = jsb._run_force(case["jplanes"], case["jdens"], case["own"],
                          case["m0"], case["jpv"], case["jcfg"],
                          interpret=True, gate=gate)
    dens = torch.from_numpy(np.array(case["jdens"]))
    got = sb.force_plain(case["planes"], dens, case["counts"], case["addr"],
                         case["pv"], case["cfg"])
    np.testing.assert_allclose(_at(got, case["occ"]),
                               _at(jout, case["occ"]), **TOL)


@pytest.mark.parametrize("dim,cap", [(2, 32), (2, 2), (3, 32), (3, 2)])
def test_build_fills_empty_position_slots_with_far(dim, cap):
    """The density kernel reads the empty slots of its neighbour lanes
    without asking the counts (csrc/sph_density.cu), so the build must leave
    _FAR in every position slot at or above its lane's count: full lanes,
    overflowing ones (capacity 2) and the pad lanes included."""
    pred, vel = _inputs(dim, n=400, seed=3)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(JSimParams.create(dim=dim))],
        device="cpu")
    cfg = SimConfig(n=pred.shape[0], dim=dim, neighbor_mode="pallas",
                    grid_dims=(8,) * dim, cell_capacity=cap)
    planes, counts, addr, overflow = sb._build_slab_buckets(
        torch.from_numpy(pred), torch.from_numpy(vel), params, cfg)
    assert (int(overflow) > 0) == (cap == 2)
    cap_p = sb._cap_pad(cap)
    empty = torch.arange(cap_p)[:, None] >= counts
    assert empty.any() and (~empty).any()
    assert bool((planes[:dim][:, empty] == sb._FAR).all())
    assert bool((planes[:dim][:, ~empty].abs() < 10.0).all())


def test_wrappers_take_plain_path_on_cpu(case):
    _build.reset_launches()
    args = (case["planes"], case["counts"], case["addr"], case["pv"])
    dens = sb.run_density(*args, case["cfg"])
    np.testing.assert_array_equal(
        _at(dens, case["occ"]),
        _at(sb.density_plain(*args, case["cfg"]), case["occ"]))
    out = sb.run_force(case["planes"], dens, case["counts"], case["addr"],
                       case["pv"], case["cfg"])
    want = sb.force_plain(case["planes"], dens, case["counts"],
                          case["addr"], case["pv"], case["cfg"])
    np.testing.assert_array_equal(_at(out, case["occ"]),
                                  _at(want, case["occ"]))
    assert not any(_build.LAUNCHES.values())


def test_wrappers_check_inputs(case):
    cfg, planes, counts, addr, pv = (case["cfg"], case["planes"],
                                     case["counts"], case["addr"],
                                     case["pv"])
    with pytest.raises(TypeError, match="addr"):
        sb.run_density(planes, counts, addr.long(), pv, cfg)
    with pytest.raises(TypeError, match="planes"):
        sb.run_density(planes.double(), counts, addr, pv, cfg)
    with pytest.raises(ValueError, match="counts"):
        sb.run_density(planes, counts[:, :-1].contiguous(), addr, pv, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        sb.run_density(planes.transpose(1, 2).contiguous().transpose(1, 2),
                       counts, addr, pv, cfg)
    with pytest.raises(ValueError, match="planes"):
        sb.run_force(planes[:2].contiguous(), planes, counts, addr, pv, cfg)
    with pytest.raises(ValueError, match="addr"):
        sb.run_density(planes, counts, addr[None], pv, cfg)
    with pytest.raises(ValueError, match="dens"):
        sb.run_force(planes, planes[:5].contiguous(), counts, addr, pv, cfg)
