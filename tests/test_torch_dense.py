"""The port's dense oracle (``ops/dense.py``) and hash keys
(``ops/hashing.py``) against the JAX package's on the same numpy inputs.

Bars: the hash keys, neighbour offsets, pair weights and bounded cell ids
bit-identical (integer arithmetic); the oracle's passes within rtol 2e-5 /
atol 2e-5·max(1, max|JAX|) (the same float32 formulas, summed over n pairs
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import KernelCoeffs as JKernelCoeffs
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.ops import dense as jdense
from water_sandbox_tpu.ops import hashing as jhashing
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import dense, hashing

RTOL = 2e-5


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=RTOL,
        atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def _case(dim, n=160, seed=0, coincident=False):
    rng = np.random.default_rng(seed)
    pred = ((rng.random((n, dim)) - 0.5) * 1.4).astype(np.float32)
    if coincident:
        pred[7] = pred[3]              # d == 0: the +y direction
        pred[11] = pred[3]
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    jparams = JSimParams.create(dim=dim)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, dim)
    coeffs = wt.KernelCoeffs.from_radius(params.smoothing_radius, dim)
    return pred, vel, jparams, jcoeffs, params, coeffs


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dim,coincident", [(2, False), (3, False),
                                            (3, True), (2, True)])
def test_dense_passes_match_jax(dim, coincident, weighted):
    pred, vel, jparams, jcoeffs, params, coeffs = _case(
        dim, seed=dim, coincident=coincident)
    jw = tw = None
    if weighted:
        # a small table, so hashes collide and weights above 1 appear
        jw = jhashing.reference_pair_weights(
            jnp.asarray(pred), jparams.smoothing_radius, 5)
        tw = hashing.reference_pair_weights(
            torch.from_numpy(pred), params.smoothing_radius, 5)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert int(tw.max()) > 1
    want = jdense.density_pass(jnp.asarray(pred), jparams, jcoeffs, jw)
    got = dense.density_pass(torch.from_numpy(pred), params, coeffs, tw)
    for name, g, w in zip(("den", "nden", "prs", "nprs"), got, want):
        _close(g, w, name)
    jacc = jdense.force_pass(jnp.asarray(pred), jnp.asarray(vel), *want,
                             jparams, jcoeffs, jw)
    # the same densities into both force passes
    tin = [torch.from_numpy(np.array(w)) for w in want]
    acc = dense.force_pass(torch.from_numpy(pred), torch.from_numpy(vel),
                           *tin, params, coeffs, tw)
    assert bool(torch.isfinite(acc).all())
    _close(acc, jacc, "acc")


def test_coincident_pair_pushes_along_plus_y():
    """Two particles at one point, alone: the direction falls back to +y for
    both, so both accelerations are along y only and equal; the self pair is
    in the density (W(0) twice) and out of the force."""
    _, _, _, _, params, coeffs = _case(3)
    pred = torch.zeros((2, 3))
    den, nden, prs, nprs = dense.density_pass(pred, params, coeffs)
    h = params.smoothing_radius
    np.testing.assert_allclose(
        den.numpy(), float(2 * h * h * coeffs.pow2 + 1e-5), rtol=1e-6)
    acc = dense.force_pass(pred, torch.zeros_like(pred), den, nden, prs,
                           nprs, params, coeffs)
    assert float(acc[:, [0, 2]].abs().max()) == 0.0
    assert float(acc[0, 1]) == float(acc[1, 1]) != 0.0


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("table", [1, 97, 65536, 1015920])
def test_reference_hash_bit_identical(dim, table):
    """Negative cells (two's complement as uint32) and cells whose products
    and sums pass 2^32 several times over."""
    rng = np.random.default_rng(table + dim)
    cell = np.concatenate([
        rng.integers(-40, 40, (200, dim)),
        rng.integers(-2**31, 2**31 - 1, (200, dim)),
        np.array([[-1] * dim, [0] * dim, [2**31 - 1] * dim,
                  [-2**31] * dim, [271433] * dim]),
    ]).astype(np.int32)
    want = np.asarray(jhashing.reference_hash(jnp.asarray(cell), table))
    got = hashing.reference_hash(torch.from_numpy(cell), table)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the arithmetic itself, in Python integers
    primes = (15823, 9737333, 440817757)[:dim]
    for row, key in zip(cell[::37].tolist(), got[::37].tolist()):
        acc = 0
        for c, p in zip(row, primes):
            acc = (acc + ((c % 2**32) * p) % 2**32) % 2**32
        assert key == acc % table
    # batched cells (c, m, dim), as the candidate walk passes them
    np.testing.assert_array_equal(
        hashing.reference_hash(torch.from_numpy(cell).reshape(5, -1, dim),
                               table).numpy().reshape(-1), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_cell_id_helpers_bit_identical(dim):
    rng = np.random.default_rng(dim)
    dims = (7, 5, 6)[:dim]
    pred = ((rng.random((300, dim)) - 0.5) * 3.0).astype(np.float32)
    h = np.float32(0.25)
    np.testing.assert_array_equal(
        hashing.neighbor_offsets(dim).numpy(),
        np.asarray(jhashing.neighbor_offsets(dim)))
    jorigin = jhashing.grid_origin(jnp.asarray(pred), jnp.float32(h))
    origin = hashing.grid_origin(torch.from_numpy(pred), torch.tensor(h))
    want = jhashing.bounded_cell_ids(jnp.asarray(pred), jnp.float32(h),
                                     jorigin, dims)
    got = hashing.bounded_cell_ids(torch.from_numpy(pred), torch.tensor(h),
                                   origin, dims)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) == max(dims) - 1, "the case must clamp"
    cell = rng.integers(-2, 9, (100, dim)).astype(np.int32)
    np.testing.assert_array_equal(
        hashing.linearize(torch.from_numpy(cell), dims).numpy(),
        np.asarray(jhashing.linearize(jnp.asarray(cell), dims)))
