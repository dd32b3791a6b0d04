"""The port's bitonic sort (``ops/cuda/bitonic_sort.py``) against the JAX
package's Pallas sort in interpret mode, on the CPU, where the port runs the
network's plain version. Inputs are made with numpy.

Bar: keys AND values bit-identical, ties included — both run the same
compare-exchange network with strict comparisons, so equal keys move
together and in the same places."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from water_sandbox_tpu.ops.pallas import bitonic_sort as jbitonic
from water_sandbox_tpu_torch.ops.cuda import bitonic_sort as bs


def _both(keys, vals):
    want = jbitonic.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                               interpret=True)
    got = bs.sort_pairs(torch.from_numpy(keys), torch.from_numpy(vals))
    return got, want


@pytest.mark.parametrize("n", [1000, 1024, 2500, 4096])
def test_sort_pairs_bit_identical_to_jax(n):
    rng = np.random.default_rng(n)
    # few distinct keys, so most keys tie; negative and extreme keys too
    keys = rng.integers(-300, 300, n).astype(np.int32)
    keys[:3] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0]
    vals = rng.permutation(n).astype(np.int32)
    bs.reset_launches()
    (gk, gv), (wk, wv) = _both(keys, vals)
    assert bs.LAUNCHES["bitonic_sort"] == 0       # CPU: the plain version
    assert gk.dtype == gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gk.numpy(), np.sort(keys))


@pytest.mark.parametrize("n", [1000, 3000])
@pytest.mark.parametrize("kind", ["int32_max", "all_equal"])
def test_sort_pairs_plain_padding_ties_match_jax(n, kind):
    """Real INT32_MAX keys tie with the (INT32_MAX, 0) padding, and
    all-equal keys tie everywhere: the network alone decides where each
    pair lands, so the padding must be the same pairs as the JAX
    package's."""
    rng = np.random.default_rng(n)
    if kind == "all_equal":
        keys = np.full(n, 7, np.int32)
    else:
        keys = rng.integers(-50, 50, n).astype(np.int32)
        keys[rng.random(n) < 0.3] = np.iinfo(np.int32).max
    vals = rng.permutation(n).astype(np.int32)
    wk, wv = jbitonic.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                                 interpret=True)
    gk, gv = bs.sort_pairs_plain(torch.from_numpy(keys),
                                 torch.from_numpy(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_argsort_keys_ties_match_jax():
    """tests/test_pallas_sort.py:26's tie-heavy case: the order (which of
    the equal keys comes first) is JAX's, not just some valid order."""
    keys = np.asarray([5, 3, 3, 9, 0, 5, 3, 1] * 128, np.int32)
    wk, worder = jbitonic.argsort_keys(jnp.asarray(keys), interpret=True)
    gk, gorder = bs.argsort_keys(torch.from_numpy(keys))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gorder.numpy(), np.asarray(worder))
    np.testing.assert_array_equal(keys[gorder.numpy()], gk.numpy())


def test_sort_pairs_refuses_what_the_kernel_does_not_take():
    big = torch.zeros(65537, dtype=torch.int32)
    with pytest.raises(ValueError, match="too large"):
        bs.sort_pairs(big, big)
    with pytest.raises(ValueError, match="too large"):
        jbitonic.sort_pairs(jnp.zeros(65537, jnp.int32),
                            jnp.zeros(65537, jnp.int32), interpret=True)
    k = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="one length"):
        bs.sort_pairs(k, torch.zeros(11, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        bs.sort_pairs(k.to("meta"), k.to("meta"))
