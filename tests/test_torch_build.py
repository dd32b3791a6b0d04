"""The port's bucket build against the JAX package's, bit for bit: planes,
counts, sorted-row addresses, sort order, sorted rows (with a carry) and
overflow — at n = 500 with cell capacities 1 and 4, so capacity-overflow
sentinels are present, and 8, which no cell's run passes — and the helpers
around the kernels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.core.params import Container as JContainer
from water_sandbox_tpu.ops.pallas import sph_bucket as jsb
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.core.params import SimConfig
from water_sandbox_tpu_torch.ops.cuda import _build, build
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb


def _case(frame="world", n=500, cap=4, seed=11):
    rng = np.random.default_rng(seed)
    pred = ((rng.random((n, 3)) - 0.5) * 1.6).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    jparams = JSimParams.create(dim=3, container=JContainer.create(
        (0.1, 0.0, -0.1), (3.0, 3.0, 3.0), velocity=(0.5, 0.0, 0.0),
        angular_velocity=0.4, angle=0.3))
    jcfg = JSimConfig(n=n, dim=3, neighbor_mode="pallas",
                      grid_dims=(10, 10, 10), cell_capacity=cap,
                      grid_frame=frame)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)],
        device="cpu")
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    return pred, vel, jparams, jcfg, params, cfg


@pytest.mark.parametrize("cap, overflows", [(1, True), (4, True),
                                             (8, False)])
@pytest.mark.parametrize("frame", ["world", "container"])
def test_build_core_bit_identical(frame, cap, overflows):
    """With the sorted step's carry (positions and bit-cast ids, two
    blocks), at capacities whose runs are longer than cap (1, 4) and one
    that no run passes (8)."""
    pred, vel, jparams, jcfg, params, cfg = _case(frame, cap=cap)
    n = pred.shape[0]
    ids = np.random.default_rng(3).permutation(n).astype(np.int32)
    pos = pred + np.float32(0.01)
    t = np.float32(0.9)
    jcarry = jnp.concatenate(
        [jnp.asarray(pos),
         jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.float32)[:, None]],
        axis=1)
    want = jsb._build_core(jnp.asarray(pred), jnp.asarray(vel), jparams,
                           jcfg, carry=jcarry, time=jnp.asarray(t))
    tcarry = (torch.from_numpy(pos),
              torch.from_numpy(ids).view(torch.float32)[:, None])
    got = sb._build_core(torch.from_numpy(pred), torch.from_numpy(vel),
                         params, cfg, carry=tcarry, time=torch.tensor(t))
    names = ("planes", "counts", "flat", "order", "srows", "overflow")
    for name, a, b in zip(names, got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        # bit patterns, so the bit-cast ids in srows compare exactly too
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    assert (int(got[5]) > 0) == overflows
    cap_pl = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    assert (got[2].numpy() == cap_pl).sum() == int(got[5])
    # ids ride the row gather: the carried ids are the permuted ids
    np.testing.assert_array_equal(
        got[4][:, 9].contiguous().view(torch.int32).numpy(),
        ids[got[3].numpy()])


def test_build_slab_buckets_bit_identical():
    pred, vel, jparams, jcfg, params, cfg = _case(cap=4, seed=5)
    want = jsb._build_slab_buckets(jnp.asarray(pred), jnp.asarray(vel),
                                   jparams, jcfg)
    got = sb._build_slab_buckets(torch.from_numpy(pred),
                                 torch.from_numpy(vel), params, cfg)
    for name, a, b in zip(("planes", "counts", "addr", "overflow"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(got[3]) > 0


def _bits(t):
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("carry", ["none", "two blocks"])
def test_build_wrapper_on_cpu_is_the_plain_chain(carry):
    """On CPU tensors the build's wrapper (``build.run_build``) is
    ``build_plain`` and launches nothing, without a carry and with the
    sorted step's (positions and bit-cast ids, two blocks), whose columns
    ride the row gather in order."""
    pred, vel, _, _, params, cfg = _case()
    p, v = torch.from_numpy(pred), torch.from_numpy(vel)
    ids = torch.from_numpy(
        np.random.default_rng(3).permutation(pred.shape[0]).astype(np.int32))
    blocks = {"none": (),
              "two blocks": (p + 0.01, ids.view(torch.float32)[:, None])}[
                  carry]
    _build.reset_launches()
    got = sb._build_core(p, v, params, cfg, carry=blocks)
    g = sb._geometry(cfg)
    order = got[3].long()
    args = (got[6], order, p, v, blocks, cfg.cell_capacity,
            sb._cap_pad(cfg.cell_capacity), g.L, g.PAD, build._NO_KEY_BOUND)
    direct = build.run_build(*args)
    assert not any(_build.LAUNCHES.values())
    for a, b, c in zip(direct, build.build_plain(*args), got):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))
    np.testing.assert_array_equal(
        _bits(got[4]), _bits(torch.cat([p, v, *blocks], dim=1)[order]))


def test_stable_sort_ties_follow_row_order():
    """Every particle in one cell: slots follow input row order, as
    jax.lax.sort((col, iota), num_keys=1) orders ties."""
    _, _, jparams, _, params, _ = _case()
    cfg = SimConfig(n=6, dim=3, grid_dims=(8, 8, 8), cell_capacity=8)
    pred = torch.full((6, 3), 0.01) + torch.arange(6)[:, None] * 1e-4
    pred = pred.flip(0).contiguous()
    planes, counts, flat, order, srows, ovf, scol = sb._build_core(
        pred, torch.zeros_like(pred), params, cfg)
    assert order.tolist() == list(range(6))
    L = sb._geometry(cfg).L
    assert (flat // L).tolist() == list(range(6))
    assert int(counts.max()) == 6 and int(ovf) == 0
    assert scol.tolist() == [int(scol[0])] * 6    # one cell


@pytest.mark.parametrize("kw", [
    dict(dim=3, grid_dims=(16, 12, 10)),
    dict(dim=3, grid_dims=(68, 40, 40)),
    dict(dim=3, grid_dims=(162, 32, 58), tile_override=1024),
    dict(dim=2, grid_dims=(68, 40)),
])
def test_geometry_matches_jax(kw):
    cfg = SimConfig(n=64, cell_capacity=24, **kw)
    jcfg = JSimConfig(n=64, cell_capacity=24, neighbor_mode="pallas", **kw)
    assert tuple(sb._geometry(cfg)) == tuple(jsb._geometry(jcfg))
    assert sb._cap_pad(24) == jsb._cap_pad(24) == 24
    assert sb._cap_pad(4) == jsb._cap_pad(4) == 8
    with pytest.raises(ValueError, match="z-dim"):
        sb._geometry(SimConfig(n=64, dim=3, grid_dims=(16, 12, 600)))


def test_derived_planes_and_gather_match_jax():
    _, _, jparams, _, params, _ = _case()
    rng = np.random.default_rng(2)
    den = (rng.random(50) * 300 + 1).astype(np.float32)
    nden = (rng.random(50) * 900 + 1).astype(np.float32)
    np.testing.assert_array_equal(
        sb.derived_density_planes(torch.from_numpy(den),
                                  torch.from_numpy(nden), params).numpy(),
        np.asarray(jsb.derived_density_planes(jnp.asarray(den),
                                              jnp.asarray(nden), jparams)))
    out_c = rng.standard_normal((5, 8, 40)).astype(np.float32)
    addr = rng.permutation(320)[:50].astype(np.int32)
    addr[[3, 17]] = 320                       # two dropped rows
    dropped = addr == 320
    got = sb.gather_results(torch.from_numpy(out_c), torch.from_numpy(addr),
                            torch.from_numpy(dropped), params)
    want = jsb.gather_results(jnp.asarray(out_c), jnp.asarray(addr),
                              jnp.asarray(dropped), jparams)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n, sms, group", [
    (65536, 132, 2), (266112, 132, 1), (4000, 132, 4), (253980, 132, 1),
    (101376, 132, 1), (101375, 132, 2), (0, 132, 4)])
def test_force_group_by_row_count(n, sms, group):
    """Threads a row of the density and the force kernel, one picker for
    both: more while n rows leave the card's warp slots empty
    (reference-cube's 65,536 rows on an H100's 132 SMs), one once they fill
    (the flagship, a sharded-1m shard)."""
    assert sb._row_group(n, sms) == group


def test_kernel_entry_points_declare_every_argument():
    """ctypes cuts a pointer to 32 bits where an argtype is missing, so each
    entry point's argtypes must count what its C signature takes: pointers
    for the buffers and the stream, ints for the rest — both SPH kernels
    with the `group` argument before `device`."""
    import ctypes
    import re
    for name in _build._ENTRY_POINTS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        entries = _build._entries(name)
        assert len(re.findall(r'extern "C" int ', src)) == len(entries), name
        for entry, argtypes in entries:
            sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)",
                            src)
            params = [p.strip() for p in sig.group(1).split(",")]
            want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                    for p in params]
            assert argtypes == want, entry
            assert params[-2:] == ["int device", "void* stream"], entry
            if name in ("sph_density", "sph_force"):
                assert params[-3] == "int group", entry
