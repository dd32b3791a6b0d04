"""The port's cell-slab-sharded ``bucket_grid`` step
(``water_sandbox_tpu_torch/parallel/gspmd.py``) against the JAX package's
``parallel/gspmd.py`` on the 8-virtual-device CPU mesh (tests/conftest.py),
and against the port's single-device step, on tests/test_parallel.py's
``small_setup`` (288 particles, grid (16, 12, 12), 8 shards). Bars:
tests/test_parallel.py's (pos rtol 1e-4 / atol 1e-5, vel rtol 1e-3 /
atol 1e-4); each slab's planes bit for bit against the single-device
build."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.core.state import init_state as jinit_state
from water_sandbox_tpu.models import scenes as jscenes
from water_sandbox_tpu.parallel import gspmd as jgspmd
from water_sandbox_tpu.parallel import mesh as jmesh_mod
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops import grid
from water_sandbox_tpu_torch.parallel import gspmd, mesh as mesh_mod

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

SHARDS = 8
STEPS = 5
# tests/test_parallel.py's small_setup, and the forced overflow: cell
# capacity 2 drops rows on every step, the rescue takes up to 64
CASES = {"small_setup": dict(cell_capacity=16),
         "forced overflow": dict(cell_capacity=2, rescue_capacity=64)}


def _setup(**kw):
    pts = np.array(jscenes.cube_fluid(8, 6, 6))           # 288 particles
    jparams = JSimParams.create(dim=3)
    jcfg = JSimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                      grid_dims=(16, 12, 12), **{"cell_capacity": 16, **kw})
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    cfg = wt.SimConfig(**dataclasses.asdict(jcfg))
    return pts, jparams, jcfg, params, cfg


def _close(got, want):
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.vel.numpy(), np.asarray(want.vel),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_sharded_rollout_matches_jax_and_the_single_device_step(case):
    """5 steps of the port's sharded rollout against JAX's
    ``make_sharded_rollout`` and against 5 single-device steps of the
    port; on the CPU the sharded step repeats the single device's bits."""
    pts, jparams, jcfg, params, cfg = _setup(**CASES[case])
    jmesh = jmesh_mod.make_mesh(SHARDS)
    want = jgspmd.make_sharded_rollout(jmesh, jcfg)(
        jgspmd.shard_state(jinit_state(jnp.asarray(pts)), jmesh), jparams,
        STEPS)
    mesh = mesh_mod.make_mesh(SHARDS, "cpu")
    state = wt.init_state(pts, device="cpu")
    shards = gspmd.shard_state(state, mesh)
    got = gspmd.unshard_state(
        gspmd.make_sharded_rollout(mesh, cfg)(shards, params, STEPS))
    assert int(shards[0].step_count) == 0, "the rollout steps copies"
    _close(got, want)
    assert float(got.overflow_total) == float(want.overflow_total)
    single = wt.rollout(state, params, cfg, STEPS)
    _close(got, single)
    for f in ("pos", "vel", "density", "acc", "overflow_total"):
        assert torch.equal(getattr(got, f), getattr(single, f)), f
    if case == "forced overflow":
        raw = grid.build_bucket_grid(state.predicted, state.vel, params,
                                     cfg).overflow
        assert 0 < int(raw) <= cfg.rescue_capacity, "the rescue must fire"


def test_each_slab_is_the_x_slab_of_the_single_device_build():
    """Every shard's planes are its x slab of ``build_bucket_grid`` over the
    unsharded rows, bit for bit, with capacity-overflow drops, and a kept
    row's local address is its global one moved to the slab."""
    _, _, _, params, cfg = _setup(cell_capacity=2)
    pts = np.asarray(jscenes.cube_fluid(8, 6, 6))
    rng = np.random.default_rng(3)
    state = wt.init_state(pts + rng.normal(0, 0.05, pts.shape).astype(
        np.float32), device="cpu")
    mesh = mesh_mod.make_mesh(SHARDS, "cpu")
    want = grid.build_bucket_grid(state.predicted, state.vel, params, cfg)
    slabs = gspmd.build_slabs(mesh, cfg, gspmd.shard_state(state, mesh),
                              [params] * SHARDS)
    nc = grid.num_cells(cfg)
    nc_loc = nc // SHARDS
    assert int(want.overflow) > 0
    assert sum(int(g.overflow) for g in slabs.grids) == int(want.overflow)
    for d, g in enumerate(slabs.grids):
        cells = slice(d * nc_loc, (d + 1) * nc_loc)
        for f in ("cell_pos", "cell_vel", "cell_mask"):
            assert torch.equal(getattr(g, f), getattr(want, f)[..., cells]), f
        assert torch.equal(g.origin, want.origin)
        kept = slabs.mine[d] & (g.addr < cfg.cell_capacity * nc_loc)
        slot, cell = g.addr[kept] // nc_loc, g.addr[kept] % nc_loc
        assert torch.equal(slot * nc + d * nc_loc + cell, want.addr[kept])


def test_bad_split_and_uneven_rows_raise_as_in_jax():
    """A grid whose x layers do not split over the mesh, and a particle
    count that does not, raise ValueError in both packages."""
    pts, jparams, jcfg, params, cfg = _setup()
    bad = dict(grid_dims=(15, 12, 12))
    jmesh = jmesh_mod.make_mesh(SHARDS)
    mesh = mesh_mod.make_mesh(SHARDS, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        jgspmd.make_sharded_rollout(jmesh, dataclasses.replace(jcfg, **bad))
    with pytest.raises(ValueError, match="not divisible"):
        gspmd.make_sharded_rollout(mesh, dataclasses.replace(cfg, **bad))
    with pytest.raises(ValueError):
        jgspmd.shard_state(jinit_state(jnp.asarray(pts[:-1])), jmesh)
    with pytest.raises(ValueError, match="not divisible"):
        gspmd.shard_state(wt.init_state(pts[:-1], device="cpu"), mesh)
    with pytest.raises(ValueError, match="bucket_grid"):
        gspmd.make_sharded_step(mesh, dataclasses.replace(
            cfg, neighbor_mode="dense"))


def test_halos_carry_boundary_cells_only():
    """The counterpart of tests/test_parallel.py::
    test_gspmd_lowers_rolls_to_collective_permute: one step's shifts carry
    exactly the cells within the largest flat neighbour shift of each
    slab's edges (two exchanges: positions and mask, then velocities and
    the four density planes), and no transfer of any collective carries
    more than one (cap, num_cells) f32 plane."""
    for case in CASES.values():
        _, _, _, params, cfg = _setup(**case)
        pts = np.array(jscenes.cube_fluid(8, 6, 6))
        mesh = mesh_mod.make_mesh(SHARDS, "cpu")
        shards = gspmd.shard_state(wt.init_state(pts, device="cpu"), mesh)
        step = gspmd.make_sharded_step(mesh, cfg)
        mesh.reset_traffic()
        step(shards, params)
        gy, gz = cfg.grid_dims[1:]
        halo = gy * gz + gz + 1
        cap, dim = cfg.cell_capacity, cfg.dim
        both_ways = 2 * SHARDS * halo * cap * 4
        assert mesh.moved["permute"] == both_ways * ((dim + 1) + (dim + 4))
        plane = cap * grid.num_cells(cfg) * 4
        assert 0 < max(mesh.largest.values()) <= plane, mesh.largest
        assert mesh.moved["all-to-all"] > 0 and mesh.moved["all-reduce"] > 0
        assert (mesh.moved["all-gather"] > 0) == (cfg.rescue_capacity > 0)


def test_one_layer_slabs_match_the_single_device_step():
    """One x layer a shard: the halo (gy·gz + gz + 1 cells) is wider than a
    slab, and its cells past the neighbour's slab hold the empty fill; the
    sharded steps still repeat the single-device bits, rescue included."""
    pts, _, _, params, cfg = _setup(**CASES["forced overflow"])
    cfg = dataclasses.replace(cfg, grid_dims=(SHARDS, 12, 12))
    state = wt.init_state(pts, device="cpu")
    mesh = mesh_mod.make_mesh(SHARDS, "cpu")
    got = gspmd.unshard_state(gspmd.make_sharded_rollout(mesh, cfg)(
        gspmd.shard_state(state, mesh), params, 2))
    single = wt.rollout(state, params, cfg, 2)
    assert int(grid.build_bucket_grid(state.predicted, state.vel, params,
                                      cfg).overflow) > 0
    for f in ("pos", "vel", "density", "acc", "overflow_total"):
        assert torch.equal(getattr(got, f), getattr(single, f)), f


def test_mesh_collectives_keep_shard_order_and_count_bytes():
    """pmin, all_to_all and all_gather over per-shard lists: shard order,
    each source's row order, and the bytes that leave their shard."""
    mesh = mesh_mod.make_mesh(3, "cpu")
    xs = [torch.tensor([3.0, -1.0]), torch.tensor([2.0, 5.0]),
          torch.tensor([4.0, 0.0])]
    for got in mesh.pmin(xs):
        assert torch.equal(got, torch.tensor([2.0, -1.0]))
    assert mesh.moved["all-reduce"] == 4 * 8          # 2 in, 2 out
    blocks = [[torch.full((s + 1, 2), 10.0 * s + d) for d in range(3)]
              for s in range(3)]
    got = mesh.all_to_all(blocks)
    for d in range(3):
        assert torch.equal(got[d], torch.cat([b[d] for b in blocks]))
    assert mesh.moved["all-to-all"] == sum(
        (s + 1) * 8 for s in range(3) for d in range(3) if s != d)
    gathered = mesh.all_gather(xs)
    assert all(torch.equal(g, torch.cat(xs)) for g in gathered)
    assert mesh.moved["all-gather"] == 3 * 2 * 8
    assert mesh.largest["all-to-all"] == 3 * 8
    mesh.reset_traffic()
    assert set(mesh.moved.values()) == {0}


@pytest.mark.parametrize("path", ["bucket_grid", "sharded"])
def test_steps_read_nothing_on_the_host(monkeypatch, path):
    """One ``bucket_grid`` step and one sharded step with the rescue
    firing, while every way a tensor reaches a Python value raises: on the
    card both are captured as CUDA graphs."""
    pts, _, _, params, cfg = _setup(**CASES["forced overflow"])
    state = wt.init_state(pts, device="cpu")
    mesh = mesh_mod.make_mesh(SHARDS, "cpu")
    shards = gspmd.shard_state(state, mesh)
    step = gspmd.make_sharded_step(mesh, cfg)

    def refuse(*a, **k):
        raise AssertionError("a host read in the step")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    if path == "bucket_grid":
        out = wt.step(state, params, cfg)
    else:
        out = gspmd.unshard_state(step(shards, params))
    monkeypatch.undo()
    assert int(out.step_count) == 1
    assert bool(torch.isfinite(out.pos).all())
