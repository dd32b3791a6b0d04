"""The port's domain-decomposed step (``parallel/domain.py``) and its runner
against the JAX package's, on the 8-shard CPU mesh (the JAX side on the
8-virtual-device mesh of tests/conftest.py, its Pallas kernels in interpret
mode), at tests/test_domain.py::setup's size: 96 particles, grid
(24, 16, 16).

Bars: the build and the sharding bit-identical; ``active`` identical slot
for slot; positions by particle id within atol 1e-4 (the port's plain
kernels sum pairs in another order than the interpret-mode Pallas kernels);
migration losses and beyond-budget overflow exactly 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import Container as JContainer
from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.core.state import init_state as jinit_state
from water_sandbox_tpu.ops import step as wj_step
from water_sandbox_tpu.ops.pallas import sph_bucket as jsb
from water_sandbox_tpu.parallel import domain as jdomain
from water_sandbox_tpu.parallel import mesh as jmesh
from water_sandbox_tpu.runtime import checkpoint as jcheckpoint
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
from water_sandbox_tpu_torch.runtime import checkpoint as tcheckpoint
from water_sandbox_tpu_torch.runtime.distributed import DistributedSimulation

ATOL = 1e-4


def _setup(rightward=False, shift=0.0, **cfg_kw):
    """tests/test_domain.py::setup for both packages, optionally with the
    rightward 3 m/s flow of its migration test and the lattice shifted by
    ``shift`` on every axis."""
    pts = wt.cube_fluid(6, 4, 4) + np.float32(shift)
    vel = np.zeros_like(pts)
    if rightward:
        vel[:, 0] = 3.0
    jparams = JSimParams.create(
        dim=3, container=JContainer.create((0.0, 0.0, 0.0), (4.0, 3.0, 3.0)))
    jcfg = JSimConfig(**{"n": pts.shape[0], "dim": 3,
                         "neighbor_mode": "bucket_grid",
                         "grid_dims": (24, 16, 16), "cell_capacity": 16,
                         **cfg_kw})
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)],
        device="cpu")
    cfg = wt.SimConfig(**{**dataclasses.asdict(jcfg),
                          "neighbor_mode": "pallas"})
    return (jparams, jinit_state(jnp.asarray(pts), jnp.asarray(vel)), jcfg,
            params, wt.init_state(pts, vel, device="cpu"), cfg)


def _cat(states, field):
    return torch.cat([getattr(s, field) for s in states]).numpy()


def _pos_by_id(pos, ids, active):
    act = np.asarray(active) > 0
    ids = np.asarray(ids)[act]
    out = np.full((ids.size, 3), np.nan, np.float32)
    out[ids] = np.asarray(pos)[act]
    return out


def test_shard_state_bit_identical():
    jparams, jstate, jcfg, params, state, cfg = _setup(rightward=True)
    jsh, jact = jdomain.shard_state(jstate, jmesh.make_mesh(8), jcfg,
                                    jparams, slack=8.0)
    states, active = domain.shard_state(state, mesh_mod.make_mesh(8, "cpu"),
                                        cfg, params, slack=8.0)
    np.testing.assert_array_equal(torch.cat(active).numpy(),
                                  np.asarray(jact))
    for f in dataclasses.fields(jsh):
        want = np.asarray(getattr(jsh, f.name))
        if want.ndim == 0:
            for s in states:
                assert getattr(s, f.name).numpy() == want, f.name
            continue
        got = _cat(states, f.name)
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("my_dev", [0, 3, 7])
def test_build_local_slab_buckets_bit_identical(my_dev):
    """Particles inside and outside the shard's slab (stragglers clamp),
    inactive slots, and cell capacity 4 so overflow sentinels appear."""
    jparams, _, jcfg, params, _, _ = _setup()
    rng = np.random.default_rng(my_dev)
    n, gx_loc = 1500, 3
    pred = ((rng.random((n, 3)) - 0.5) * [4.4, 3.2, 3.2]).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    active = (rng.random(n) < 0.8).astype(np.float32)
    pred[active == 0] = 1.0e15
    jcfg_loc = dataclasses.replace(jcfg, grid_dims=(gx_loc, 16, 16),
                                   cell_capacity=4, neighbor_mode="pallas")
    cfg_loc = wt.SimConfig(**dataclasses.asdict(jcfg_loc))
    want = jsb.build_local_slab_buckets(
        jnp.asarray(pred), jnp.asarray(vel), jnp.asarray(active),
        jdomain._grid_origin_static(jparams, jcfg), gx_loc, my_dev, jparams,
        jcfg_loc)
    got = sb.build_local_slab_buckets(
        torch.from_numpy(pred), torch.from_numpy(vel),
        torch.from_numpy(active),
        domain._grid_origin_static(params, cfg_loc), gx_loc, my_dev, params,
        cfg_loc)
    for name, a, b in zip(("planes", "counts", "addr", "overflow"), got,
                          want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got[3]) > 0, "the case must overflow"


@pytest.mark.parametrize("case", ["kernels", "rescue"])
def test_domain_step_matches_jax_with_migration(case):
    """8 steps of rightward flow (particles cross shards every step): the
    JAX domain step against the port's on the same inputs.

    "kernels": JAX's Pallas step (interpret mode) at cell capacity 16.
    "rescue": cell capacity 1, so the cross-shard rescue runs every step
    (the lattice puts 2 particles in some cells; capacity 2 does not
    overflow at the start). Held against JAX's XLA step, which shares the
    rescue core: JAX's Pallas step feeds its rescue the density planes'
    unwritten halo slots (domain.py:452, then the pressures at :739), which
    interpret mode fills with NaN, so its rescued rows come out NaN there.
    The port masks those slots by occupancy."""
    kw = dict(cell_capacity=1, rescue_capacity=512) if case == "rescue" \
        else {}
    jparams, jstate, jcfg, params, state, cfg = _setup(rightward=True, **kw)
    jsh, jact = jdomain.shard_state(jstate, jmesh.make_mesh(8), jcfg,
                                    jparams, slack=8.0)
    jstep = jdomain.make_domain_step(jmesh.make_mesh(8), jcfg,
                                     use_pallas=case == "kernels")
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg)

    feats, counts, addr, overflow = domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * 8, cfg, 3, mesh)
    assert (sum(int(o) for o in overflow) > 0) == (case == "rescue")
    before = [int(a.sum()) for a in active]
    for _ in range(8):
        jsh, jact, jlost = jstep(jsh, jact, jparams)
        states, active, lost = step(states, active, params)
        assert float(jlost) == 0.0 and float(lost) == 0.0
        assert int(states[0].overflow) == int(jsh.overflow) == 0
        np.testing.assert_array_equal(torch.cat(active).numpy(),
                                      np.asarray(jact))
    assert [int(a.sum()) for a in active] != before, "no shard crossing"
    got = _pos_by_id(_cat(states, "pos"), _cat(states, "ids"),
                     torch.cat(active))
    want = _pos_by_id(jsh.pos, jsh.ids, jact)
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert float(states[0].overflow_total) == 0.0


def test_force_queries_on_halo_filled_planes_are_the_local_rows():
    """On a shard's halo-filled planes the force kernel's queries, the rows
    of addr, are exactly the occupied slots of the shard's own slabs; the
    halo slabs just outside hold candidates only."""
    _, _, _, params, state, cfg = _setup(rightward=True)
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    feats, counts, addr, _ = domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * 8, cfg, 3, mesh)
    cfg_loc = domain._local_cfg(cfg, 3)
    g = sb._geometry(cfg_loc)
    lo, hi = g.PAD, g.PAD + g.gx * g.S_pad
    sentinel = sb._cap_pad(cfg.cell_capacity) * g.L
    halo = 0.0
    for d in range(8):
        rows = addr[d][addr[d] < sentinel]
        lanes = rows % g.L
        assert bool(((lanes >= lo) & (lanes < hi)).all())
        assert float(counts[d][0, lo:hi].sum()) == rows.numel()
        assert rows.unique().numel() == rows.numel()
        halo += float(counts[d].sum()) - rows.numel()
    assert halo > 0, "no shard had a filled halo"


@pytest.mark.parametrize("cap", [16, 1])
def test_halo_filled_planes_keep_the_far_fill_in_empty_slots(cap):
    """The density kernel reads the empty slots of its neighbour lanes
    without asking the counts, so after the halo exchange every position
    slot at or above its lane's count must still hold _FAR: in the local
    slabs, in the halo slabs the neighbours filled and in the edge shards'
    outer pads; at cell capacity 1 with overflowing cells too."""
    _, _, _, params, state, cfg = _setup(rightward=True, cell_capacity=cap,
                                         rescue_capacity=512)
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    feats, counts, _, overflow = domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * 8, cfg, 3, mesh)
    assert (sum(int(o) for o in overflow) > 0) == (cap == 1)
    slots = torch.arange(sb._cap_pad(cap))[:, None]
    filled = 0
    for f, c in zip(feats, counts):
        empty = slots >= c
        assert bool((f[:3][:, empty] == sb._FAR).all())
        assert bool((f[:3][:, ~empty].abs() < 10.0).all())
        filled += int((~empty).sum())
    assert filled > cfg.n, "no halo slab was filled"


@pytest.mark.parametrize("case", ["flow", "rescue"])
def test_plain_domain_step_matches_jax(case):
    """``use_pallas=False`` on both sides (the JAX package's XLA per-device
    passes against the port's plain pair-block passes), 8 shards: the
    rightward flow with migration (tests/test_domain.py:45) and forced
    overflow with the cross-shard rescue (:90; at cell capacity 1, so that
    the lattice overflows from the first step on). The flow runs at cell
    capacity 4, which it never fills, to keep the pair blocks small."""
    kw = dict(cell_capacity=1, rescue_capacity=512) if case == "rescue" \
        else dict(cell_capacity=4)
    steps = 6 if case == "rescue" else 8
    jparams, jstate, jcfg, params, state, cfg = _setup(
        rightward=case == "flow", **kw)
    jsh, jact = jdomain.shard_state(jstate, jmesh.make_mesh(8), jcfg,
                                    jparams, slack=8.0)
    jstep = jdomain.make_domain_step(jmesh.make_mesh(8), jcfg,
                                     use_pallas=False)
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg, use_pallas=False)
    raw = sum(int(domain._local_buckets(
        states[d].predicted, states[d].vel, active[d],
        domain._grid_origin_static(params, cfg), params, cfg, 3, d)[4])
        for d in range(8))
    assert (raw > 0) == (case == "rescue")
    before = [int(a.sum()) for a in active]
    for _ in range(steps):
        jsh, jact, jlost = jstep(jsh, jact, jparams)
        states, active, lost = step(states, active, params)
        assert float(jlost) == 0.0 and float(lost) == 0.0
        assert int(states[0].overflow) == int(jsh.overflow) == 0
        np.testing.assert_array_equal(torch.cat(active).numpy(),
                                      np.asarray(jact))
    if case == "flow":
        assert [int(a.sum()) for a in active] != before, "no shard crossing"
    got = _pos_by_id(_cat(states, "pos"), _cat(states, "ids"),
                     torch.cat(active))
    want = _pos_by_id(jsh.pos, jsh.ids, jact)
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("my_dev", [0, 3, 7])
def test_local_buckets_bit_identical(my_dev):
    """The dense-layout shard build against JAX's: stragglers clamp,
    inactive slots drop, cell capacity 4 so overflow sentinels appear."""
    jparams, _, jcfg, params, _, cfg = _setup(cell_capacity=4)
    rng = np.random.default_rng(my_dev)
    n, gx_loc = 1500, 3
    pred = ((rng.random((n, 3)) - 0.5) * [4.4, 3.2, 3.2]).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    active = (rng.random(n) < 0.8).astype(np.float32)
    pred[active == 0] = 1.0e15
    want = jdomain._local_buckets(
        jnp.asarray(pred), jnp.asarray(vel), jnp.asarray(active),
        jdomain._grid_origin_static(jparams, jcfg), jparams, jcfg, gx_loc,
        my_dev)
    got = domain._local_buckets(
        torch.from_numpy(pred), torch.from_numpy(vel),
        torch.from_numpy(active), domain._grid_origin_static(params, cfg),
        params, cfg, gx_loc, my_dev)
    for name, a, b in zip(("cell_pos", "cell_vel", "cell_mask", "addr",
                           "overflow"), got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[5] == want[5] == 256 and int(got[4]) > 0


def _port_single(state, params, cfg, steps):
    s = state
    for _ in range(steps):
        s = wt.step(s, params, cfg)
    return s


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("case,n_shards", [
    ("flow", 8), ("rest", 8), ("rescue", 8), ("rescue", 2)])
def test_domain_matches_single_device(case, n_shards, use_pallas):
    """The port's domain step against its single-device step, by id: the
    rightward flow (migration every step), the cube at rest, and forced
    overflow at cell capacity 1 (tests/test_domain.py:45,71,90), through the
    kernels' plain versions (``use_pallas=None``) and through the plain
    pair-block passes (``False``). On 2
    shards the fluid sits on edge shards, whose outer halo lanes must keep
    their own empty-slot fill: zeros there would put phantom particles at
    the world origin, inside the fluid, for the rescue's halo sweep (the
    shift puts dropped particles within h of the origin)."""
    kw = dict(cell_capacity=1, rescue_capacity=512) if case == "rescue" \
        else {}
    _, _, _, params, state, cfg = _setup(
        rightward=case == "flow", shift=0.05 if n_shards == 2 else 0.0, **kw)
    mesh = mesh_mod.make_mesh(n_shards, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg, use_pallas=use_pallas)
    before = [int(a.sum()) for a in active]
    for _ in range(8):
        states, active, lost = step(states, active, params)
        assert float(lost) == 0.0
    after = [int(a.sum()) for a in active]
    assert sum(after) == cfg.n
    if case == "flow":
        assert after != before, "no shard crossing"
    assert float(states[0].overflow_total) == 0.0
    single = _port_single(state, params, cfg, 8)
    got = _pos_by_id(_cat(states, "pos"), _cat(states, "ids"),
                     torch.cat(active))
    np.testing.assert_allclose(got, single.pos.numpy(), rtol=0, atol=ATOL)


def test_edge_shards_outer_halo_holds_the_empty_fill_unlike_jax():
    """A difference from the JAX package, kept: its plain per-device passes
    (``_sph_local``) give the edge devices zero-filled outer halo slabs, so
    the rescue's halo sweep finds C·S phantom particles at the world origin
    there. On 2 shards both are edge shards; with the lattice shifted so
    that dropped particles lie within h of the origin, the JAX domain step
    leaves its own single-device step by far more than the bar, while the
    port's (_FAR in those slots) stays within it
    (test_domain_matches_single_device[False-rescue-2])."""
    jparams, jstate, jcfg, params, state, cfg = _setup(
        shift=0.05, cell_capacity=1, rescue_capacity=512)
    jmesh2 = jmesh.make_mesh(2)
    jsh, jact = jdomain.shard_state(jstate, jmesh2, jcfg, jparams, slack=8.0)
    jstep = jdomain.make_domain_step(jmesh2, jcfg, use_pallas=False)
    jsingle = jstate
    for _ in range(2):
        jsh, jact, _ = jstep(jsh, jact, jparams)
        jsingle = wj_step.step(jsingle, jparams, jcfg)
    jerr = np.abs(_pos_by_id(jsh.pos, jsh.ids, jact)
                  - np.asarray(jsingle.pos)).max()
    assert jerr > 100 * ATOL

    mesh = mesh_mod.make_mesh(2, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    ext = domain._exchange_halo_slabs(domain._pad_slabs(
        [torch.ones((4, 1, 3 * 5)) for _ in range(2)], 5,
        [sb._FAR] * 3 + [0.0]), 3, 5, 5, mesh)
    assert ext[0][:3, :, :5].eq(sb._FAR).all() and ext[0][3, :, :5].eq(0).all()
    assert ext[1][:3, :, -5:].eq(sb._FAR).all() and ext[0][:, :, -5:].eq(1).all()
    step = domain.make_domain_step(mesh, cfg, use_pallas=False)
    for _ in range(2):
        states, active, _ = step(states, active, params)
    single = _port_single(state, params, cfg, 2)
    got = _pos_by_id(_cat(states, "pos"), _cat(states, "ids"),
                     torch.cat(active))
    np.testing.assert_allclose(got, single.pos.numpy(), rtol=0, atol=ATOL)


def test_straggler_error_confined_to_boundaries():
    """tests/test_domain.py:122 on the port: with migration off
    (mig_cap=0) stragglers clamp into the boundary slab and may miss
    neighbours deeper than the halo; every mismatch against the
    single-device step must sit near a slab boundary, and there must be
    some."""
    _, _, _, params, state, cfg = _setup(rightward=True)
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    step = domain.make_domain_step(mesh, cfg, mig_cap=0)
    for _ in range(5):
        states, active, _ = step(states, active, params)
    single = _port_single(state, params, cfg, 5)
    act = torch.cat(active).numpy() > 0
    ids = _cat(states, "ids")[act]
    pos = _cat(states, "pos")[act]
    den = _cat(states, "density")[act]
    pos_1 = single.pos.numpy()[ids]
    den_1 = single.density.numpy()[ids]
    h = float(params.smoothing_radius)
    origin = domain._grid_origin_static(params, cfg).numpy()
    bounds = origin[0] + h * 3 * np.arange(1, 8)
    bad = ((np.abs(pos - pos_1).sum(axis=1) > 1e-3)
           | (np.abs(den - den_1) / den_1 > 1e-3))
    assert bad.any()
    near = np.abs(bounds[None, :] - pos[bad, :1]).min(axis=1)
    assert (near < 2 * h + 3.0 / 60).all()


def test_refusals_and_mesh_collectives():
    _, _, _, _, _, cfg = _setup()
    mesh = mesh_mod.make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="WORLD"):
        domain.make_domain_step(
            mesh, dataclasses.replace(cfg, grid_frame="container"))
    with pytest.raises(ValueError, match="divisible"):
        domain.make_domain_step(mesh_mod.make_mesh(5, "cpu"), cfg)
    assert callable(domain.make_domain_step(mesh, cfg, use_pallas=False))
    xs = [torch.tensor(float(d)) for d in range(8)]
    assert [float(x) for x in mesh.shift_right(xs)] == [7, 0, 1, 2, 3, 4, 5,
                                                         6]
    assert [float(x) for x in mesh.shift_left(xs)] == [1, 2, 3, 4, 5, 6, 7,
                                                       0]
    assert [float(x) for x in mesh.psum(xs)] == [28.0] * 8
    assert [float(x) for x in mesh.pmax(xs)] == [7.0] * 8
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(2, ["cpu"])


def _sim():
    _, _, _, params, state, cfg = _setup()
    return DistributedSimulation(cfg, params, state, n_shards=8, slack=8.0,
                                 device="cpu")


def test_distributed_sim_runs_tunes_and_checkpoints_into_jax(tmp_path):
    """tests/test_distributed_runner.py:13 on the port, ending in a port
    checkpoint that the JAX package loads."""
    sim = _sim()
    sim.run(6)
    st = sim.stats()
    assert st["step"] == 6 and st["active_particles"] == sim.cfg.n
    assert st["lost_particles"] == 0.0 and st["overflow_total"] == 0.0
    assert sum(st["per_shard_counts"]) == sim.cfg.n
    pos, vel = sim.particles()
    assert np.isfinite(pos).all() and np.isfinite(vel).all()

    sim.tune(viscosity_strength=0.5)
    assert float(sim.params.viscosity_strength) == 0.5
    sim.run(2)
    assert sim.stats()["step"] == 8

    dense = sim.to_dense_state()
    assert dense.pos.shape == (sim.cfg.n, 3)
    assert sorted(dense.ids.tolist()) == list(range(sim.cfg.n))
    path = str(tmp_path / "ck.npz")
    tcheckpoint.save(path, dense, sim.params, sim.cfg)
    jstate, jparams, jcfg = jcheckpoint.load(path)
    assert jstate.pos.shape == (sim.cfg.n, 3)
    assert int(jstate.step_count) == 8 and jcfg.grid_dims == (24, 16, 16)
    assert float(jparams.viscosity_strength) == 0.5
    np.testing.assert_array_equal(np.asarray(jstate.pos), dense.pos.numpy())


def test_distributed_run_zero_steps_and_lost_accumulation():
    sim = _sim()
    sim.run(0)
    assert sim.stats()["step"] == 0
    # unblocked runs still feed the device-side loss sum that stats reads
    sim.run(2, block=False)
    sim.run(2, block=False)
    st = sim.stats()
    assert st["step"] == 4 and st["lost_particles"] == 0.0
    assert st["active_particles"] == sim.cfg.n


def test_mesh_and_distributed_sim_need_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, params, state, cfg = _setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedSimulation(cfg, params, state, n_shards=8, slack=8.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedSimulation.from_scene("mini-3d", n_shards=2)
    assert mesh_mod.make_mesh(2, "cpu").devices == [torch.device("cpu")] * 2
