"""The port's incremental plane-resident step
(``water_sandbox_tpu_torch/ops/cuda/incremental.py``) against the JAX
package's ``ops/pallas/incremental.py``.

(a) Bit for bit on ``mini-3d``: ``build_cache``, ``_column_state`` (fresh
planes, seeded plane-0 holes, planes carried by the step), ``_ctz32`` and
``_first_second_free``, ``_new_columns``, and one read + clear + insert
re-insertion against a ``jnp`` transcription of JAX's
``incremental.py:219-288`` built on its own ``_new_columns``,
``_column_state``, ``_first_second_free`` and ``mover_budget``.
(b) ``rollout_inc`` against JAX's under ``jax.jit`` (Pallas in interpret
mode) at ``test_torch_step._common``'s size: 96 particles, grid 8³, cell
capacity 8, k = 4, 6 steps; pos and vel at the port's step bar, rtol = atol
= 2e-4.
(c) The port's incremental path against its own rebuild path on
``mini-3d`` at JAX's bars (``tests/test_incremental.py:98``).
(d) The invariants, static-fluid, drift-guard and forced-overflow cases of
``tests/test_incremental.py`` on the port alone; the forced overflow
against the port's dense oracle at 2e-4.

JAX's interpret-mode ``step_inc`` is never jitted at ``mini-3d`` width here:
that is what makes ``tests/test_incremental.py`` slow."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_step import _common

import water_sandbox_tpu as wj
from water_sandbox_tpu.ops.pallas import incremental as jinc
from water_sandbox_tpu.ops.pallas import sph_bucket as jsb
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.ops.cuda import incremental as inc
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

_I32_MAX = np.iinfo(np.int32).max


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jnp(x):
    return jnp.asarray(x.numpy())


def _mini(**kw):
    """mini-3d in both packages (512 particles, grid (68, 40, 40)), the
    kernel pipeline."""
    kw = dict(neighbor_mode="pallas", **kw)
    jcfg, jparams, _ = wj.scenes.build("mini-3d", **kw)
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu", **kw)
    return jcfg, jparams, cfg, params, state


def _carried(cfg, params, state, steps=3):
    """(state, cache) after ``steps`` port incremental steps from ``state``
    (materialized every step, so the shadows are current): the fresh
    lattice's first steps move many particles, so the planes carry holes."""
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    for _ in range(steps):
        state, cache = inc.step_inc(state, cache, params, cfg, True)
    return state, cache


def _hole_debt(cache, cfg):
    top, occ = inc._top_row(cache.planes, sb._cap_pad(cfg.cell_capacity))
    return float(top.sum()) - int(occ)


# ------------------------------------------------------------ (a) pieces --

@pytest.mark.parametrize("moved", [False, True])
def test_build_cache_matches_jax(moved):
    jcfg, jparams, cfg, params, state = _mini()
    if moved:
        state = wt.rollout(state, params, cfg, 3)
    want = jinc.build_cache(_jnp(state.predicted), _jnp(state.vel), jparams,
                            jcfg)
    got = inc.build_cache(state.predicted, state.vel, params, cfg)
    for name in ("planes", "addr", "origin", "ticks"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)), err_msg=name)
    assert got.addr.dtype == torch.int32


@pytest.mark.parametrize("holes", ["fresh", "seeded", "carried"])
def test_column_state_matches_jax(holes):
    jcfg, jparams, cfg, params, state = _mini(incremental_rebuild=64)
    cap_p = sb._cap_pad(cfg.cell_capacity)
    if holes == "carried":
        _, cache = _carried(cfg, params, state)
        planes = cache.planes
    else:
        planes = inc.build_cache(state.predicted, state.vel, params,
                                 cfg).planes.clone()
    if holes == "seeded":
        # plane-0 _FAR clears at seeded occupied slots, as the step's clears
        occ = torch.nonzero((planes[0] < 0.5 * sb._FAR).reshape(-1))[:, 0]
        pick = np.random.default_rng(7).choice(occ.numel(), 150, replace=False)
        planes[0].view(-1)[occ[torch.from_numpy(pick)]] = sb._FAR
    if holes != "fresh":
        top, occ_total = inc._top_row(planes, cap_p)
        assert float(top.sum()) > int(occ_total), "no holes in the planes"
    want = jinc._column_state(_jnp(planes), cap_p)
    got = inc._column_state(planes, cap_p)
    for name, g, w in zip(("top", "lo", "hi", "occ_total"), got, want):
        np.testing.assert_array_equal(_np(g), _np(w).astype(_np(g).dtype),
                                      err_msg=name)
    top, occ_total = inc._top_row(planes, cap_p)
    np.testing.assert_array_equal(top.numpy(), _np(want[0]))
    assert int(occ_total) == int(want[3])
    with pytest.raises(ValueError, match="64"):
        inc._column_state(torch.zeros((2, 72, 8)), 72)


def _u32_cases():
    rng = np.random.default_rng(3)
    return np.concatenate([
        np.array([0, 0xFFFFFFFF], np.uint64),
        np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64)),
        rng.integers(0, 1 << 32, 10_000, dtype=np.uint64)]).astype(np.uint32)


def test_ctz32_and_first_second_free_match_jax():
    x = _u32_cases()
    tx = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(inc._ctz32(tx).numpy(),
                                  np.asarray(jinc._ctz32(jnp.asarray(x))))
    # every pair of masks: as (lo, hi) and, swapped, as (hi, lo)
    y = np.random.default_rng(4).permutation(x)
    ty = torch.from_numpy(y.astype(np.int64))
    for lo, hi, tlo, thi in ((x, y, tx, ty), (y, x, ty, tx)):
        want = jinc._first_second_free(jnp.asarray(lo), jnp.asarray(hi))
        got = inc._first_second_free(tlo, thi)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_new_columns_match_jax():
    jcfg, jparams, cfg, params, state = _mini()
    origin = inc.build_cache(state.predicted, state.vel, params, cfg).origin
    moved = wt.rollout(state, params, cfg, 3).predicted
    S_pad = sb._geometry(cfg).S_pad
    np.testing.assert_array_equal(
        inc._new_columns(moved, origin, params, cfg, S_pad).numpy(),
        np.asarray(jinc._new_columns(_jnp(moved), _jnp(origin), jparams,
                                     jcfg, S_pad)))


def _jax_reinsert(jstate, jcache, jparams, jcfg):
    """JAX's incremental.py:219-288 (state read, mover detection and
    compaction, hole-filling slot pick, clear + insert scatter) transcribed
    in jnp around the module's own _new_columns, _column_state,
    _first_second_free and mover_budget."""
    dim = jcfg.dim
    g = jsb._geometry(jcfg)
    S_pad, PAD, L = g.S_pad, g.PAD, g.L
    cap_p = jsb._cap_pad(jcfg.cell_capacity)
    PL = cap_p * L
    n = jstate.pos.shape[0]
    look = jparams.lookahead
    planes, addr, origin, _ = jcache

    was_dropped = addr == PL
    safe = jnp.minimum(addr, PL - 1)
    rows = planes.reshape(2 * dim, -1)[:, safe]
    dcol = was_dropped[:, None]
    pred_c = jnp.where(dcol, jstate.predicted, rows[:dim].T)
    vel_c = jnp.where(dcol, jstate.vel, rows[dim:].T)
    pos_c = jnp.where(dcol, jstate.pos, pred_c - vel_c * look)

    newcol = jinc._new_columns(pred_c, origin, jparams, jcfg, S_pad)
    moved = newcol != addr % L - PAD
    nm = jnp.sum(moved).astype(jnp.int32)
    M = jinc.mover_budget(jcfg)
    iota = jnp.arange(n, dtype=jnp.int32)
    skey, sidx = jax.lax.sort(
        (jnp.where(moved, newcol, _I32_MAX), iota), num_keys=1)
    mk, mid = skey[:M], sidx[:M]
    valid = mk < _I32_MAX
    miota = jnp.arange(M, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), mk[1:] != mk[:-1]])
    rank = miota - jax.lax.cummax(jnp.where(first, miota, 0))

    top0, occ_lo, occ_hi, _ = jinc._column_state(planes, cap_p)
    col_safe = jnp.where(valid, mk, 0)
    top_at = top0[0, PAD + col_safe].astype(jnp.int32)
    first_free, second_free = jinc._first_second_free(
        occ_lo[PAD + col_safe], occ_hi[PAD + col_safe])
    slot = jnp.where(
        rank == 0, first_free,
        jnp.where(rank == 1, second_free,
                  jnp.maximum(top_at, second_free + 1) + (rank - 2)))
    ok = valid & (slot < jcfg.cell_capacity)
    newaddr = jnp.where(ok, slot * L + PAD + (mk * ok), PL)

    OOB = 2 * dim * PL
    oldaddr_m = addr[mid]
    clear_idx = jnp.where(valid & (oldaddr_m < PL), oldaddr_m, OOB)
    rows_m = jnp.concatenate([pred_c, vel_c], axis=1)[mid]
    ins_idx = [jnp.where(ok, a * PL + newaddr, OOB) for a in range(2 * dim)]
    all_idx = jnp.concatenate([clear_idx] + ins_idx)
    all_val = jnp.concatenate(
        [jnp.full((M,), jsb._FAR, jnp.float32)]
        + [rows_m[:, a] for a in range(2 * dim)])
    flat = planes.reshape(-1).at[all_idx].set(
        all_val, mode="drop", unique_indices=True)
    addr_r = addr.at[jnp.where(valid, mid, n)].set(
        jnp.where(ok, newaddr, PL), mode="drop", unique_indices=True)
    return (pred_c, vel_c, pos_c, flat.reshape(planes.shape), addr_r, nm,
            ok)


@pytest.mark.parametrize("cap, budget", [(16, 0), (4, 64)])
def test_reinsertion_matches_jax(cap, budget):
    """From planes carried (with holes) by three port steps; at capacity 4
    particles are dropped at the build and at re-insertion, and a mover
    budget of 64 leaves movers for the next step."""
    jcfg, jparams, cfg, params, state = _mini(
        incremental_rebuild=64, cell_capacity=cap, rescue_capacity=512)
    state, cache = _carried(cfg, params, state)
    assert _hole_debt(cache, cfg) > 0
    jcfg = dataclasses.replace(jcfg, mover_capacity=budget)
    cfg = dataclasses.replace(cfg, mover_capacity=budget)
    jstate = wj.init_state(_jnp(state.pos), _jnp(state.vel))
    jstate = dataclasses.replace(jstate, predicted=_jnp(state.predicted))
    jcache = jinc.BucketCache(*[_jnp(x) for x in cache])
    want = _jax_reinsert(jstate, jcache, jparams, jcfg)

    pred_c, vel_c, pos_c = inc.read_state(state, cache, params, cfg)
    planes_r, addr_r, nm, _, _ = inc.reinsert(pred_c, vel_c, cache, params,
                                              cfg)
    for name, g, w in zip(("pred_c", "vel_c", "pos_c", "planes_r", "addr_r",
                           "movers"),
                          (pred_c, vel_c, pos_c, planes_r, addr_r, nm), want):
        np.testing.assert_array_equal(_np(g), _np(w).astype(_np(g).dtype),
                                      err_msg=name)
    assert int(nm) > 0
    if budget:
        PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
        assert int((cache.addr == PL).sum()) > 0, "no particle dropped"
        assert int(nm) > inc.mover_budget(cfg), "the budget cut nothing"
        assert not bool(np.asarray(want[6]).all()), "every insert fitted"


# ------------------------------------------------------- (b) against JAX --

def test_rollout_inc_matches_jax():
    jparams, jstate, jcfg, params, state, cfg = _common(
        neighbor_mode="pallas", incremental_rebuild=4, rescue_capacity=64)
    want = jax.jit(jinc.rollout_inc, static_argnums=(2, 3))(
        jstate, jparams, jcfg, 6)
    got = inc.rollout_inc(state, params, cfg, 6)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=2e-4, atol=2e-4, err_msg=f)
    assert int(got.step_count) == int(want.step_count) == 6
    assert float(got.overflow_total) == float(want.overflow_total)
    np.testing.assert_array_equal(got.ids.numpy(), np.arange(state.n))


# --------------------------------------- (c) against the rebuild path ----

@pytest.mark.parametrize("k, steps, tol", [(1, 4, 1e-5), (4, 6, 5e-3)])
def test_incremental_matches_rebuild_path(k, steps, tol):
    """k = 1 rebuilds every step (the rebuild path's planes); k > 1 differs
    from it by slot-order reassociation."""
    _, _, cfg, params, state = _mini()
    ref = wt.rollout(state, params, cfg, steps)
    out = wt.rollout(state, params,
                     dataclasses.replace(cfg, incremental_rebuild=k), steps)
    np.testing.assert_allclose(out.pos.numpy(), ref.pos.numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(out.vel.numpy(), ref.vel.numpy(),
                               rtol=10 * tol, atol=10 * tol)
    assert int(out.step_count) == int(ref.step_count)


def test_rollout_and_run_reach_the_incremental_path(monkeypatch):
    """rollout (through rollout_inc) and Simulation.run run the incremental
    steps of an IncrementalGraph (ops/cuda/graph.py) in the kernel pipeline
    ("auto" or "pallas") with incremental_rebuild > 0; step, trajectory and
    the plain modes keep the rebuild step, as in the JAX package."""
    from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
    calls = []
    real = graph_mod.IncrementalGraph.run

    def counted(self, num_steps):
        calls.append(num_steps)
        return real(self, num_steps)

    monkeypatch.setattr(graph_mod.IncrementalGraph, "run", counted)
    for mode in ("auto", "pallas"):
        sim = wt.Simulation.from_scene("mini-3d", device="cpu",
                                       neighbor_mode=mode,
                                       incremental_rebuild=4)
        assert isinstance(sim.graph, graph_mod.IncrementalGraph)
        sim.run(2)
        assert int(sim.state.step_count) == 2
    assert calls == [2, 2]
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         incremental_rebuild=4)
    assert int(wt.rollout(state, params, cfg, 3).step_count) == 3
    assert calls == [2, 2, 3]
    wt.step(state, params, cfg)
    wt.trajectory(state, params, cfg, 2, 1)
    wt.rollout(state, params, dataclasses.replace(cfg, neighbor_mode="dense"),
               1)
    assert calls == [2, 2, 3]


# ------------------------------------------------------ (d) the port alone --

def _check_cache_consistency(state, cache, cfg, lookahead=None):
    """tests/test_incremental.py's check: the planes and addresses mirror
    the particle-order state exactly."""
    PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    addr = cache.addr.numpy()
    live = addr != PL
    assert len(np.unique(addr[live])) == live.sum()
    planes = cache.planes.reshape(cache.planes.shape[0], -1).numpy()
    dim = cfg.dim
    for a in range(dim):
        np.testing.assert_array_equal(planes[a, addr[live]],
                                      state.predicted.numpy()[live, a])
        np.testing.assert_array_equal(planes[dim + a, addr[live]],
                                      state.vel.numpy()[live, a])
    if lookahead is not None:
        np.testing.assert_allclose(
            state.pos.numpy()[live],
            (state.predicted - state.vel * lookahead).numpy()[live],
            atol=1e-5)
    assert (planes[0] < 0.5 * sb._FAR).sum() == live.sum()


def test_incremental_invariants_and_conservation():
    _, _, cfg, params, state = _mini(incremental_rebuild=8)
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    _check_cache_consistency(state, cache, cfg)
    for _ in range(4):
        state, cache = inc.step_inc(state, cache, params, cfg, True)
        _check_cache_consistency(state, cache, cfg,
                                 lookahead=float(params.lookahead))
        top, _ = inc._top_row(cache.planes, sb._cap_pad(cfg.cell_capacity))
        counts = (cache.planes[0] < 0.5 * sb._FAR).sum(0)
        assert bool((top[0] >= counts).all())
    assert bool(torch.isfinite(state.pos).all())


def test_incremental_static_fluid_never_rebuilds():
    """With all forces off nothing moves: no movers, no debt, no drift, so
    the cache ticks through every step without a rebuild."""
    _, _, cfg, params, state = _mini(incremental_rebuild=16)
    params = params.replace(gravity=params.gravity * 0.0, pressure_scalar=0.0,
                            near_pressure_scalar=0.0, viscosity_strength=0.0)
    state = dataclasses.replace(state, vel=state.vel * 0.0)
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    pos0 = state.pos.numpy().copy()
    for _ in range(3):
        state, cache = inc.step_inc(state, cache, params, cfg, True)
    assert int(cache.ticks) == 3
    np.testing.assert_allclose(state.pos.numpy(), pos0, atol=1e-6)
    _check_cache_consistency(state, cache, cfg)


def test_incremental_rescue_matches_dense_oracle():
    """Forced cell-capacity overflow: dropped movers re-enter the physics
    exactly through the rescue, against the dense oracle over three
    incremental steps."""
    pts = wt.cube_fluid(12, 9, 6, particle_radius=0.04)
    params = wt.SimParams.create(dim=3, device="cpu")
    state = wt.init_state(pts, device="cpu")
    n = pts.shape[0]
    cfg_d = wt.SimConfig(n=n, dim=3, neighbor_mode="dense")
    state = wt.rollout(state, params, cfg_d, 3)
    cfg = wt.SimConfig(n=n, dim=3, neighbor_mode="pallas",
                       grid_dims=(12, 12, 12), cell_capacity=8,
                       rescue_capacity=512, incremental_rebuild=8)
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    PL = sb._cap_pad(8) * sb._geometry(cfg).L
    assert int((cache.addr == PL).sum()) > 0, "the scene must overflow"
    s_inc, s_dense = state, state
    for _ in range(3):
        s_inc, cache = inc.step_inc(s_inc, cache, params, cfg, True)
        s_dense = wt.step(s_dense, params, cfg_d)
        np.testing.assert_allclose(s_inc.pos.numpy(), s_dense.pos.numpy(),
                                   rtol=2e-4, atol=2e-4)
    assert float(s_inc.overflow_total) > 0


def test_drift_guard_triggers_rebuild():
    """A blob in free fall strays from the frozen anchor by more than 3/4 of
    a cell within a few steps: the cache must re-anchor."""
    _, _, cfg, params, state = _mini(incremental_rebuild=64)
    params = params.replace(gravity=params.gravity * 0.0 - 50.0)
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    steps = 12
    for _ in range(steps):
        state, cache = inc.step_inc(state, cache, params, cfg, True)
    assert int(cache.ticks) < steps
    _check_cache_consistency(state, cache, cfg)
    assert bool(torch.isfinite(state.pos).all())


def test_mover_budget_matches_jax():
    for n, cap in ((512, 0), (65_536, 0), (266_112, 0), (5_000, 0),
                   (65_536, 300), (100, 300)):
        jcfg = wj.SimConfig(n=n, neighbor_mode="dense", mover_capacity=cap)
        cfg = wt.SimConfig(n=n, neighbor_mode="dense", mover_capacity=cap)
        assert inc.mover_budget(cfg) == jinc.mover_budget(jcfg)
    assert inc.mover_budget(wt.SimConfig(n=65_536,
                                         neighbor_mode="dense")) == 16_384
