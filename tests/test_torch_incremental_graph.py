"""The incremental step's device-only execution
(``water_sandbox_tpu_torch/ops/cuda/incremental.py::step_inc`` with its
branches under ``ops/cuda/graph.py::device_if``, and ``IncrementalGraph``),
on the CPU at small sizes.

(i) ``step_inc`` with every tensor-to-host read patched to raise, except
inside ``device_if``'s eager read (``graph._eager_read``): on a rebuild step
and on a drop step. On the card the same step is captured, each branch an
IF conditional node (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
(ii) ``IncrementalGraph`` (and ``Simulation.run`` through it) against the
eager loop of ``step_inc`` that ``rollout_inc`` ran before, bit for bit,
with its device counts of rebuild and drop steps.
(iii) The sync-free ``_new_columns`` and acceleration write-back
(``_patch_acc``) against the forms they replace (a clamp on a
``torch.tensor(dims)`` and a mask index), bit for bit.
(iv) ``Simulation.run`` with dropped particles against JAX's ``rollout_inc``
at ``tests/test_torch_incremental.py::test_rollout_inc_matches_jax``'s
bars."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_step import _common

from water_sandbox_tpu.ops.pallas import incremental as jinc
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
from water_sandbox_tpu_torch.ops.cuda import incremental as inc
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

FIELDS = ("pos", "vel", "predicted", "acc", "density", "near_density",
          "pressure", "near_pressure", "step_count", "time", "overflow",
          "overflow_total", "ids")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    return torch.equal(_bits(a), _bits(b))


def _mini(**kw):
    cfg, params, state = wt.scenes.build("mini-3d", device="cpu",
                                         neighbor_mode="pallas", **kw)
    return cfg.resolved(), params, state


def _eager(state, params, cfg, steps):
    """The eager rollout: build on entry, ``steps`` steps, the last one
    materializing. Returns (state, cache, rebuild steps, drop steps)."""
    cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    rebuilds = drops = 0
    for i in range(steps):
        ticks = int(cache.ticks)
        state, cache = inc.step_inc(state, cache, params, cfg,
                                    i == steps - 1)
        rebuilds += int(cache.ticks) <= ticks
        drops += int(state.overflow) > 0
    return state, cache, rebuilds, drops


# ----------------------------------------------- (i) no host read ---------

@pytest.mark.parametrize("case", ["rebuild", "drop"])
def test_step_inc_reads_the_host_only_in_device_if(monkeypatch, case):
    """Every way a tensor reaches a Python value raises, except the eager
    read of a branch's predicate; the step reads exactly its four
    predicates (rebuild, the drop step's two halves, materialize) and
    matches the step with a Python ``materialize``."""
    if case == "rebuild":
        # the cache's ticks at k: the rebuild fires, nothing drops
        cfg, params, state = _mini(incremental_rebuild=4)
        cache = inc.build_cache(state.predicted, state.vel, params, cfg)
        cache = cache._replace(ticks=torch.tensor(4, dtype=torch.int32))
    else:
        # cell capacity 4: the build drops particles, the rescue takes them
        cfg, params, state = _mini(incremental_rebuild=64, cell_capacity=4,
                                   rescue_capacity=64)
        cache = inc.build_cache(state.predicted, state.vel, params, cfg)
    want, want_cache = inc.step_inc(state, cache, params, cfg, True)
    branches = graph_mod.Branches(torch.device("cpu"),
                                  graph_mod.IncrementalGraph.BRANCHES)
    reads = []
    allowed = []
    real_read = graph_mod._eager_read

    def refuse(real):
        def f(*a, **k):
            if not allowed:
                raise AssertionError("a host read in the step")
            return real(*a, **k)
        return f

    def read(pred):
        allowed.append(1)
        try:
            out = real_read(pred)
        finally:
            allowed.pop()
        reads.append(out)
        return out

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name,
                            refuse(getattr(torch.Tensor, name)))
    monkeypatch.setattr(graph_mod, "_eager_read", read)
    got, got_cache = inc.step_inc(state, cache, params, cfg,
                                  torch.tensor(True), branches)
    monkeypatch.undo()
    fired = {k: int(v) for k, v in branches.fired.items()}
    if case == "rebuild":
        # the drop step's density half is there only with a rescue budget
        assert reads == ([True, False] if cfg.rescue_capacity else [True]) \
            + [False, True]
        assert fired == {"rebuild": 1, "drop": 0, "drop_force": 0,
                         "materialize": 1}
        assert int(got_cache.ticks) == 1
    else:
        assert reads == [False, True, True, True]
        assert fired == {"rebuild": 0, "drop": 1, "drop_force": 1,
                         "materialize": 1}
        assert int(got.overflow) > 0
    for f in FIELDS:
        assert _same(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got_cache, want_cache):
        assert _same(a, b)


# ------------------------------- (ii) the graph against the eager loop ----

def test_incremental_graph_equals_the_eager_rollout():
    """Seven steps at k = 3, cell capacity 4 (rebuilds and drop steps),
    twice in a row: each run builds its cache on entry and materializes its
    last step, as the eager rollout does; the branch counts are the eager
    loop's. Simulation.run owns the same graph."""
    cfg, params, state = _mini(incremental_rebuild=3, cell_capacity=4,
                               rescue_capacity=64)
    g = graph_mod.IncrementalGraph(state.clone(), params, cfg)
    assert not g.captures
    want = state
    rebuilds = drops = 0
    for steps in (7, 2):
        g.run(steps)
        want, cache, r, d = _eager(want, params, cfg, steps)
        rebuilds, drops = rebuilds + r, drops + d
        for f in FIELDS:
            assert _same(getattr(g.state, f), getattr(want, f)), f
        for a, b in zip(g.cache, cache):
            assert _same(a, b)
    fired = g.fired()
    assert fired["rebuild"] == rebuilds >= 2
    assert fired["drop"] == fired["drop_force"] == drops >= 5
    assert fired["materialize"] == 2

    sim = wt.Simulation(cfg, params, state)
    assert isinstance(sim.graph, graph_mod.IncrementalGraph)
    sim.run(7)
    want = _eager(state, params, cfg, 7)[0]
    for f in FIELDS:
        assert _same(getattr(sim.state, f), getattr(want, f)), f


def test_rollout_inc_is_the_graph_on_copies():
    """rollout_inc leaves the caller's tensors as they were and returns the
    graph's state; zero steps return the state unchanged."""
    cfg, params, state = _mini(incremental_rebuild=4)
    before = state.clone()
    out = inc.rollout_inc(state, params, cfg, 3)
    for f in FIELDS:
        assert _same(getattr(state, f), getattr(before, f)), f
    want = _eager(state, params, cfg, 3)[0]
    for f in FIELDS:
        assert _same(getattr(out, f), getattr(want, f)), f
    same = inc.rollout_inc(state, params, cfg, 0)
    assert _same(same.pos, state.pos) and int(same.step_count) == 0
    with pytest.raises(ValueError, match="incremental"):
        graph_mod.IncrementalGraph(state, params,
                                   dataclasses.replace(cfg,
                                                       incremental_rebuild=0))


# --------------------------------- (iii) the sync-free forms -------------

def _old_new_columns(predicted, origin, params, cfg, S_pad):
    """The form _new_columns replaced: one clamp against a torch.tensor of
    the grid's dims (a host-to-device copy on the card)."""
    dims = cfg.grid_dims
    gz = dims[2] if cfg.dim == 3 else 1
    cell = torch.floor((predicted - origin)
                       / params.smoothing_radius).to(torch.int32)
    hi = torch.tensor(dims, dtype=torch.int32, device=predicted.device) - 1
    cell = torch.minimum(torch.clamp_min(cell, 0), hi)
    r = cell[:, 1]
    if cfg.dim == 3:
        r = r * gz + cell[:, 2]
    return cell[:, 0] * S_pad + r


@pytest.mark.parametrize("dim", [2, 3])
def test_new_columns_equal_the_tensor_clamp(dim):
    rng = np.random.default_rng(11)
    dims = (12, 9, 7)[:dim]
    params = wt.SimParams.create(dim=dim, device="cpu")
    cfg = wt.SimConfig(n=4000, dim=dim, grid_dims=dims, cell_capacity=8)
    h = float(params.smoothing_radius)
    # a third beyond the grid on either side: every clamp bound is hit
    span = np.asarray(dims, np.float32) * h
    pred = torch.from_numpy(((rng.random((4000, dim)) * 1.6 - 0.3)
                             * span).astype(np.float32))
    origin = torch.zeros(dim)
    S_pad = sb._geometry(cfg).S_pad
    got = inc._new_columns(pred, origin, params, cfg, S_pad)
    want = _old_new_columns(pred, origin, params, cfg, S_pad)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    cell = torch.floor(pred / h)
    assert bool((cell < 0).any()) and bool((cell >= torch.tensor(dims)).any())


def test_acceleration_patch_equals_the_mask_index():
    """_patch_acc writes the residents' rows where the mask index wrote
    them, and nothing else (dropped rows go to the dropped index)."""
    rng = np.random.default_rng(12)
    dim, cap_p, L, n = 3, 8, 300, 1500
    PL = cap_p * L
    out_c = torch.from_numpy(rng.standard_normal((2 + dim, cap_p, L)).astype(
        np.float32))
    addr = torch.from_numpy(rng.permutation(PL)[:n].astype(np.int32))
    dropped = torch.from_numpy(rng.random(n) < 0.2)
    addr = torch.where(dropped, PL, addr)
    acc = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    want = out_c.clone()
    keep = ~dropped
    want.view(2 + dim, -1)[2:, addr[keep].long()] = acc[keep].T
    got = out_c.clone()
    inc._patch_acc(got, addr, dropped, acc)
    assert _same(got, want) and not _same(got, out_c)


# ------------------------------------------------------ (iv) against JAX --

def test_simulation_run_with_drops_matches_jax():
    """Simulation.run at incremental_rebuild 4 and cell capacity 2 (the
    drop-step branch fires) against JAX's rollout_inc under
    jax.jit (Pallas in interpret mode), at the bars of
    test_rollout_inc_matches_jax."""
    jparams, jstate, jcfg, params, state, cfg = _common(
        neighbor_mode="pallas", incremental_rebuild=4, rescue_capacity=64)
    jcfg = dataclasses.replace(jcfg, cell_capacity=2)
    cfg = dataclasses.replace(cfg, cell_capacity=2)
    want = jax.jit(jinc.rollout_inc, static_argnums=(2, 3))(
        jstate, jparams, jcfg, 6)
    sim = wt.Simulation(cfg, params, state)
    sim.run(6)
    got = sim.state
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=2e-4, atol=2e-4, err_msg=f)
    assert int(got.step_count) == int(want.step_count) == 6
    assert float(got.overflow_total) == float(want.overflow_total) > 0
    assert sim.graph.fired()["drop"] > 0
