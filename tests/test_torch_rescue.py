"""The device-count rescue on the CPU (``ops/rescue.py::rescue_selection``,
``density_rescue_count``, ``force_rescue_count`` and the plain versions of
the rescue kernels, ``ops/cuda/rescue.py``) against the JAX package's
``ops/rescue.py`` with its two budget tiers, and one kernel-pipeline step
that reads nothing on the host. Bar: rtol = atol = 2e-4 (another
summation order); zero overflow leaves every output bit-identical.

Also the invariants the kernels' cell-list walk (csrc/sph_rescue.cu)
relies on, which the CPU can check though it cannot run the kernels: the
build's sorted columns, the rescued list in column order on and off the
sorted path, and every pair within h of a rescued row inside the clamped
neighbourhood's runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

from water_sandbox_tpu.core.params import KernelCoeffs as JKernelCoeffs
from water_sandbox_tpu.core.params import SimConfig as JSimConfig
from water_sandbox_tpu.core.params import SimParams as JSimParams
from water_sandbox_tpu.ops import rescue as jrescue
import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core import convert
from water_sandbox_tpu_torch.core.params import KernelCoeffs, SimConfig
from water_sandbox_tpu_torch.ops import rescue
from water_sandbox_tpu_torch.ops.cuda import _build
from water_sandbox_tpu_torch.ops.cuda import rescue as rescue_k
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb

TOL = dict(rtol=2e-4, atol=2e-4)
T = torch.from_numpy


@pytest.fixture(scope="module")
def crowded():
    """The 2-D blob of test_torch_passes.py's ``crowded`` fixture: its
    cells hold far more than cell capacity 4."""
    rng = np.random.default_rng(4)
    n, dim = 500, 2
    pred = ((rng.random((n, dim)) - 0.5) * 1.2).astype(np.float32)
    vel = rng.standard_normal((n, dim)).astype(np.float32)
    acc = rng.standard_normal((n, dim)).astype(np.float32)
    jparams = JSimParams.create(dim=dim)
    jcfg = JSimConfig(n=n, dim=dim, neighbor_mode="pallas",
                      grid_dims=(12, 12), cell_capacity=4,
                      rescue_capacity=512, chunk=128)
    params = convert.params_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jparams)], device="cpu")
    return pred, vel, acc, jparams, jcfg, params


def _inputs(pred, vel, params, cfg):
    """The rescue's inputs as the particle-order step makes them: the
    build's dropped rows and overflow, the density planes and their
    gathered den/nden, and the build's sort (sorted columns, order)."""
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    pv = sb._param_vector(params, coeffs)
    planes, counts, flat, order, _, overflow, scol = sb._build_core(
        T(pred), T(vel), params, cfg)
    addr = sb._particle_addr(flat, order)
    dropped = addr == sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    dens = sb.run_density(planes, counts, addr, pv, cfg)
    den, nden = sb.gather_density(dens, addr, dropped, params)
    return (coeffs, pv, addr, dropped, overflow, dens, den, nden,
            (scol, order))


# (config overrides, the JAX tier the case takes)
# (400, 300 and 107 particles overflow cell capacity 4, 8 and 16; none 64)
CASES = {
    "large tier": ({}, "large"),
    "cell capacity 8": (dict(cell_capacity=8), "large"),
    "small tier": (dict(cell_capacity=16), "small"),
    "budget exceeded": (dict(rescue_capacity=64), "large"),
    "zero overflow": (dict(cell_capacity=64), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_count_rescue_matches_jax(crowded, case):
    """density_rescue_count and force_rescue_count against JAX's
    density_rescue and force_rescue at the budget JAX's step picks for the
    overflow (small_budget when it is at most 256, else rescue_capacity):
    the same rescued set, the same unrescued count; the in-place wrappers
    give the same rows and write the residents' derived rows into the
    density planes. With zero overflow everything is bit-identical to its
    input."""
    pred, vel, acc, jparams, jcfg, params = crowded
    kw, tier = CASES[case]
    jc = dataclasses.replace(jcfg, **kw)
    cfg = SimConfig(**dataclasses.asdict(jc))
    coeffs, pv, addr, dropped, overflow, dens, den, nden, sort = _inputs(
        pred, vel, params, cfg)
    n_over = int(overflow)
    small = jrescue.small_budget(jc)
    assert tier == (None if n_over == 0 else
                    "small" if n_over <= small else "large")
    cap = min(cfg.rescue_capacity, cfg.n)
    sel, slot, count = rescue.rescue_selection(dropped, overflow, cap)
    assert sel.dtype == slot.dtype == count.dtype == torch.int32

    budget = small if n_over <= small else jc.rescue_capacity
    jcoeffs = JKernelCoeffs.from_radius(jparams.smoothing_radius, 2)
    jd = jrescue.density_rescue(jnp.asarray(pred), jnp.asarray(dropped),
                                jnp.asarray(den), jnp.asarray(nden),
                                jparams, jcoeffs, jc, budget=budget)
    td = rescue.density_rescue_count(T(pred), sel, slot, count, den, nden,
                                     params, coeffs, cfg)
    assert int(overflow - count) == int(jd[3])
    np.testing.assert_array_equal(((slot >= 0) & (slot < count)).numpy(),
                                  np.asarray(jd[2]))
    for a, b in zip(td, jd[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    prs = params.pressure_scalar * (td[0] - params.target_density)
    nprs = params.near_pressure_scalar * td[1]
    ja = jrescue.force_rescue(
        jnp.asarray(pred), jnp.asarray(vel), jd[0], jd[1],
        jnp.asarray(prs.numpy()), jnp.asarray(nprs.numpy()),
        jnp.asarray(dropped), jnp.asarray(acc), jparams, jcoeffs, jc,
        budget=budget)
    ta = rescue.force_rescue_count(T(pred), T(vel), td[0], td[1], prs, nprs,
                                   sel, slot, count, T(acc), params, coeffs,
                                   cfg)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)

    # the wrappers: in place, the same rows, the planes written
    walk = rescue_k.cell_walk(sel, count, *sort)
    den_w, nden_w, dens_w, acc_w = (den.clone(), nden.clone(), dens.clone(),
                                    T(acc.copy()))
    rescue_k.rescue_density(T(pred), sel, slot, count, addr, den_w, nden_w,
                            dens_w, params, coeffs, pv, cfg, walk)
    rescue_k.rescue_force(T(pred), T(vel), den_w, nden_w, prs, nprs, sel,
                          slot, count, acc_w, params, coeffs, pv, cfg, walk)
    assert not any(_build.LAUNCHES.values())
    np.testing.assert_array_equal(den_w.numpy(), td[0].numpy())
    np.testing.assert_array_equal(nden_w.numpy(), td[1].numpy())
    np.testing.assert_array_equal(acc_w.numpy(), ta.numpy())
    keep = (~dropped).numpy()
    at = addr.long().numpy()[keep]
    want = sb.derived_density_planes(den_w, nden_w, params).numpy()[:, keep]
    np.testing.assert_array_equal(dens_w.reshape(6, -1).numpy()[:, at],
                                  want)

    if tier is None:
        assert int(count) == 0
        for got, was in ((td[0], den), (td[1], nden), (ta, T(acc)),
                         (den_w, den), (nden_w, nden), (dens_w, dens),
                         (acc_w, T(acc))):
            np.testing.assert_array_equal(got.numpy(), was.numpy())
    if case == "budget exceeded":
        assert int(overflow - count) > 0


def test_selection_is_dropped_selections_set(crowded):
    """rescue_selection's list is dropped_selection's order (the stable
    sort, dropped rows first in row order) for the first count slots, and
    slot gives each dropped row its rank, for budgets below and above the
    overflow."""
    pred, vel, _, _, jcfg, params = crowded
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    _, _, _, dropped, overflow, _, _, _, _ = _inputs(pred, vel, params,
                                                     cfg)
    n_over = int(overflow)
    for cap in (40, n_over, 500):
        sel, slot, count = rescue.rescue_selection(dropped, overflow, cap)
        order, valid, rescued, unrescued = rescue.dropped_selection(dropped,
                                                                    cap)
        k = int(count)
        assert k == min(n_over, cap) == int(valid.sum())
        np.testing.assert_array_equal(sel[:k].numpy(),
                                      order[:k].numpy().astype(np.int32))
        np.testing.assert_array_equal(((slot >= 0) & (slot < count)).numpy(),
                                      rescued.numpy())
        assert int(overflow - count) == int(unrescued)
        rows = torch.nonzero(dropped).flatten()
        np.testing.assert_array_equal(slot[rows].numpy(),
                                      np.arange(rows.numel()))
        assert bool((slot[~dropped] == -1).all())


@pytest.mark.parametrize("sorted_state", [True, False])
def test_kernel_step_reads_nothing_on_the_host(monkeypatch, sorted_state):
    """One step of the kernel pipeline (plain versions on the CPU) with the
    rescue firing, while every way a tensor reaches a Python value raises:
    the step holds no host read, so on the card it can be captured."""
    cfg, params, state = wt.scenes.build(
        "mini-3d", device="cpu", sorted_state=sorted_state, cell_capacity=4,
        rescue_capacity=16)
    raw = sb._build_core(state.predicted, state.vel, params,
                         cfg.resolved())[5]
    assert int(raw) > 16, "the rescue must fire past its budget"

    def refuse(*a, **k):
        raise AssertionError("a host read in the step")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = wt.step(state, params, cfg)
    monkeypatch.undo()
    # overflow counts the rows left beyond the budget of 16
    assert int(out.overflow) == int(raw) - 16 and int(out.step_count) == 1
    assert bool(torch.isfinite(out.pos).all())


# ----------------------------------------- the cell-list walk's invariants --

def _walk_case(case):
    """A crowded state at cell capacity 4 and the build's outputs for it:
    (pred (n, dim) f32 rows in particle order, cfg, the build's 7 outputs
    (planes, counts, flat, order, srows, overflow, sorted_col))."""
    rng = np.random.default_rng(21)
    time, origin, container = None, None, None
    if case == "2-D":
        n, dim, box, kw = 500, 2, (1.2, 1.2), dict(grid_dims=(12, 12))
    elif case == "3-D clamped":
        # gy·gz = 256 = S_pad: an unclamped y ± 1 at a slab's edge would
        # alias into the next x slab. The anchor sits inside the cloud and
        # the grid ends before it, so keys clamp on both sides of x and y.
        n, dim, box, kw = 6000, 3, (1.6, 2.6, 7.5), dict(grid_dims=(6, 8, 32))
        origin = torch.tensor([0.3, 0.3, 0.05])
    else:
        n, dim, box, kw = 1500, 3, (1.6, 1.6, 1.6), dict(
            grid_dims=(10, 10, 10), grid_frame="container")
        container = wt.Container.create((0.1, 0.0, -0.1), (3.0, 3.0, 3.0),
                                        velocity=(0.5, 0.0, 0.0),
                                        angular_velocity=0.4, angle=0.3,
                                        device="cpu")
        time = torch.tensor(0.9)          # yawed 0.66 rad: mid-turn
    pred = (rng.random((n, dim)) * np.asarray(box, np.float32)).astype(
        np.float32)
    if case == "container":
        pred -= np.float32(0.8)
    params = wt.SimParams.create(dim=dim, container=container, device="cpu")
    cfg = SimConfig(n=n, dim=dim, cell_capacity=4, rescue_capacity=n, **kw)
    built = sb._build_core(T(pred), torch.zeros((n, dim)), params, cfg,
                           origin=origin, time=time)
    assert int(built[5]) > 100, "the case must crowd its cells"
    return pred, params, cfg, built


WALK_CASES = ["2-D", "3-D clamped", "container"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_sorted_col_is_the_scattered_column(case):
    """The build's sorted_col never decreases and, for every resident, is
    the column its plane address holds (flat = slot·L + PAD + col)."""
    _, _, cfg, (_, _, flat, order, _, _, scol) = _walk_case(case)
    g = sb._geometry(cfg)
    PL = sb._cap_pad(cfg.cell_capacity) * g.L
    assert scol.dtype == torch.int32 and scol.shape == flat.shape
    assert bool((scol[1:] >= scol[:-1]).all())
    res = flat < PL
    np.testing.assert_array_equal((flat[res] % g.L - g.PAD).numpy(),
                                  scol[res].numpy())
    assert scol.min() >= 0 and scol.max() < g.gx * g.S_pad
    if case == "3-D clamped":
        # keys clamped at both ends of x: edge slabs are occupied
        assert int(scol.min()) // g.S_pad == 0
        assert int(scol.max()) // g.S_pad == g.gx - 1


@pytest.mark.parametrize("case", WALK_CASES)
def test_rescued_list_is_in_column_order(case):
    """On the sorted path the list, in row order, is in column order and
    is the walk's list as it is; off it, cell_walk's copy holds the same
    rows, by position, in column order — below and above the budget."""
    _, _, cfg, (_, _, flat, order, _, overflow, scol) = _walk_case(case)
    PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    n_over = int(overflow)
    for cap in (n_over // 3, cfg.n):
        # sorted path: rows are positions
        sel, _, count = rescue.rescue_selection(flat == PL, overflow, cap)
        k = int(count)
        walk = rescue_k.cell_walk(sel, count, scol)
        assert walk.order is None and walk.rpos is sel
        cols = scol[sel[:k].long()]
        assert bool((cols[1:] >= cols[:-1]).all())
        # particle order: the list is in row order, the copy by position
        addr = sb._particle_addr(flat, order)
        sel, _, count = rescue.rescue_selection(addr == PL, overflow, cap)
        walk = rescue_k.cell_walk(sel, count, scol, order)
        assert int(count) == k and walk.rpos.dtype == torch.int32
        rpos = walk.rpos[:k].long()
        assert bool((rpos[1:] > rpos[:-1]).all())
        cols = scol[rpos]
        assert bool((cols[1:] >= cols[:-1]).all())
        np.testing.assert_array_equal(np.sort(order[rpos].numpy()),
                                      np.sort(sel[:k].numpy()))


@pytest.mark.parametrize("case", WALK_CASES)
def test_pairs_within_h_lie_in_the_runs(case):
    """Every pair within h between a rescued row and any row (itself
    included) is found by both parts of the walk: the row's position lies
    in one of the rescued row's run ranges (two lower bounds of sorted_col
    each, as part (a) finds them), and the rescued row's column in one of
    the row's runs (part (b)). The ranges are disjoint and ascending, the
    order the sweep's bits rely on."""
    _, params, cfg, (_, _, flat, _, srows, overflow, scol) = _walk_case(case)
    PL = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg).L
    sel, _, count = rescue.rescue_selection(flat == PL, overflow, cfg.n)
    rows = sel[:int(count)].long()
    pos = srows[:, :cfg.dim]                      # positions = sorted rows
    h = float(params.smoothing_radius)
    d = torch.sqrt(((pos[rows][:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    o_idx, k = torch.nonzero(d <= h, as_tuple=True)
    o = rows[o_idx]
    assert o.numel() > 10 * rows.numel()

    lo, hi = rescue_k.neighbour_runs(scol[rows], cfg)
    s64 = scol.long()
    valid = lo <= hi                  # a run outside the grid is empty
    b = torch.where(valid, torch.searchsorted(s64, lo), 0)
    e = torch.where(valid, torch.searchsorted(s64, hi + 1), 0)
    assert bool(valid.sum(dim=1).min() >= 2 ** (cfg.dim - 1))
    for r in range(lo.shape[1]):                  # disjoint, ascending
        for r2 in range(r + 1, lo.shape[1]):
            both = valid[:, r] & valid[:, r2]
            assert bool((e[both, r] <= b[both, r2]).all())
    kk = k[:, None]
    assert bool(((b[o_idx] <= kk) & (kk < e[o_idx])).any(dim=1).all())

    lo_k, hi_k = rescue_k.neighbour_runs(scol[k], cfg)
    co = s64[o][:, None]
    assert bool(((lo_k <= co) & (co <= hi_k)).any(dim=1).all())
