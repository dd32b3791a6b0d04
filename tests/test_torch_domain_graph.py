"""The domain step's device-only execution on the CPU: the cross-shard
rescue's kernels D1 and D2 (``ops/cuda/domain_rescue.py``, plain versions
here), the step with every tensor-to-host read patched to raise, the walk
the kernels take, and ``DistributedSimulation``'s ``DomainGraph``
(eager on the CPU, into the buffers a capture would replay).

At ``tests/test_torch_domain.py``'s size: 96 particles on 8 shards, grid
(24, 16, 16). At cell capacity 1 the lattice overflows on shard 2 alone
(its cells at x = 8 hold two particles each), next to shard 3. Bars: by
particle id within atol 1e-4 of the JAX package's XLA domain step (the
sums run in another order); everything else bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_domain import ATOL, _cat, _pos_by_id, _setup

from water_sandbox_tpu.parallel import domain as jdomain
from water_sandbox_tpu.parallel import mesh as jmesh
from water_sandbox_tpu_torch.core.params import KernelCoeffs, _map_tensors
from water_sandbox_tpu_torch.ops.cuda import domain_rescue as dr
from water_sandbox_tpu_torch.ops.cuda import graph as graph_mod
from water_sandbox_tpu_torch.ops.cuda import rescue as rescue_k
from water_sandbox_tpu_torch.ops.cuda import sph_bucket as sb
from water_sandbox_tpu_torch.parallel import domain, mesh as mesh_mod
from water_sandbox_tpu_torch.runtime.distributed import DistributedSimulation

RESCUE = dict(cell_capacity=1, rescue_capacity=512)
GX_LOC = 3


def _sharded(mesh, **kw):
    _, _, _, params, state, cfg = _setup(**kw)
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    return params, cfg, states, active


def _rescue_inputs(params, cfg, states, active, mesh):
    """The domain step up to D1, as ``_sph_local_pallas`` runs it: the
    builds, the halo exchange, K1 (plain) and the rescue's queries."""
    nsh = mesh.size
    ps = [params] * nsh
    pred = [s.predicted for s in states]
    vel = [s.vel for s in states]
    feats, counts, addr, overflow, walks = domain._halo_build(
        pred, vel, active, ps, cfg, GX_LOC, mesh)
    cfg_loc = domain._local_cfg(cfg, GX_LOC)
    coeffs = KernelCoeffs.from_radius(params.smoothing_radius, cfg.dim)
    pv = sb._param_vector(params, coeffs)
    dens = [sb.run_density(feats[d], counts[d], addr[d], pv, cfg_loc)
            for d in range(nsh)]
    sentinel = sb._cap_pad(cfg.cell_capacity) * sb._geometry(cfg_loc).L
    dropped = [(addr[d] == sentinel) & (active[d] > 0) for d in range(nsh)]
    qs, slots, R = domain._rescue_queries(pred, vel, dropped, overflow, ps,
                                          cfg, GX_LOC, mesh, 256)
    return dict(pred=pred, vel=vel, feats=feats, addr=addr,
                overflow=overflow, walks=walks, dens=dens, qs=qs,
                slots=slots, R=R, coeffs=coeffs, pv=pv, cfg_loc=cfg_loc)


@pytest.mark.parametrize("case", ["rescue", "no overflow"])
@pytest.mark.parametrize("use_pallas", [None, False])
def test_domain_step_reads_nothing_on_the_host(monkeypatch, use_pallas,
                                               case):
    """One domain step, on the kernels' path (their plain versions here)
    and on the plain pair-block path, with and without overflow (the
    rescue on in both), while every way a tensor reaches a Python value
    raises: the step holds no host read, so on the card it is captured."""
    kw = RESCUE if case == "rescue" else dict(rescue_capacity=512)
    mesh = mesh_mod.make_mesh(8, "cpu")
    params, cfg, states, active = _sharded(mesh, rightward=True, **kw)
    raw = sum(int(o) for o in domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * 8, cfg, GX_LOC, mesh)[3])
    assert (raw > 0) == (case == "rescue")
    step = domain.make_domain_step(mesh, cfg, use_pallas=use_pallas)

    def refuse(*a, **k):
        raise AssertionError("a host read in the domain step")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out, active_out, lost = step(states, active, params)
    monkeypatch.undo()
    assert float(lost) == 0.0 and int(out[0].overflow) == 0
    assert int(out[0].step_count) == 1
    assert all(bool(torch.isfinite(s.pos).all()) for s in out)


def test_one_overflowing_shard_matches_jax_and_corrects_its_neighbour():
    """Cell capacity 1 at rest: shard 2 alone overflows. Its neighbour
    shard 3 has nothing of its own to rescue, yet its gate (the valid
    query rows of its own and both neighbours') is open and D1 corrects
    its residents' density rows. Four steps against JAX's XLA domain step,
    by id."""
    jparams, jstate, jcfg, params, state, cfg = _setup(**RESCUE)
    mesh = mesh_mod.make_mesh(8, "cpu")
    states, active = domain.shard_state(state, mesh, cfg, params, slack=8.0)
    x = _rescue_inputs(params, cfg, states, active, mesh)
    overflow = [int(o) for o in x["overflow"]]
    assert [d for d, o in enumerate(overflow) if o] == [2], overflow
    counts = [int(q.count) for q in x["qs"]]
    assert counts[1] == counts[2] == counts[3] == overflow[2]
    assert counts[0] == counts[4] == 0
    before = x["dens"][3].clone()
    R = x["R"]
    qden, qnden = torch.zeros(R), torch.zeros(R)
    dr.rescue_density(x["pred"][3], x["walks"][3], x["addr"][3], x["qs"][3],
                      x["feats"][3], x["dens"][3], qden, qnden, params,
                      x["coeffs"], x["pv"], x["cfg_loc"])
    changed = ~torch.isclose(x["dens"][3], before, rtol=1e-6, atol=0) & (
        ~torch.isnan(before))
    assert int(changed[0].sum()) > 0, "shard 3's residents took nothing"
    assert not bool(qden.any()), "shard 3 has no rows of its own"

    jsh, jact = jdomain.shard_state(jstate, jmesh.make_mesh(8), jcfg,
                                    jparams, slack=8.0)
    jstep = jdomain.make_domain_step(jmesh.make_mesh(8), jcfg,
                                     use_pallas=False)
    step = domain.make_domain_step(mesh, cfg)
    for _ in range(4):
        jsh, jact, jlost = jstep(jsh, jact, jparams)
        states, active, lost = step(states, active, params)
        assert float(jlost) == 0.0 and float(lost) == 0.0
        assert int(states[0].overflow) == int(jsh.overflow) == 0
    got = _pos_by_id(_cat(states, "pos"), _cat(states, "ids"),
                     torch.cat(active))
    want = _pos_by_id(jsh.pos, jsh.ids, jact)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert float(states[0].overflow_total) == 0.0


def test_kernels_change_nothing_at_count_zero():
    """D1 and D2 (plain versions) on a shard whose gate is 0 leave the
    density planes, the query sums and the accelerations bit for bit."""
    mesh = mesh_mod.make_mesh(8, "cpu")
    params, cfg, states, active = _sharded(mesh, **RESCUE)
    x = _rescue_inputs(params, cfg, states, active, mesh)
    d = 0
    q = x["qs"][d]
    assert int(q.count) == 0
    R = x["R"]
    dens = x["dens"][d].clone()
    qden, qnden = torch.full((R,), 7.0), torch.full((R,), 7.0)
    dr.rescue_density(x["pred"][d], x["walks"][d], x["addr"][d], q,
                      x["feats"][d], x["dens"][d], qden, qnden, params,
                      x["coeffs"], x["pv"], x["cfg_loc"])
    assert torch.equal(x["dens"][d].view(torch.int32), dens.view(torch.int32))
    assert bool((qden == 7.0).all() and (qnden == 7.0).all())
    n = x["pred"][d].shape[0]
    acc = torch.randn(n, 3)
    want = acc.clone()
    den = torch.full((n,), 1000.0)
    qf = dr.force_rows(q, torch.ones(3 * R), torch.ones(3 * R), params)
    dr.rescue_force(x["pred"][d], x["vel"][d], den, den, den, den,
                    x["walks"][d], x["slots"][d], q, qf, x["feats"][d],
                    x["dens"][d], acc, params, x["coeffs"], x["pv"],
                    x["cfg_loc"])
    assert torch.equal(acc, want)


@pytest.mark.parametrize("my_dev", [0, 3, 7])
def test_walk_holds_every_row_within_h_of_a_query(my_dev):
    """The kernels' walk (csrc/sph_domain_rescue.cu): for query rows of
    the shard's own, from beyond either slab edge (a neighbour's rows) and
    far outside (stragglers), every active row within h lies in the
    query's clamped neighbour runs, searched by its sorted key."""
    _, _, _, params, _, cfg = _setup()
    rng = np.random.default_rng(my_dev)
    n = 1500
    cfg_loc = dataclasses.replace(domain._local_cfg(cfg, GX_LOC),
                                  cell_capacity=4)
    origin = domain._grid_origin_static(params, cfg)
    h = float(params.smoothing_radius)
    lo_x = float(origin[0]) + my_dev * GX_LOC * h
    box = np.asarray([GX_LOC * h, 3.2, 3.2])
    corner = np.asarray([lo_x, -1.6, -1.6])
    # rows over the slab and a cell beyond each edge (stragglers), queries
    # two cells beyond each edge too
    pred = corner + (rng.random((n, 3)) * (box + [2 * h, 0, 0])
                     - [h, 0, 0])
    query = corner + (rng.random((600, 3)) * (box + [4 * h, 0, 0])
                      - [2 * h, 0, 0])
    pred, query = (torch.from_numpy(a.astype(np.float32))
                   for a in (pred, query))
    active = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32))
    pred[active == 0] = sb._FAR
    built = sb.build_local_slab_buckets(pred, torch.zeros_like(pred),
                                        active, origin, GX_LOC, my_dev,
                                        params, cfg_loc)
    skey, order = built[4], built[5]
    valid = torch.ones(query.shape[0], dtype=torch.bool)
    col, scol, qord = dr.query_walk(query, valid, origin, GX_LOC, my_dev,
                                    params, cfg_loc)
    assert bool((scol[1:] >= scol[:-1]).all())
    assert torch.equal(col[qord.long()], scol)
    lo, hi = rescue_k.neighbour_runs(col, cfg_loc)
    key = torch.empty_like(skey)
    key[order.long()] = skey                  # each row's key
    d2 = ((query[:, None, :] - pred[None, :, :]) ** 2).sum(-1)
    near = (d2 <= h * h) & (active[None, :] > 0)
    assert int(near.sum()) > 1000
    inside = ((key[None, :, None] >= lo[:, None, :])
              & (key[None, :, None] <= hi[:, None, :])).any(-1)
    assert bool(inside[near].all())
    out_of_slab = (query[:, 0] < lo_x) | (query[:, 0] >= lo_x + GX_LOC * h)
    assert int((near & out_of_slab[:, None]).sum()) > 100


@pytest.mark.parametrize("my_dev", [0, 3, 7])
def test_sorted_keys_are_the_scattered_columns(my_dev):
    """The shard build's sorted keys never decrease, are each resident's
    column in its plane address (addr = slot·L + PAD + column), and put
    the inactive rows last at gx_loc·S_pad; ``order`` is a permutation."""
    _, _, _, params, _, cfg = _setup()
    rng = np.random.default_rng(10 + my_dev)
    n = 1500
    cfg_loc = dataclasses.replace(domain._local_cfg(cfg, GX_LOC),
                                  cell_capacity=4)
    pred = ((rng.random((n, 3)) - 0.5) * [4.4, 3.2, 3.2]).astype(np.float32)
    active = (rng.random(n) < 0.8).astype(np.float32)
    pred[active == 0] = sb._FAR
    planes, counts, addr, overflow, skey, order = sb.build_local_slab_buckets(
        torch.from_numpy(pred), torch.zeros((n, 3)), torch.from_numpy(active),
        domain._grid_origin_static(params, cfg), GX_LOC, my_dev, params,
        cfg_loc)
    g = sb._geometry(cfg_loc)
    PL = sb._cap_pad(cfg_loc.cell_capacity) * g.L
    end = GX_LOC * g.S_pad
    assert skey.dtype == order.dtype == torch.int32
    assert bool((skey[1:] >= skey[:-1]).all())
    assert torch.equal(torch.sort(order).values,
                       torch.arange(n, dtype=torch.int32))
    key = torch.empty_like(skey)
    key[order.long()] = skey
    act = torch.from_numpy(active) > 0
    assert bool((key[~act] == end).all()) and bool((key[act] < end).all())
    res = addr < PL
    assert int(overflow) > 0 and int(res.sum()) > 0
    assert torch.equal((addr[res] % g.L) - g.PAD, key[res])
    assert torch.equal(dr.active_rows(dr.Rows(skey, order), cfg_loc),
                       act)


def _clone_all(states, active):
    return [s.clone() for s in states], [a.clone() for a in active]


def _same(a, b):
    return all(torch.equal(getattr(x, f).view(torch.int32)
                           if getattr(x, f).dtype == torch.float32
                           else getattr(x, f),
                           getattr(y, f).view(torch.int32)
                           if getattr(y, f).dtype == torch.float32
                           else getattr(y, f))
               for x, y in zip(a, b) for f in ("pos", "vel", "density",
                                               "acc", "ids"))


def test_distributed_run_is_eager_steps_and_tune_takes_the_next_step():
    """``DistributedSimulation.run(n)`` on the CPU (its DomainGraph steps
    eagerly into its buffers) equals n calls of the domain step bit for bit,
    with the rescue firing; ``tune`` copies into the parameter buffers and
    the next step sees it."""
    _, _, _, params, state, cfg = _setup(rightward=True, **RESCUE)
    sim = DistributedSimulation(cfg, params, state, n_shards=8, slack=8.0,
                                device="cpu")
    assert sim.execution == "eager" and not sim.graph.captures
    states, active = _clone_all(sim.states, sim.active)
    step = domain.make_domain_step(sim.mesh, sim.cfg, mig_cap=1024)
    own = _map_tensors(sim.params, torch.clone)
    for _ in range(3):
        states, active, _ = step(states, active, own)
    buffers = [s.pos for s in sim.states]
    sim.run(3)
    assert all(a is b for a, b in zip(buffers, (s.pos for s in sim.states)))
    assert _same(sim.states, states)
    assert all(torch.equal(a, b) for a, b in zip(sim.active, active))
    assert sim.stats()["execution"] == "eager"

    pv = sim.params.viscosity_strength
    sim.tune(viscosity_strength=0.5)
    assert sim.params.viscosity_strength is pv and float(pv) == 0.5
    tuned = own.replace(viscosity_strength=0.5)
    want, want_act, _ = step(*_clone_all(states, active), tuned)
    untuned, _, _ = step(*_clone_all(states, active), own)
    sim.run(1)
    assert _same(sim.states, want)
    assert not _same(sim.states, untuned)
    assert float(sim.graph.lost) == 0.0


def test_rollout_steps_copies_and_plain_path_stays_eager():
    """``make_domain_rollout`` steps a DomainGraph over copies of its
    inputs (they stay as they were) and sums the losses; on the CPU the
    graph of either path never captures and the plain pair-block path
    (``use_pallas=False``) steps eagerly, as its step does. On one card
    both paths capture (their occupied-cell walks read nothing on the
    host; tests/test_torch_cuda.py)."""
    mesh = mesh_mod.make_mesh(8, "cpu")
    params, cfg, states, active = _sharded(mesh, rightward=True)
    kept = _clone_all(states, active)
    out, out_act, lost = domain.make_domain_rollout(mesh, cfg)(
        states, active, params, 2)
    assert _same(states, kept[0]) and float(lost) == 0.0
    assert int(out[0].step_count) == 2 and not _same(out, states)
    plain = domain.make_domain_step(mesh, cfg, use_pallas=False)
    out_p, _, _ = domain.make_domain_rollout(mesh, cfg, use_pallas=False)(
        states, active, params, 2)
    want = _clone_all(states, active)
    for _ in range(2):
        want = plain(*want[:2], params)[:2]
    assert _same(out_p, want[0])
    step = domain.make_domain_step(mesh, cfg)
    assert graph_mod.DomainGraph(step, states, active, params,
                                        mesh).captures is False   # CPU
