"""The mesh's per-shard CUDA streams (``parallel/mesh.py``) on the CPU, where
a mesh has none: its scopes launch nothing, a structural guard on the
stream discipline, and the serial reference against the default mesh.

The CPU cannot race, so the guard checks the structure that keeps the
card's streams apart: a mesh that records its scopes, and a dispatch mode
that sees every ATen op of a step, show that every op that touches data
runs inside a shard's scope or inside a collective, that a shard reads
another shard's tensor only after a collective handed it over and never
writes one, that the step writes none of its inputs, and that no
collective runs inside a shard's scope. It runs the domain step (the
kernels' path with their plain versions, and the plain pair-block path)
and the cell-slab-sharded step at ~2,300 particles on 8 shards with the
rescue forced. The card's half (concurrent against serial, bit for bit,
captured and eager) is in tests/test_torch_cuda.py."""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)

import water_sandbox_tpu_torch as wt
from water_sandbox_tpu_torch.core.params import Container
from water_sandbox_tpu_torch.parallel import domain, gspmd, mesh as mesh_mod

SHARDS = 8


# Tagged tensors up to this size are kept alive for the whole step.
_SMALL = 256


def _key(t: torch.Tensor):
    """The storage a tensor with data reads or writes (None when empty)."""
    return t.untyped_storage().data_ptr() if t.numel() else None


class ScopedMesh(mesh_mod.Mesh):
    """A mesh that records its scopes: ``stack`` holds ("step",),
    ("shard", d), ("collective",) and ("on", d) (a shard's stream) as they
    open; ``handed`` the storages a collective handed to each shard;
    ``faults`` a collective opened inside a shard's scope; ``opened`` the
    shard scopes by shard."""

    def __init__(self, devices):
        super().__init__(devices)
        self.stack, self.faults = [], []
        self.handed = collections.defaultdict(set)
        self.opened = collections.Counter()

    @contextlib.contextmanager
    def _entered(self, entry, ctx):
        with ctx:
            self.stack.append(entry)
            try:
                yield
            finally:
                self.stack.pop()

    def step(self):
        return self._entered(("step",), super().step())

    def shard(self, d):
        self.opened[d] += 1
        return self._entered(("shard", d), super().shard(d))

    def _on(self, d):
        return self._entered(("on", d), super()._on(d))

    def _collective(self):
        if any(e[0] == "shard" for e in self.stack):
            self.faults.append(f"a collective inside {self.stack}")
        return self._entered(("collective",), super()._collective())

    def _send(self, kind, x, src, dst):
        y = super()._send(kind, x, src, dst)
        if _key(y) is not None:
            self.handed[_key(y)].add(dst)
        return y


class Discipline(TorchDispatchMode):
    """Every ATen op under ``mesh``'s step scope, held to the stream
    discipline; fresh outputs belong to the shard whose stream runs the op.
    View ops are let through: they move no data and launch nothing.

    A tag is its storage's address and size. A tensor made outside the
    dispatcher (a wrapped Python scalar, ``torch.tensor``) carries no tag
    of its own, so it must not find a stale one: the small tagged tensors
    are kept alive for the step, and a larger freed one's tag does not
    match a small tensor's size."""

    def __init__(self, mesh: ScopedMesh):
        super().__init__()
        self.mesh = mesh
        self.owner: dict = {}
        self.keep: list = []
        self.faults: list = []
        self.ops = collections.Counter()

    def tag(self, t: torch.Tensor, d) -> None:
        self.owner[_key(t)] = (d, t.untyped_storage().nbytes())
        if t.untyped_storage().nbytes() <= _SMALL:
            self.keep.append(t)

    def owner_of(self, t: torch.Tensor):
        d, nbytes = self.owner.get(_key(t), (None, None))
        return d if nbytes == t.untyped_storage().nbytes() else None

    def own(self, tensors, d: int) -> None:
        """Shard d's inputs; one that several shards share (the CPU's
        ``shard_state`` hands every shard the same scalars) is none's."""
        for t in tensors:
            if _key(t) is not None:
                shared = _key(t) in self.owner and self.owner_of(t) != d
                self.tag(t, None if shared else d)

    def _args(self, func, args, kwargs):
        """(tensor, written) for every tensor argument."""
        schema = func._schema.arguments
        named = dict(zip((a.name for a in schema), args), **kwargs)
        for a in schema:
            value = named.get(a.name)
            written = a.alias_info is not None and a.alias_info.is_write
            for t in (value if isinstance(value, (list, tuple))
                      else [value]):
                if isinstance(t, torch.Tensor):
                    yield t, written

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return out
        stack = self.mesh.stack
        if not stack:
            return out
        kinds = [e[0] for e in stack]
        shard = next((e[1] for e in stack if e[0] == "shard"), None)
        on = next((e[1] for e in reversed(stack) if e[0] == "on"), None)
        inputs = list(self._args(func, args, kwargs))
        if "collective" in kinds:
            self.ops["collective"] += 1
        elif shard is None:
            self.faults.append(f"{func} outside any shard's scope")
        else:
            self.ops["shard"] += 1
            for t, written in inputs:
                k = _key(t)
                if k is None:
                    continue
                owner = self.owner_of(t)
                if written and owner != shard:
                    self.faults.append(
                        f"{func} in shard {shard}'s scope writes a tensor "
                        f"of {'the step input' if owner is None else owner}")
                elif (owner is not None and owner != shard
                      and shard not in self.mesh.handed.get(k, ())):
                    self.faults.append(
                        f"{func} in shard {shard}'s scope reads shard "
                        f"{owner}'s tensor that no collective handed over")
        fresh = {_key(t) for t, _ in inputs}
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and _key(t) not in fresh | {None}:
                self.tag(t, on)
                self.mesh.handed.pop(_key(t), None)
        return out


def _cube():
    """~2,300 particles in rightward flow (they migrate)."""
    pts = wt.cube_fluid(16, 12, 12)
    vel = np.zeros_like(pts)
    vel[:, 0] = 3.0
    return pts, vel


def _domain_case(mesh):
    """The cube in a (8, 6, 6) box on 8 shards, cell capacity 1: every
    occupied shard drops rows, more than R = 256 of them."""
    pts, vel = _cube()
    params = wt.SimParams.create(dim=3, device="cpu", container=(
        Container.create((0.0, 0.0, 0.0), (4.0, 3.0, 3.0), device="cpu")))
    cfg = wt.SimConfig(n=pts.shape[0], dim=3, grid_dims=(40, 32, 32),
                       cell_capacity=1, rescue_capacity=512)
    states, active = domain.shard_state(
        wt.init_state(pts, vel, device="cpu"), mesh, cfg, params, slack=4.0)
    return cfg, params, states, active


def _sharded_case(mesh):
    """The cube in ``bucket_grid`` on 8 slabs, cell capacity 2, the rescue
    taking up to 64 dropped rows."""
    pts, vel = _cube()
    cfg = wt.SimConfig(n=pts.shape[0], dim=3, neighbor_mode="bucket_grid",
                       grid_dims=(16, 16, 16), cell_capacity=2,
                       rescue_capacity=64)
    params = wt.SimParams.create(dim=3, device="cpu")
    return cfg, params, gspmd.shard_state(
        wt.init_state(pts, vel, device="cpu"), mesh)


def _step_of(case: str, mesh):
    """(one step on ``mesh``'s state, the per-shard input tensors, the
    state's overflow before the rescue)."""
    if case == "sharded":
        cfg, params, states = _sharded_case(mesh)
        step = gspmd.make_sharded_step(mesh, cfg)
        raw = int(sum(g.overflow for g in gspmd.build_slabs(
            mesh, cfg, states, [params] * SHARDS).grids))
        return (lambda: step(states, params)), [
            [getattr(s, f.name) for f in dataclasses.fields(s)]
            for s in states], raw
    cfg, params, states, active = _domain_case(mesh)
    step = domain.make_domain_step(
        mesh, cfg, use_pallas=False if case == "domain plain" else None)
    raw = int(sum(domain.halo_planes(
        [s.predicted for s in states], [s.vel for s in states], active,
        [params] * SHARDS, cfg, cfg.grid_dims[0] // SHARDS, mesh)[3]))
    return (lambda: step(states, active, params)), [
        [getattr(s, f.name) for f in dataclasses.fields(s)] + [a]
        for s, a in zip(states, active)], raw


def test_a_cpu_mesh_has_no_streams_and_its_scopes_launch_nothing():
    """On the CPU neither the default mesh nor the serial one has streams;
    a step, a shard's scope and the collectives run and leave CUDA
    untouched; the scopes refuse a shard's scope outside a step, one shard
    inside another's and a collective inside a shard's."""
    for serial in (False, True):
        mesh = mesh_mod.make_mesh(4, "cpu", serial=serial)
        assert mesh.streams is None and mesh.serial is serial
        xs = [torch.tensor(float(d)) for d in range(4)]
        with mesh.step():
            with mesh.shard(2):
                y = xs[2] * 2
            assert [float(x) for x in mesh.psum(xs)] == [6.0] * 4
        assert float(y) == 4.0
        assert mesh.each(lambda d: d * 10) == [0, 10, 20, 30]
        with pytest.raises(RuntimeError, match="outside a step"):
            with mesh.shard(0):
                pass
        with mesh.step(), mesh.shard(0):
            with pytest.raises(RuntimeError, match="inside shard 0"):
                with mesh.shard(1):
                    pass
            with pytest.raises(RuntimeError, match="collective inside"):
                mesh.shift_left(xs)
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("case", ["domain kernels", "domain plain",
                                  "sharded"])
def test_every_shard_op_runs_in_its_own_scope(case):
    """One step with the rescue forced: every op that touches data runs in
    a shard's scope or in a collective, reads only its shard's tensors,
    the step's inputs and what a collective handed it, writes only its
    shard's, and every shard opens its scope."""
    mesh = ScopedMesh([torch.device("cpu")] * SHARDS)
    step, inputs, raw = _step_of(case, mesh)
    assert raw > 0, "the rescue must be forced"
    mode = Discipline(mesh)
    for d, tensors in enumerate(inputs):
        mode.own(tensors, d)
    mesh.opened.clear()
    with mode:
        step()
    assert mode.faults == [] and mesh.faults == []
    assert mode.ops["shard"] > 1000 and mode.ops["collective"] > 10
    assert sorted(mesh.opened) == list(range(SHARDS))
    assert not mesh.stack


@pytest.mark.parametrize("case", ["domain kernels", "domain plain",
                                  "sharded"])
def test_the_serial_reference_repeats_the_default_mesh(case):
    """Two steps on a serial mesh and on the default one give the same
    bits (on the CPU both run every shard in the caller's order)."""
    out = []
    for serial in (True, False):
        mesh = mesh_mod.make_mesh(SHARDS, "cpu", serial=serial)
        if case == "sharded":
            cfg, params, states = _sharded_case(mesh)
            rollout = gspmd.make_sharded_rollout(mesh, cfg)
            out.append(rollout(states, params, 2))
        else:
            cfg, params, states, active = _domain_case(mesh)
            rollout = domain.make_domain_rollout(
                mesh, cfg, use_pallas=False if case == "domain plain"
                else None)
            out.append(rollout(states, active, params, 2)[0])
    for a, b in zip(*out):
        for f in ("pos", "vel", "density", "acc", "overflow_total"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
