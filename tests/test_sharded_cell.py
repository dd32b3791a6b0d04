"""The benchmark's domain-decomposed cell (``sharded-1m.steps``) on the
CPU, through the program alone: the harness's 512-particle cube on two
shards (``sphbench/tests/test_sharded_steps.py::_small``) run through
``sphbench.run.run_cell``, whose check holds every particle's fields after
a step to the float64 plain reference by id. Particles cross the shards'
boundary on most steps at this size, so a migration that leaves a moved
particle's density, pressures and acceleration behind in its old slot
reads as not correct."""

import dataclasses

from _torch_fixtures import _one_torch_thread  # noqa: F401 (autouse)
from sphbench.tests.test_sharded_steps import CARRIED, _run, _small


def test_the_small_sharded_cell_is_correct_and_its_control_is_not():
    out = _run(_small(), control=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["_control_correct"] is False, out["_control"]


def _left_behind(real):
    """The migration as it was: each slot keeps the carried fields it held
    before the move, whichever particle lands in it."""
    def migrate(states, *args):
        moved, active, lost = real(states, *args)
        return ([dataclasses.replace(m, **{f: getattr(s, f)
                                           for f in CARRIED})
                 for m, s in zip(moved, states)], active, lost)
    return migrate


def test_fields_left_behind_by_the_migration_are_not_correct(monkeypatch):
    from water_sandbox_tpu_torch.parallel import domain
    monkeypatch.setattr(domain, "_migrate", _left_behind(domain._migrate))
    out = _run(_small())
    assert not out["correct"]
    assert out["checks"]["density"]["value"] > 0.1, out["checks"]
