"""PyTorch port, the entry points (``graphbasedlocaltrajectoryplanner_torch
.entry``) against the JAX package's ``__graft_entry__`` on the CPU.

- ``entry()``'s tick on the JAX package's own small lattice carried across
  bit for bit: the same seeded scenarios, ``valid`` and ``cost`` equal,
  trajectories within 2 mm and 0.02 m/s;
- ``entry(device="cpu")`` on the port's own build of the lattice against
  JAX ``entry()`` on its build (the two builders agree to rounding):
  ``valid`` equal, ``cost`` within 1e-5 relative;
- ``dryrun_multidevice(4, "gloo")`` in four CPU rank processes against
  ``dryrun_multichip(4)`` on 4 of the 8 virtual CPU devices: its four
  numbers (read from the JAX run's own fleet statistics and goal costs)
  within 1e-3, the action count equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch import entry as tentry
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc

from torch_port_common import carry

TOL_POS, TOL_VX = 2e-3, 0.02


@pytest.fixture(scope="module")
def jax_entry():
    fn, (scen,) = graft.entry()
    trajs, valid, cost = jax.jit(fn)(scen)
    return scen, np.asarray(trajs), np.asarray(valid), np.asarray(cost)


def test_entry_tick_on_the_carried_lattice(jax_entry):
    jscen, jtrajs, jvalid, jcost = jax_entry
    fn, (scen,) = tentry._entry_on(carry(graft._small_lattice()), "cpu")
    assert scen.start_layer.shape[0] == tentry.BATCH == jtrajs.shape[0]
    for f in dataclasses.fields(tsc.Scenario):
        np.testing.assert_array_equal(
            getattr(scen, f.name).numpy(), np.asarray(getattr(jscen, f.name)),
            err_msg=f.name)
    trajs, valid, cost = fn(scen)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(cost.numpy(), jcost)
    d = np.abs(trajs.numpy().astype(np.float64) - jtrajs)
    d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
    print(f"entry tick, carried lattice: {int(valid.sum())} valid actions, "
          f"valid and cost equal; max |d s,x,y| = {d_pos:.3g} m, max "
          f"|d vx| = {d_vx:.3g} m/s")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX


def test_entry_on_each_packages_own_build(jax_entry):
    _, jtrajs, jvalid, jcost = jax_entry
    fn, ex = tentry.entry(device="cpu")
    trajs, valid, cost = fn(*ex)
    assert trajs.shape == jtrajs.shape and trajs.device.type == "cpu"
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    rel = np.abs(cost.numpy().astype(np.float64) - jcost) \
        / np.maximum(np.abs(jcost), 1e-30)
    print(f"entry(device='cpu') against JAX entry(): valid equal, max "
          f"relative |d cost| = {rel.max():.3g}")
    assert rel.max() <= 1e-5


def test_entry_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multidevice(4, "gloo")


def test_dryrun_multidevice_matches_jax(monkeypatch):
    """The JAX dry run's numbers are read from its own calls: the fleet
    statistics its sharded ticks return and the goal costs of its four
    ``backtrace_slot`` calls."""
    stats, goal = {}, []
    real_tick, real_walk = jsc.make_sharded_tick, jpg.backtrace_slot

    def spy_tick(lat, mesh, *a, **kw):
        tick = real_tick(lat, mesh, *a, **kw)

        def run(scen):
            res, st = tick(scen)
            stats["composed" if kw.get("spatial_axis") else "dp"] = {
                k: float(v) for k, v in st.items()}
            return res, st
        return run

    def spy_walk(*a, **kw):
        out = real_walk(*a, **kw)
        goal.append(float(out[1]))
        return out

    monkeypatch.setattr(jsc, "make_sharded_tick", spy_tick)
    monkeypatch.setattr(jpg, "backtrace_slot", spy_walk)
    graft.dryrun_multichip(4)
    assert len(goal) == 4
    ref = dict(fleet_min_cost=stats["dp"]["fleet_min_cost"],
               actions=int(stats["dp"]["fleet_actions"]),
               spatial_dp_goal_cost=min(goal),
               dp_mp_composed_min_cost=stats["composed"]["fleet_min_cost"])

    got = tentry.dryrun_multidevice(4, "gloo", device="cpu")
    assert got["actions"] == ref["actions"]
    d = {k: abs(got[k] - ref[k]) for k in tentry.KEYS if k != "actions"}
    print(f"dryrun_multidevice(4, 'gloo') on the CPU: {got['reports'][0]}; "
          f"JAX dryrun_multichip(4): {ref}; |d| {d}")
    assert max(d.values()) <= 1e-3
    assert len(got["reports"]) == 4 and all(
        r["backend"] == "gloo" for r in got["reports"])
