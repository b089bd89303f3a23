"""PyTorch port, the batched fleet tick end to end: the port's plain tick
(``make_batched_tick(lat, device="cpu")``) against the JAX tick on the same
carried-across lattice and the same seeded scenarios.  Exact for the
action-set decisions and costs; trajectories within the JAX package's own
cross-backend bar (2 mm, 0.02 m/s)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc

from torch_port_common import carry, jax_small_oval, jax_unclosed

EXACT = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel", "em_base")


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    return ja, carry(ja)


def _jax_tick(ja):
    """The JAX package's XLA tick (``make_batched_tick(use_pallas=False)``
    semantics) with the shared zone mask as an argument, so one compile
    serves the zone-free and the zoned runs."""
    return jax.jit(lambda scen, zb: jax.vmap(
        lambda s: jsc.scenario_tick(ja, s, zone_block=zb))(scen))


def _compare(jo, to, label):
    for k in EXACT:
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=f"{label}: {k}")
    d = np.abs(np.asarray(jo["trajs"], np.float64)
               - to["trajs"].numpy().astype(np.float64))
    d_pos = float(d[..., 0:3].max())
    d_vx = float(d[..., 5].max())
    print(f"{label}: max |d x,y,s| = {d_pos:.3g} m, max |d vx| = "
          f"{d_vx:.3g} m/s")
    assert d_pos <= 2e-3 and d_vx <= 0.02, (label, d_pos, d_vx)
    assert to["trajs"].dtype == torch.float32


def _scenarios(ja, lat, batch, seed, **kw):
    js = jsc.random_scenarios(ja, batch, seed=seed, **kw)
    ts = tsc.random_scenarios(lat, batch, seed=seed, device="cpu", **kw)
    return js, ts


def test_random_scenarios_bit_equal(oval):
    ja, lat = oval
    for kw in (dict(n_objects=1), dict(n_objects=3, o_pad=16),
               dict(n_objects=2, n_pred=2, steady_state=False)):
        js, ts = _scenarios(ja, lat, 6, 4, **kw)
        for f in dataclasses.fields(jsc.Scenario):
            a = np.asarray(getattr(js, f.name))
            b = getattr(ts, f.name).numpy()
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_tick_oval_one_opponent_and_zones(oval):
    ja, lat = oval
    js, ts = _scenarios(ja, lat, 8, 0, n_objects=1)
    jt = _jax_tick(ja)
    zone0 = np.zeros((lat.L, lat.N), bool)
    jo = jt(js, zone0)
    to = tsc.make_batched_tick(lat, device="cpu")(ts)
    _compare(jo, to, "oval B=8 1 opponent")
    assert to["trajs"].shape == (8, tsc.N_OUT, tsc.C_PAD + 320, 7)

    # a shared zone mask blocking the raceline node (and its neighbours)
    # a few layers ahead of every scenario
    zone = np.zeros((lat.L, lat.N), bool)
    rl = lat.rl_idx.numpy()
    for sl in ts.start_layer.numpy():
        lay = (int(sl) + 3) % lat.L
        zone[lay, max(rl[lay] - 1, 0):rl[lay] + 2] = True
    jo = jt(js, zone)
    to = tsc.make_batched_tick(lat, device="cpu",
                               zone_block=torch.from_numpy(zone))(ts)
    _compare(jo, to, "oval B=8 shared zone")


def test_tick_oval_three_opponents(oval):
    ja, lat = oval
    # seed 2 holds a projection knife-edge (a follow target on the bisector
    # of two path segments, where 1-ulp geometry differences between the
    # frameworks pick either segment); see ROADMAP.md, section 3
    js, ts = _scenarios(ja, lat, 8, 0, n_objects=3, o_pad=16)
    jo = _jax_tick(ja)(js, np.zeros((lat.L, lat.N), bool))
    to = tsc.make_batched_tick(lat, device="cpu")(ts)
    _compare(jo, to, "oval B=8 3 opponents o_pad=16")


def test_tick_unclosed_monteblanco():
    ja = jax_unclosed()
    lat = carry(ja)
    assert not lat.closed
    js, ts = _scenarios(ja, lat, 4, 1, n_objects=1)
    jo = _jax_tick(ja)(js, np.zeros((lat.L, lat.N), bool))
    to = tsc.make_batched_tick(lat, device="cpu")(ts)
    _compare(jo, to, "unclosed Monteblanco B=4")


MACHINES_4 = np.array([[0.0, 7.0], [20.0, 6.0], [45.0, 4.5], [80.0, 3.0]],
                      np.float32)
PHYSICS = {
    "exp1.5_machines4": dict(dyn_model_exp=1.5, machines=MACHINES_4),
    "gg12x9_vmax55": dict(gg_lim=(12.0, 9.0), vel_max=55.0),
    "drag1.1_m1200": dict(drag_coeff=1.1, m_veh=1200.0),
}


@pytest.mark.parametrize("name", list(PHYSICS))
def test_tick_nondefault_physics(oval, name):
    """The tick at other vehicle and friction parameters: small oval, B=8,
    seed 0, 1 opponent."""
    ja, lat = oval
    kw = PHYSICS[name]
    js, ts = _scenarios(ja, lat, 8, 0, n_objects=1)
    jkw, tkw = dict(kw), dict(kw)
    if "machines" in kw:
        jkw["machines"] = jnp.asarray(kw["machines"])
        tkw["machines"] = torch.from_numpy(kw["machines"])
    jo = jax.jit(lambda scen: jax.vmap(
        lambda s: jsc.scenario_tick(ja, s, **jkw))(scen))(js)
    to = tsc.make_batched_tick(lat, device="cpu", **tkw)(ts)
    _compare(jo, to, f"oval B=8 {name}")
