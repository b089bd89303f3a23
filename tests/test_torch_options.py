"""PyTorch port, the options of the fleet tick (``make_batched_tick`` /
``scenario_tick``): ``filt_window``, ``incl_emergency``, ``p_max``,
``until``, ``precomputed``.  The port's tick on the CPU against the JAX
package's XLA tick (``make_batched_tick(use_pallas=False)``) on the same
carried-across small oval and seeded scenarios, with the bars of
``tests/test_torch_tick.py``: the exact fields equal, trajectories within
2 mm and 0.02 m/s (measured maxima printed and in the assert message).
Four JAX compiles in all: the three fb options together, each ``until``
cutoff, and the sqp tick with ``filt_window=5``; the options one by one
are held against the port's own default tick."""

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc

from torch_port_common import carry, jax_small_oval

EXACT = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel", "em_base")
B = 6


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    lat = carry(ja)
    js = jsc.random_scenarios(ja, B, seed=0, n_objects=1)
    ts = tsc.random_scenarios(lat, B, seed=0, device="cpu")
    # the port's default tick, the reference of the one-option checks
    base = tsc.make_batched_tick(lat, device="cpu")(ts)
    return dict(ja=ja, lat=lat, js=js, ts=ts, base=base,
                p_max=tsc.default_p_max(lat))


def _jax(o, **kw):
    return jsc.make_batched_tick(o["ja"], use_pallas=False, **kw)(o["js"])


def _compare(jo, to, label, exact=EXACT, traj="trajs"):
    for k in exact:
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=f"{label}: {k}")
    d = np.abs(np.asarray(jo[traj], np.float64)
               - to[traj].numpy().astype(np.float64))
    if traj == "trajs":
        d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
    else:
        d_pos, d_vx = float(d[..., 0:2].max()), 0.0
    print(f"{label}: max |d pos| = {d_pos:.3g} m, max |d vx| = "
          f"{d_vx:.3g} m/s")
    assert d_pos <= 2e-3 and d_vx <= 0.02, (label, d_pos, d_vx)


def test_fb_options_match_jax(oval):
    """filt_window=5, incl_emergency=False and p_max = default + 64 in one
    tick of each package."""
    kw = dict(filt_window=5, incl_emergency=False, p_max=oval["p_max"] + 64)
    jo = _jax(oval, **kw)
    to = tsc.make_batched_tick(oval["lat"], device="cpu", **kw)(oval["ts"])
    assert to["trajs"].shape == (B, 4, tsc.C_PAD + oval["p_max"] + 64, 7)
    _compare(jo, to, "oval B=6 filt_window=5, 4 slots, p_max+64")


def test_incl_emergency_false_is_the_first_four_slots(oval):
    to = tsc.make_batched_tick(oval["lat"], device="cpu",
                               incl_emergency=False)(oval["ts"])
    base = oval["base"]
    for k in ("trajs", "valid", "cost", "h_eff", "n_valid"):
        assert torch.equal(to[k], base[k][:, :4]), k
    for k in ("case_a", "relabel", "em_base"):
        assert torch.equal(to[k], base[k]), k


def test_filt_window_smooths_the_fb_profiles(oval):
    to = tsc.make_batched_tick(oval["lat"], device="cpu",
                               filt_window=5)(oval["ts"])
    base = oval["base"]
    for k in EXACT:
        assert torch.equal(to[k], base[k]), k
    # positions are untouched, the velocity profiles are smoothed
    assert torch.equal(to["trajs"][..., :5], base["trajs"][..., :5])
    assert not torch.equal(to["trajs"][:, :4, :, 5],
                           base["trajs"][:, :4, :, 5])
    with pytest.raises(ValueError, match="odd"):
        tsc.make_batched_tick(oval["lat"], device="cpu",
                              filt_window=4)(oval["ts"])


def test_p_max_pads_every_row_output(oval):
    p = oval["p_max"] + 64
    to = tsc.make_batched_tick(oval["lat"], device="cpu", p_max=p)(
        oval["ts"])
    base = oval["base"]
    P0 = tsc.C_PAD + oval["p_max"]
    assert to["trajs"].shape[2] == tsc.C_PAD + p
    for k in EXACT:
        assert torch.equal(to[k], base[k]), k
    d = (to["trajs"][:, :, :P0, :5] - base["trajs"][..., :5]).abs().max()
    assert float(d) == 0.0
    # the extra rows repeat the last real row's position
    assert torch.equal(to["trajs"][:, :, P0:, 1:3],
                       to["trajs"][:, :, P0 - 1:P0, 1:3].expand(
                           -1, -1, p - oval["p_max"], -1))


@pytest.mark.parametrize("until", ["decide", "assembly"])
def test_until_matches_jax(oval, until):
    jo = _jax(oval, until=until)
    to = tsc.make_batched_tick(oval["lat"], device="cpu", until=until)(
        oval["ts"])
    assert set(to) == set(jo)
    if until == "decide":
        _compare(jo, to, "until=decide", exact=("src", "h_eff", "valid"),
                 traj="h_eff")
        assert to["src"].shape == (B, 4)
    else:
        _compare(jo, to, "until=assembly",
                 exact=("n_valid", "cost", "h_eff", "valid"), traj="paths")
        assert to["paths"].shape == (B, 4, tsc.C_PAD + oval["p_max"], 5)


def test_until_and_precomputed_agree_with_the_full_tick(oval):
    lat, ts, base = oval["lat"], oval["ts"], oval["base"]
    dec = tsc.scenario_tick(lat, ts, until="decide")
    asm = tsc.scenario_tick(lat, ts, until="assembly")
    assert torch.equal(dec["h_eff"], base["h_eff"][:, :4])
    assert torch.equal(asm["h_eff"], base["h_eff"][:, :4])
    assert torch.equal(asm["cost"], base["cost"][:, :4])
    assert torch.equal(asm["n_valid"], base["n_valid"][:, :4])
    assert torch.equal(asm["paths"][..., 0:2], base["trajs"][:, :4, :, 1:3])
    # the velocity stage only ever removes overtake actions
    assert bool((base["valid"][:, :4] <= asm["valid"]).all())
    zone = torch.zeros((lat.L, lat.N), dtype=torch.bool)
    w_last = torch.tensor([0.0, 0.5, 0.8])
    obs, window = tsc._batched_window(lat, ts, zone, w_last)
    pre = tsc.scenario_tick(lat, ts, precomputed=dict(obs=obs,
                                                      window=window))
    for k in base:
        assert torch.equal(pre[k], base[k]), k


def test_sqp_ignores_filt_window(oval):
    """Under vp_backend="sqp" neither package smooths: the port's tick is
    the same with filt_window 5 and 1, and within the bars of the JAX sqp
    tick with filt_window=5."""
    kw = dict(vp_backend="sqp", sqp_m=115)
    jo = _jax(oval, filt_window=5, **kw)
    lat, ts = oval["lat"], oval["ts"]
    to5 = tsc.make_batched_tick(lat, device="cpu", filt_window=5, **kw)(ts)
    to1 = tsc.make_batched_tick(lat, device="cpu", **kw)(ts)
    for k in to1:
        assert torch.equal(to5[k], to1[k]), k
    _compare(jo, to5, "sqp filt_window=5", exact=EXACT + ("qp_status",))
