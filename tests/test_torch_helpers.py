"""PyTorch port, the helpers of ``ops/`` and ``models/lattice.py`` that the
fleet tick and the facade do not call: each against its JAX function on
seeded inputs (the port's forms take leading batch axes; the JAX ones run
row by row).  Velocity profiles within ``VEL_TOL`` m/s (the two frameworks
round the same recurrences differently: XLA on the CPU contracts
multiply-adds), the rest exact or within float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import collision as jcol
from graphbasedlocaltrajectoryplanner_tpu.ops import projection as jproj
from graphbasedlocaltrajectoryplanner_tpu.ops import search as jsrch
from graphbasedlocaltrajectoryplanner_tpu.ops import splines as jspl
from graphbasedlocaltrajectoryplanner_tpu.ops import velocity as jvel
from graphbasedlocaltrajectoryplanner_torch.ops import collision as tcol
from graphbasedlocaltrajectoryplanner_torch.ops import projection as tproj
from graphbasedlocaltrajectoryplanner_torch.ops import search as tsrch
from graphbasedlocaltrajectoryplanner_torch.ops import splines as tspl
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as tvel

from torch_port_common import carry, jax_small_oval

VEL_TOL = 1e-3          # m/s
MACHINES = np.array([[0.0, 5.0], [30.0, 4.0], [70.0, 2.0]], np.float32)
CTRL = {"c_p": 1.25, "k_d": 0.025, "k_p": 0.2, "tan_w": 15.0}


def _t(x):
    return torch.from_numpy(np.array(x))


def _paths(R, P, seed, n_valid=None):
    """R seeded paths of P points: curvature with a corner, 2.5 m
    elements, zero element lengths from ``n_valid - 1`` on, a local gg
    that varies along the path."""
    rng = np.random.default_rng(seed)
    kappa = rng.normal(0.0, 0.01, (R, P)).astype(np.float32)
    kappa[:, P // 4:P // 4 + 6] = 0.04
    el = np.full((R, P), 2.5, np.float32)
    if n_valid is not None:
        for r, n in enumerate(n_valid):
            el[r, n - 1:] = 0.0
    gg = np.stack([rng.uniform(8.0, 11.0, (R, P)),
                   rng.uniform(8.0, 11.0, (R, P))], axis=-1).astype(
        np.float32)
    return kappa, el, gg


def _vel_err(label, got, want):
    d = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
    print(f"{label}: max |d v| = {d:.3g} m/s")
    assert d <= VEL_TOL, (label, d)


FB_CASES = {
    "exp1": dict(exp=1.0, v_end=None, end=None),
    "exp1.5_vend": dict(exp=1.5, v_end=[12.0, 0.0, 25.0], end=[70, 90, 120]),
}


@pytest.mark.parametrize("name", list(FB_CASES))
def test_calc_vel_profile_fb_matches_jax(name):
    c = FB_CASES[name]
    R, P = 3, 120
    kappa, el, gg = _paths(R, P, seed=1, n_valid=c["end"])
    v_start = np.array([5.0, 30.0, 55.0], np.float32)
    got = tvel.calc_vel_profile_fb(
        _t(kappa), _t(el), _t(gg), _t(MACHINES), 60.0, _t(v_start),
        v_end=None if c["v_end"] is None else _t(np.float32(c["v_end"])),
        dyn_model_exp=c["exp"], end_idx=None if c["end"] is None
        else _t(np.array(c["end"])))
    assert got.shape == (R, P) and got.dtype == torch.float32
    for r in range(R):
        want = jvel.calc_vel_profile_fb(
            jnp.asarray(kappa[r]), jnp.asarray(el[r]), jnp.asarray(gg[r]),
            jnp.asarray(MACHINES), 60.0, v_start[r],
            v_end=None if c["v_end"] is None else c["v_end"][r],
            dyn_model_exp=c["exp"],
            end_idx=None if c["end"] is None else c["end"][r])
        _vel_err(f"fb {name} row {r}", got[r].numpy(), want)


def test_calc_vel_profile_brake_matches_jax():
    kappa, el, gg = _paths(4, 100, seed=2, n_valid=[100, 60, 80, 100])
    v_start = np.array([40.0, 10.0, 65.0, 0.0], np.float32)
    for exp in (1.0, 2.0):
        got = tvel.calc_vel_profile_brake(_t(kappa), _t(el), _t(gg),
                                          _t(v_start), dyn_model_exp=exp)
        want = jax.vmap(lambda k, e, g, v: jvel.calc_vel_profile_brake(
            k, e, g, v, exp))(jnp.asarray(kappa), jnp.asarray(el),
                              jnp.asarray(gg), jnp.asarray(v_start))
        _vel_err(f"brake exp {exp}", got.numpy(), want)
        # a (2, 2) batch of the same rows
        got4 = tvel.calc_vel_profile_brake(
            _t(kappa).reshape(2, 2, -1), _t(el).reshape(2, 2, -1),
            _t(gg).reshape(2, 2, -1, 2), _t(v_start).reshape(2, 2),
            dyn_model_exp=exp)
        assert torch.equal(got4.reshape(4, -1), got)


FOLLOW_CASES = {
    # (v_start, v_ego, v_obj, obj_dist, opp_stop_dist, opp_vel_at)
    "closing_in": (40.0, 40.0, 20.0, 80.0, 60.0, 18.0),
    "far_ahead": (25.0, 25.0, 30.0, 160.0, 90.0, 28.0),
    "too_close": (30.0, 30.0, 10.0, 25.0, 15.0, 9.0),
}


@pytest.mark.parametrize("name", list(FOLLOW_CASES))
def test_calc_vel_profile_follow_matches_jax(name):
    vs, ve, vo, od, osd, ova = FOLLOW_CASES[name]
    kappa, el, gg = _paths(2, 110, seed=3, n_valid=[110, 95])
    got = tvel.calc_vel_profile_follow(
        _t(kappa), _t(el), _t(gg), _t(MACHINES), vs, ve, vo, 70.0, 30.0,
        4.7, od, osd, ova, CTRL)
    for r in range(2):
        want = jvel.calc_vel_profile_follow(
            jnp.asarray(kappa[r]), jnp.asarray(el[r]), jnp.asarray(gg[r]),
            jnp.asarray(MACHINES), vs, ve, vo, 70.0, 30.0, 4.7, od, osd, ova,
            CTRL)
        _vel_err(f"follow {name} row {r}", got[0][r].numpy(), want[0])
        assert bool(got[1][r]) == bool(want[1]), "too_close"
        assert bool(got[2][r]) == bool(want[2]), "vel_bound_ok"
        np.testing.assert_allclose(float(got[3][r]), float(want[3]),
                                   rtol=1e-6, err_msg="v_control")
        np.testing.assert_allclose(float(got[4][r]), float(want[4]),
                                   rtol=1e-6, err_msg="control_d")


def _scan_rows(rng, R, T, modes):
    kappa = np.abs(rng.normal(0, 0.02, (R, T))).astype(np.float32)
    ax = np.full((R, T), 10.0, np.float32)
    ds = np.where(rng.random((R, T)) < 0.9, 2.5, 0.0).astype(np.float32)
    vlim = np.clip(rng.normal(40, 15, (R, T)), 3, 70).astype(np.float32)
    vlim = np.where(np.asarray(modes)[:, None] == tvel.MODE_BRAKE, np.inf,
                    vlim).astype(np.float32)
    vinit = np.clip(rng.normal(30, 10, R), 1, 60).astype(np.float32)
    return kappa, ax, ds, vlim, vinit, np.asarray(modes, np.int32)


@pytest.mark.parametrize("sweeps,T", [(6, 200), (12, 200), (12, 37)])
def test_stacked_vel_scan_assoc_matches_jax(sweeps, T):
    """The associative-scan form, its own combine in jax.lax's recursion,
    against JAX's; at 12 sweeps both reach the sequential recurrence."""
    rng = np.random.default_rng(3)
    modes = [0, 1, 2] * 4 + [0]
    k, ax, ds, vlim, vinit, mode = _scan_rows(rng, len(modes), T, modes)
    args = (k, ax, ax, k, ax, ax, ds, vlim, vinit, mode)
    got = tvel.stacked_vel_scan_assoc(
        *map(_t, args), _t(MACHINES), 1.0, 0.85, 1000.0, sweeps=sweeps)
    want = jvel.stacked_vel_scan_assoc(
        *map(jnp.asarray, args), jnp.asarray(MACHINES), 1.0, 0.85, 1000.0,
        sweeps=sweeps)
    assert got.shape == (len(modes), T + 1)
    _vel_err(f"assoc {sweeps} sweeps T={T}", got.numpy(), want)
    if sweeps == 12:
        seq = tvel.stacked_vel_scan(*map(_t, args), _t(MACHINES), 1.0, 0.85,
                                    1000.0)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=5e-3)


def _rand_path(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.uniform(2.0, 6.0, (n, 2)), axis=0)


def test_sample_chain_stepnum_matches_jax():
    paths = [_rand_path(5, seed=s) for s in (4, 5)]
    steps = [np.array([4, 3, 5, 2]), np.array([2, 6, 1, 3])]
    coeffs = [jspl.fit_clamped_chain(jnp.asarray(p, jnp.float32), 0.1, -0.2)
              for p in paths]
    total = 15
    got = tspl.sample_chain_stepnum(
        torch.stack([_t(np.asarray(c)) for c in coeffs]),
        _t(np.stack(steps)), total)
    for b in range(2):
        want = jspl.sample_chain_stepnum(coeffs[b], steps[b], total)
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(want[0]),
                                   atol=1e-5, rtol=0)
        # one chain alone gives the same rows
        one = tspl.sample_chain_stepnum(_t(np.asarray(coeffs[b])),
                                        _t(steps[b]), total)
        assert torch.equal(one[0], got[0][b])


@pytest.mark.parametrize("closed", [False, True])
def test_dense_calc_splines_np_matches_jax(closed):
    path = _rand_path(7, seed=6)
    kw = dict(psi_s=0.3, psi_e=-0.4)
    if closed:
        path = np.vstack([path, path[:1]])
        kw = {}
    got = tspl.dense_calc_splines_np(path, **kw)
    want = jspl.dense_calc_splines_np(path, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the golden agrees with the port's own clamped chain fit
    if not closed:
        c = tspl.fit_clamped_chain(_t(path), torch.tensor(kw["psi_s"]),
                                   torch.tensor(kw["psi_e"]))
        np.testing.assert_allclose(c[..., 0].numpy(), got[0], atol=1e-6)
        np.testing.assert_allclose(c[..., 1].numpy(), got[1], atol=1e-6)


def test_closest_object_matches_jax():
    rng = np.random.default_rng(7)
    L, B, O = 30, 40, 5
    obj_layer = rng.integers(0, L, (B, O)).astype(np.int32)
    active = rng.random((B, O)) < 0.7
    start = rng.integers(0, L, B).astype(np.int32)
    h_goal = rng.integers(3, 15, B).astype(np.int32)
    idx, dist, found = tcol.closest_object(_t(obj_layer), _t(active),
                                           _t(start), _t(h_goal), L)
    assert idx.dtype == torch.int32
    for b in range(B):
        wi, wd, wf = jcol.closest_object(
            jnp.asarray(obj_layer[b]), jnp.asarray(active[b]),
            int(start[b]), int(h_goal[b]), L)
        assert bool(found[b]) == bool(wf)
        assert int(idx[b]) == int(wi) and int(dist[b]) == int(wd), b
    # the wrap-around case of the JAX package's own test, scalar arguments
    i, d, f = tcol.closest_object(torch.tensor([2, 28]),
                                  torch.tensor([True, True]), 29, 10, L)
    assert bool(f) and int(i) == 0 and int(d) == 3


def test_path_hits_objects_matches_jax():
    rng = np.random.default_rng(8)
    B, P, O = 6, 30, 4
    path = np.cumsum(rng.normal(0.0, 1.0, (B, P, 2)), axis=1).astype(
        np.float32)
    valid = np.arange(P)[None, :] < rng.integers(5, P, B)[:, None]
    obj = (path[:, rng.integers(0, P, O)]
           + rng.normal(0.0, 2.5, (B, O, 2))).astype(np.float32)
    rad = rng.uniform(0.5, 2.5, (B, O)).astype(np.float32)
    act = rng.random((B, O)) < 0.8
    got = tcol.path_hits_objects(_t(path), _t(valid), _t(obj), _t(rad),
                                 _t(act), 1.9)
    want = jax.vmap(lambda *a: jcol.path_hits_objects(*a, 1.9))(
        *map(jnp.asarray, (path, valid, obj, rad, act)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    return ja, carry(ja)


def test_check_inside_bounds_matches_jax(oval):
    ja, lat = oval
    refline = np.asarray(ja.refline)
    normvec = np.asarray(ja.normvec)
    wr = np.asarray(ja.track_width_right)[:, None]
    wl = np.asarray(ja.track_width_left)[:, None]
    bound1 = (refline + normvec * wr).astype(np.float32)
    bound2 = (refline - normvec * wl).astype(np.float32)
    rng = np.random.default_rng(9)
    i = rng.integers(0, len(refline), 64)
    off = rng.uniform(-1.6, 1.6, 64)[:, None] * np.maximum(wr[i], wl[i])
    pos = (refline[i] + normvec[i] * off).astype(np.float32)
    got = tproj.check_inside_bounds(_t(bound1), _t(bound2), _t(pos))
    want = jax.vmap(lambda p: jproj.check_inside_bounds(
        jnp.asarray(bound1), jnp.asarray(bound2), p))(jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < 64


def _window(H=8, N=6, seed=0, p_edge=0.7):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1.0, 10.0, (H, N, N)).astype(np.float32)
    w = np.where(rng.uniform(size=(H, N, N)) < p_edge, w,
                 np.float32(tsrch.INF)).astype(np.float32)
    vg = rng.uniform(0.0, 5.0, (H + 1, N)).astype(np.float32)
    return w, vg


def test_dijkstra_window_np_matches_jax_and_the_dp():
    for seed in range(6):
        w, vg = _window(seed=seed, p_edge=0.35 if seed == 5 else 0.7)
        start, h_goal = seed % 6, 8
        got = tsrch.dijkstra_window_np(w, start, vg, h_goal)
        want = jsrch.dijkstra_window_np(w, start, vg, h_goal)
        assert got == want, seed
        out = tsrch.search_window(_t(w)[None], torch.tensor([start]),
                                  _t(vg)[None], torch.tensor([h_goal]),
                                  shrink_horizon=False)
        if got[0] is None:
            assert not bool(out["feasible"][0])
        else:
            assert bool(out["feasible"][0])
            assert abs(float(out["cost"][0]) - got[1]) < 1e-3


def test_edge_coeffs_matches_jax(oval):
    ja, lat = oval
    ev = np.asarray(ja.edge_valid)
    rl = np.asarray(ja.rl_idx)
    ls, ns, ms = np.nonzero(ev)
    pick = np.random.default_rng(10).choice(len(ls), 40, replace=False)
    # raceline edges reuse the raceline spline
    l_rl = np.arange(5)
    ls = np.concatenate([ls[pick], l_rl])
    ns = np.concatenate([ns[pick], rl[l_rl]])
    ms = np.concatenate([ms[pick], rl[(l_rl + 1) % ja.L]])
    got = lat.edge_coeffs(_t(ls), _t(ns), _t(ms))
    assert got.shape == (len(ls), 4, 2)
    for i in range(len(ls)):
        want = np.asarray(ja.edge_coeffs(int(ls[i]), int(ns[i]), int(ms[i])))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-4,
                                   rtol=1e-6, err_msg=str(i))
    assert torch.equal(lat.edge_coeffs(int(ls[0]), int(ns[0]), int(ms[0])),
                       got[0])
    assert torch.equal(got[-5:], lat.raceline_coeffs[_t(l_rl)])
