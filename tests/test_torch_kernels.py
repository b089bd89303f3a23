"""PyTorch port, the plain versions of the five CUDA kernels against the
JAX package: hit masks, window DP, backtrace and the stacked velocity
scan, each on the same numpy-seeded inputs (the Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import search as jsearch
from graphbasedlocaltrajectoryplanner_tpu.ops import velocity as jvel
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_collision import (
    build_samples_t, hit_slab_pallas)
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_window import (
    fused_window_dp as jax_fused_window_dp)
from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as tvel
from graphbasedlocaltrajectoryplanner_torch.ops.cuda_backtrace import (
    backtrace_walk)
from graphbasedlocaltrajectoryplanner_torch.ops.cuda_collision import (
    hit_slab)
from graphbasedlocaltrajectoryplanner_torch.ops.cuda_window import (
    fused_window_dp)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg

from torch_port_common import carry, jax_small_oval

B = 8


@pytest.fixture(scope="module")
def setup():
    """Small oval, B scenarios with 3 opponents (16 slots), their obstacle
    selection and window metadata — JAX and port on identical inputs."""
    ja = jax_small_oval()
    lat = carry(ja)
    js = jsc.random_scenarios(ja, B, seed=3, n_objects=3, o_pad=16)
    ts = tsc.random_scenarios(lat, B, seed=3, n_objects=3, o_pad=16,
                              device="cpu")
    obs = tsc._select_obstacle(lat, ts)
    pre = tpg.window_prelude(lat, ts.start_layer, ts.obj_pos, ts.obj_radius,
                             ts.obj_active, obs["obs_layer"],
                             obs["obs_node"], obs["obs_found"])
    return ja, lat, js, ts, obs, pre


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_select_obstacle_matches_jax(setup):
    ja, lat, js, ts, obs, _ = setup
    for b in range(B):
        one = jsc.Scenario(**{k: getattr(js, k)[b] for k in
                              jsc.Scenario.__dataclass_fields__})
        ref = jsc._select_obstacle(ja, one)
        for k in ("obs_idx", "obs_layer", "obs_node", "obs_found"):
            assert int(_np(ref[k])) == int(obs[k][b]), (b, k)


def test_hit_slab_matches_jax(setup):
    ja, lat, js, ts, obs, pre = setup
    got = hit_slab(lat.samples_xy, pre["slab_layers"], ts.obj_pos,
                   pre["ref2"], pre["obj_app"]).numpy()
    refs = []
    for b in range(B):
        r = jpg.window_prelude(
            ja, js.start_layer[b], js.obj_pos[b], js.obj_radius[b],
            js.obj_active[b], jnp.int32(int(obs["obs_layer"][b])),
            jnp.int32(int(obs["obs_node"][b])),
            jnp.bool_(bool(obs["obs_found"][b])))
        refs.append(r)
        for k in ("slab_layers", "p_obs", "in_win", "obj_app", "ref2"):
            np.testing.assert_array_equal(_np(r[k]), _np(pre[k][b]),
                                          err_msg=k)
        np.testing.assert_array_equal(_np(r["hit_slab"]), got[b])
    pallas = hit_slab_pallas(
        build_samples_t(ja.samples_xy),
        jnp.stack([r["slab_layers"] for r in refs]), js.obj_pos,
        jnp.stack([r["ref2"] for r in refs]),
        jnp.stack([r["obj_app"] for r in refs]), interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), got)
    assert got.any()


@pytest.mark.parametrize("zones", ["shared", "per_scenario"])
def test_window_dp_matches_jax(setup, zones):
    ja, lat, js, ts, obs, pre = setup
    rng = np.random.default_rng(11)
    if zones == "shared":
        zb = np.zeros((lat.L, lat.N), bool)
        zb[5:8, : lat.N // 2] = True
    else:
        zb = rng.random((B, lat.L, lat.N)) < 0.05
    last = np.asarray(js.last_nodes).copy()
    last[::3, 2:] = -1                     # a few chains end early
    w_fac = np.array([0.3, 0.6, 0.9], np.float32)
    best, bp = fused_window_dp(
        lat.w, torch.from_numpy(zb), ts.start_layer, ts.start_node,
        pre["slab_layers"], pre["hit_slab"], pre["p_obs"], pre["in_win"],
        obs["obs_node"], torch.from_numpy(last), torch.from_numpy(w_fac),
        closed=bool(lat.closed), h_max=int(lat.H_max))
    best, bp = best.numpy(), bp.numpy()
    for b in range(B):
        ref = jpg.plan_window_kernel(
            ja, js.start_layer[b], js.start_node[b],
            jnp.asarray(zb if zones == "shared" else zb[b]),
            js.obj_pos[b], js.obj_radius[b], js.obj_active[b],
            jnp.int32(int(obs["obs_layer"][b])),
            jnp.int32(int(obs["obs_node"][b])),
            jnp.bool_(bool(obs["obs_found"][b])),
            jnp.asarray(last[b]), jnp.asarray(w_fac), n_last=4)
        np.testing.assert_array_equal(np.asarray(ref["best"]), best[b])
        np.testing.assert_array_equal(np.asarray(ref["bp"]), bp[b])
    pbest, pbp = jax_fused_window_dp(
        ja.w, jnp.asarray(zb), js.start_layer, js.start_node,
        jnp.asarray(pre["slab_layers"].numpy()),
        jnp.asarray(pre["hit_slab"].numpy()),
        jnp.asarray(pre["p_obs"].numpy()), jnp.asarray(pre["in_win"].numpy()),
        jnp.asarray(obs["obs_node"].numpy()), jnp.asarray(last),
        jnp.asarray(w_fac), closed=bool(ja.closed), h_max=int(ja.H_max),
        interpret=True)
    np.testing.assert_array_equal(np.asarray(pbest), best)
    np.testing.assert_array_equal(np.asarray(pbp), bp)


def test_window_dp_open_track_blocks_off_end():
    """On an unclosed track every step past the last layer is blocked."""
    from torch_port_common import jax_unclosed
    ja = jax_unclosed()
    lat = carry(ja)
    ts = tsc.random_scenarios(lat, 4, seed=5, device="cpu")
    ts.start_layer[:] = torch.tensor([lat.L - 3, lat.L - 1, 0, 7],
                                     dtype=torch.int32)
    ts.start_node[:] = lat.rl_idx[ts.start_layer.long()]
    obs = tsc._select_obstacle(lat, ts)
    pre = tpg.window_meta(lat, ts.start_layer, ts.obj_pos, ts.obj_radius,
                          ts.obj_active, obs["obs_layer"], obs["obs_node"],
                          obs["obs_found"])
    hit = hit_slab(lat.samples_xy, pre["slab_layers"], ts.obj_pos,
                   pre["ref2"], pre["obj_app"])
    best, bp = fused_window_dp(
        lat.w, torch.zeros((lat.L, lat.N), dtype=torch.bool),
        ts.start_layer, ts.start_node, pre["slab_layers"], hit,
        pre["p_obs"], pre["in_win"], obs["obs_node"], ts.last_nodes,
        torch.tensor([0.0, 0.5, 0.8]), closed=False, h_max=int(lat.H_max))
    for b in range(4):
        ref = jpg.plan_window_kernel(
            ja, jnp.int32(int(ts.start_layer[b])),
            jnp.int32(int(ts.start_node[b])),
            jnp.zeros((lat.L, lat.N), bool), jnp.asarray(ts.obj_pos[b]),
            jnp.asarray(ts.obj_radius[b]), jnp.asarray(ts.obj_active[b]),
            jnp.int32(int(obs["obs_layer"][b])),
            jnp.int32(int(obs["obs_node"][b])),
            jnp.bool_(bool(obs["obs_found"][b])),
            jnp.asarray(ts.last_nodes[b]),
            jnp.array([0.0, 0.5, 0.8], jnp.float32), n_last=4)
        np.testing.assert_array_equal(np.asarray(ref["best"]),
                                      best[b].numpy())
        np.testing.assert_array_equal(np.asarray(ref["bp"]), bp[b].numpy())
    # from the last layer nothing is reachable
    assert bool((best[1, :, 1:] >= 1e29).all())


def test_backtrace_matches_jax():
    rng = np.random.default_rng(7)
    R, Hp1, N = 64, 21, 24
    bp = rng.integers(0, N, (R, Hp1, N)).astype(np.int32)
    bp[:, 0] = -1
    goal = rng.integers(0, N, R).astype(np.int32)
    h_eff = rng.integers(1, Hp1, R).astype(np.int32)
    got = backtrace_walk(torch.from_numpy(bp), torch.from_numpy(goal),
                         torch.from_numpy(h_eff)).numpy()
    assert got.dtype == np.int32
    ref = jax.jit(jax.vmap(jsearch.backtrace))(
        jnp.asarray(bp), jnp.asarray(h_eff), jnp.asarray(goal))
    np.testing.assert_array_equal(np.asarray(ref), got)


def _vel_rows(rng, R, T, pad):
    modes = np.array([0, 1, 2] * (R // 3) + [0] * (R % 3), np.int32)
    kappa = np.abs(rng.normal(0, 0.02, (R, T))).astype(np.float32)
    ax = rng.uniform(8, 12, (R, T)).astype(np.float32)
    ay = rng.uniform(8, 12, (R, T)).astype(np.float32)
    ds = np.where(rng.random((R, T)) < 0.9, 2.5, 0.0).astype(np.float32)
    vlim = np.clip(rng.normal(40, 15, (R, T)), 3, 70).astype(np.float32)
    vlim[modes == tvel.MODE_BRAKE] = np.inf
    if pad:
        # identity padding at the row ends: zero steps, no cap
        ds[:, T - pad:] = 0.0
        vlim[:, T - pad:] = np.inf
    vinit = np.clip(rng.normal(30, 10, R), 1, 60).astype(np.float32)
    return modes, kappa, ax, ay, ds, vlim, vinit


@pytest.mark.parametrize("exp", [1.0, 1.5])
def test_stacked_vel_scan_matches_jax(exp):
    rng = np.random.default_rng(0)
    R, T = 13, 447
    modes, kappa, ax, ay, ds, vlim, vinit = _vel_rows(rng, R, T, pad=40)
    kappa2 = np.roll(kappa, 1, axis=1)
    machines = np.array([[0.0, 5.0], [30.0, 4.0], [70.0, 2.0]], np.float32)
    ref = np.asarray(jvel.stacked_vel_scan(
        *[jnp.asarray(x) for x in (kappa, ax, ay, kappa2, ax, ay, ds, vlim,
                                   vinit, modes, machines)],
        exp, 0.85, 1000.0))
    t = torch.from_numpy
    got = tvel.stacked_vel_scan(
        *[t(x) for x in (kappa, ax, ay, kappa2, ax, ay, ds, vlim, vinit,
                         modes, machines)], exp, 0.85, 1000.0).numpy()
    assert got.shape == (R, T + 1)
    err = float(np.abs(got - ref).max())
    print(f"stacked_vel_scan exp={exp}: max |port - jax| = {err:.3g} m/s")
    # cross-framework: float32 sqrt/interp rounding carried over 447 steps
    assert err <= 1e-3
    # the padded tail leaves every row unchanged
    np.testing.assert_array_equal(got[:, -40:], got[:, -41:-40]
                                  .repeat(40, axis=1))
    # the constant-gg entry point on CPU is the same plain recurrence
    cgg = tvel.stacked_vel_scan_cgg_auto(
        t(kappa), t(kappa2), t(ds), t(vlim), t(vinit), t(modes),
        t(machines), exp, 0.85, 1000.0, 10.0, 9.0).numpy()
    ref_c = np.asarray(jvel.stacked_vel_scan_cgg_auto(
        jnp.asarray(kappa), jnp.asarray(kappa2), jnp.asarray(ds),
        jnp.asarray(vlim), jnp.asarray(vinit), jnp.asarray(modes),
        jnp.asarray(machines), exp, 0.85, 1000.0, 10.0, 9.0))
    assert float(np.abs(cgg - ref_c).max()) <= 1e-3


def test_one_row_machine_table():
    """A one-row machine table (the facade's default ``ax_max_machines``)
    is a constant acceleration, as ``np.interp`` reads it: the JAX package
    and the plain version agree, and the two-knot table the kernel's
    wrapper passes instead (``cuda_velocity.kernel_machines``) gives the
    plain version's result bit for bit."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velocity
    rng = np.random.default_rng(3)
    R, T = 9, 127
    modes, kappa, ax, ay, ds, vlim, vinit = _vel_rows(rng, R, T, pad=10)
    one = np.array([[100.0, 5.0]], np.float32)
    ref = np.asarray(jvel.stacked_vel_scan(
        *[jnp.asarray(x) for x in (kappa, ax, ay, kappa, ax, ay, ds, vlim,
                                   vinit, modes, one)], 1.0, 0.85, 1000.0))
    t = torch.from_numpy
    args = [t(x) for x in (kappa, ax, ay, kappa, ax, ay, ds, vlim, vinit,
                           modes)]
    got = tvel.stacked_vel_scan(*args, t(one), 1.0, 0.85, 1000.0)
    two = cuda_velocity.kernel_machines(t(one))
    assert two.shape == (2, 2) and two.is_contiguous()
    assert torch.equal(tvel.stacked_vel_scan(*args, two, 1.0, 0.85, 1000.0),
                       got)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-3
