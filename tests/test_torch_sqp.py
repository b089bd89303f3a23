"""PyTorch port, the SQP velocity backend (``vp_type=sqp``) on the CPU: the
port's window helpers, ``velocity_kernel``, ``velocity_stage_scenario``
(with its gg-stream fb branch), ``brake_em_sqp_kernel``, the fleet tick and
the interactive facade, each against the JAX package on the same inputs.

Gates: exact fields, action keys, node chains and QP status codes equal;
trajectories within the JAX package's cross-backend bar (2 mm in s, x, y,
0.02 m/s in vx).  The raw QP profiles (``vx_sqp``, the warm-start store)
are held to the same 0.02 m/s: XLA compiles the whole QP pipeline with
fused multiply-adds, which moves the JAX package's own profiles by a few
1e-3 m/s against the same arithmetic run op by op
(``tests/test_torch_qp.py`` prints that spread), so the port cannot sit
closer to the compiled reference than that.  Every test prints its
measured maxima.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_tpu.planner import velplan as jvp
from graphbasedlocaltrajectoryplanner_tpu.planner.facade import (
    GraphLTPL as JaxGraphLTPL)
from graphbasedlocaltrajectoryplanner_tpu.planner import handler as jhandler
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
from graphbasedlocaltrajectoryplanner_torch.planner import handler as thandler
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)

from torch_port_common import (UNCLOSED_CSV, carry, jax_small_oval)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFLINE_INI = os.path.join(ROOT, "params", "ltpl_config_offline.ini")
SQP_INI = os.path.join(ROOT, "parity", "fixtures",
                       "ltpl_config_online_sqp.ini")
TOL_POS, TOL_VX = 2e-3, 0.02
TICKS_OVAL = 25
# unclosed Monteblanco from layer 30 into the track end, where the track is
# blocked and the SQP ladder brakes on the backup path (ticks 52-56)
TICKS_UNCLOSED = 60
START_LAYER_UNCLOSED = 30
EXACT = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel", "em_base",
         "qp_status")


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _path_dict(tmp, track, store):
    return {"globtraj_input_path": track,
            "graph_store_path": os.path.join(tmp, store),
            "ltpl_offline_param_path": OFFLINE_INI,
            "ltpl_online_param_path": SQP_INI,
            "graph_log_id": "test",
            "log_path": os.path.join(tmp, "logs")}


@pytest.fixture(scope="module")
def oval_drive(tmp_path_factory):
    """The JAX facade under the SQP ini in closed loop on the oval with its
    opponent and zone, recorded, with its warm-start store after each
    tick."""
    tmp = str(tmp_path_factory.mktemp("sqp"))
    pd = _path_dict(tmp, "oval", "oval.npz")
    j = JaxGraphLTPL(pd, log_to_file=False)
    j.graph_init()
    lat = j.lattice
    pos, heading = cl.start_pose(np.asarray(lat.refline), 0)
    objs = cl.slow_opponent(np.asarray(lat.raceline), np.asarray(lat.normvec),
                            np.asarray(lat.s_rl))
    zones = cl.left_half_zone(np.asarray(lat.nodes_in_layer))
    states = []
    rec = cl.drive(j, TICKS_OVAL, pos, heading, objs, zones,
                   on_tick=lambda t: states.append(
                       {k: v.copy() for k, v in j._oth.sqp_state.items()}))
    return dict(pd=pd, lat=lat, pos=pos, heading=heading, zones=zones,
                rec=rec, states=states, tmp=tmp)


# ---- window helpers ---------------------------------------------------------

@pytest.mark.parametrize("l_real", [-1, 0, 1, 2, 3, 40, 115, 300])
def test_sqp_m_window(l_real):
    rng = np.random.default_rng(l_real + 10)
    P, m = 192, 115
    cols = rng.normal(size=(3, P, 4)).astype(np.float32)
    pref = np.array([0, 3, 64], np.int64)
    got = tvp._sqp_m_window(torch.from_numpy(cols), torch.from_numpy(pref),
                            torch.full((3,), l_real), m).numpy()
    for r in range(3):
        ref = np.asarray(jvp._sqp_m_window(jnp.asarray(cols[r]),
                                           jnp.int32(pref[r]),
                                           jnp.int32(l_real), m))
        np.testing.assert_array_equal(got[r], ref)


def test_sqp_follow_vmax():
    """Gap before, at and beyond the horizon; the depletion inside and
    outside the window; a standing opponent."""
    m = 115
    v_obj = np.array([9.0, 25.0, 0.0, 14.0, 30.0], np.float32)
    obj_dist = np.array([60.0, 400.0, 36.0, 20.0, 100.0], np.float32)
    axc = np.array([5.0, 8.0, 5.0, 0.5, 10.0], np.float32)
    got = tvp._sqp_follow_vmax(m, _f32(40.0), torch.from_numpy(v_obj),
                               torch.from_numpy(obj_dist), _f32(30.0),
                               _f32(4.7), torch.from_numpy(axc), 2.5).numpy()
    for r in range(len(v_obj)):
        ref = np.asarray(jvp._sqp_follow_vmax(
            m, jnp.float32(40.0), jnp.float32(v_obj[r]),
            jnp.float32(obj_dist[r]), jnp.float32(30.0), jnp.float32(4.7),
            jnp.float32(axc[r]), jnp.float32(2.5)))
        np.testing.assert_allclose(got[r], ref, rtol=1e-6, atol=1e-6)


# ---- velocity_kernel under sqp ----------------------------------------------

def _path_inputs(traj, P=448):
    """A recorded trajectory as the handler pads a cut path."""
    n = traj.shape[0]
    path = np.zeros((P, 5), np.float32)
    path[:n, 0:4] = traj[:, 1:5]
    path[:n - 1, 4] = np.diff(traj[:, 0])
    path[n:, 0:4] = traj[-1, 1:5]
    return path, n


def test_velocity_kernel_sqp_matches_jax(oval_drive):
    """Follow, straight, overtakes, a reduced horizon and a path of 5 cm
    steps on which the pinned 40 m/s start cannot be braked to the window's
    terminal velocity (status -3: the profile zeroed, the bound broken)."""
    rec = oval_drive["rec"]
    ja = oval_drive["lat"]
    lat = carry(ja)
    follow, n_f = _path_inputs(rec[15]["traj_set"]["follow"][0])
    straight, n_s = _path_inputs(rec[5]["traj_set"]["straight"][0])
    short = follow.copy()
    short[:n_f - 1, 4] = 0.05
    rng = np.random.default_rng(0)
    gg = rng.uniform(4.5, 5.5, (448, 2)).astype(np.float32)
    vc = np.zeros(448, np.float32)
    vc[:3] = rec[15]["traj_set"]["follow"][0][:3, 5]
    opp = rec[15]["objects"][0]
    opos = np.array([opp["X"], opp["Y"]], np.float32)
    j_opp = jvp.opponent_summary(ja.glob_rl, ja.glob_el, jnp.asarray(opos),
                                 jnp.float32(9.0), 1.0, 0.85, 1000.0)
    t_opp = tvp.opponent_summary(lat.glob_rl, lat.glob_el,
                                 torch.from_numpy(opos)[None],
                                 torch.tensor([9.0]), 1.0, 0.85, 1000.0)
    # (path, n, is_follow, red_len, v_end_rl, obj_dist, v_obj, overtake)
    rows = [(follow, n_f, True, False, 30.0, 60.0, 9.0, False),
            (straight, n_s, False, False, 30.0, 0.0, 0.0, False),
            (straight, n_s, False, False, 30.0, 0.0, 0.0, True),
            (follow, n_f, True, True, 25.0, 40.0, 9.0, False),
            (straight, n_s, False, True, 30.0, 0.0, 0.0, False),
            (short, n_f, False, False, 30.0, 0.0, 0.0, True),
            (short, n_f, True, False, 30.0, 80.0, 9.0, False)]
    x0 = (18.0 + 4.0 * np.sin(np.arange(448) / 17.0)).astype(np.float32)
    vel_plan, tire, tire_idx, m, step = 40.0, 5.0, 2, 115, 2.5
    ref = []
    for path, n, fol, red, v_end, od, vo, ot in rows:
        ref.append(jvp.velocity_kernel(
            jnp.asarray(path), jnp.int32(n), jnp.asarray(gg),
            jnp.asarray(vc), jnp.int32(3), jnp.float32(vel_plan),
            jnp.float32(vel_plan), jnp.float32(45.0), jnp.float32(0.9),
            jnp.float32(1.0), jnp.asarray(cl.MACHINES), jnp.float32(0.1),
            fol, red, jnp.float32(v_end), jnp.float32(od), jnp.float32(vo),
            jnp.float32(30.0), j_opp[0], j_opp[1], j_opp[3],
            jnp.float32(4.7), jnp.float32(1.25), jnp.float32(0.025),
            jnp.float32(0.2), jnp.float32(1.0), 1.0, 0.85, 1000.0,
            vp_backend="sqp", sqp_x0=jnp.asarray(x0), is_overtake=ot,
            veh_turn=jnp.float32(7.0), tire_end_idx=tire_idx,
            tire_end_mps2=jnp.float32(tire), sqp_m=m,
            sqp_step=jnp.float32(step)))
    R = len(rows)
    col = lambda k: [r[k] for r in rows]                     # noqa: E731
    out = tvp.velocity_kernel(
        torch.from_numpy(np.stack(col(0))), torch.tensor(col(1)),
        torch.from_numpy(gg)[None].expand(R, -1, -1), torch.from_numpy(vc),
        torch.tensor(3), _f32(vel_plan), _f32(vel_plan), _f32(45.0),
        _f32(0.9), _f32(1.0), torch.from_numpy(cl.MACHINES), _f32(0.1),
        torch.tensor(col(2)), torch.tensor(col(3)), _f32(col(4)),
        _f32(col(5)), _f32(col(6)), _f32(30.0), t_opp[0][0], t_opp[1][0],
        t_opp[3][0], _f32(4.7), _f32(1.25), _f32(0.025), _f32(0.2),
        _f32(1.0), 1.0, 0.85, 1000.0, vp_backend="sqp",
        sqp_x0=torch.from_numpy(x0)[None].expand(R, -1),
        is_overtake=torch.tensor(col(7)), veh_turn=_f32(7.0),
        tire_end_idx=tire_idx, tire_end_mps2=_f32(tire), sqp_m=m,
        sqp_step=step)
    d_pos = d_vx = d_raw = 0.0
    for r, o in enumerate(ref):
        for k in ("vel_bound", "too_close", "qp_status"):
            assert int(out[k][r]) == int(o[k]), (r, k)
        d = np.abs(out["traj"][r].numpy().astype(np.float64)
                   - np.asarray(o["traj"], np.float64))
        d_pos = max(d_pos, float(d[:, 0:3].max()))
        d_vx = max(d_vx, float(d[:, 5].max()))
        d_raw = max(d_raw, float(np.abs(out["vx_sqp"][r].numpy()
                                        - np.asarray(o["vx_sqp"])).max()))
    status = out["qp_status"].tolist()
    print(f"velocity_kernel sqp: status {status}, vel_bound "
          f"{out['vel_bound'].tolist()}; max |d s,x,y| = {d_pos:.3g} m, "
          f"max |d vx| = {d_vx:.3g} m/s, max |d vx_sqp| = {d_raw:.3g} m/s")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX and d_raw <= TOL_VX
    assert status[5] == -3 and status[6] == -3
    assert not out["vel_bound"][5] and not out["too_close"].any()
    assert torch.all(out["traj"][5, 3:, 5] == 0.0)


# ---- the fleet's velocity stage ---------------------------------------------

def _stage_inputs(oval_drive, lat, ticks=(15, 20)):
    """Two scenarios' four slots from recorded action sets (a slot without
    its action takes the follow path), padded as the fleet pads them."""
    rec, ja = oval_drive["rec"], oval_drive["lat"]
    P = 448
    paths = np.zeros((len(ticks), 4, P, 5), np.float32)
    n_valids = np.zeros((len(ticks), 4), np.int32)
    for b, t in enumerate(ticks):
        ts = rec[t]["traj_set"]
        for s, name in enumerate(("straight", "follow", "left", "right")):
            traj = ts.get(name, ts["follow"])[0]
            paths[b, s], n_valids[b, s] = _path_inputs(traj, P)
    vc = np.zeros((len(ticks), P), np.float32)
    opos = np.array([[o["X"], o["Y"]] for o in
                     (rec[t]["objects"][0] for t in ticks)], np.float32)
    for b, t in enumerate(ticks):
        vc[b, :3] = rec[t]["traj_set"]["follow"][0][:3, 5]
    j_opp = [jvp.opponent_summary(ja.glob_rl, ja.glob_el, jnp.asarray(p),
                                  jnp.float32(9.0), 1.0, 0.85, 1000.0)
             for p in opos]
    t_opp = tvp.opponent_summary(lat.glob_rl, lat.glob_el,
                                 torch.from_numpy(opos),
                                 torch.full((len(ticks),), 9.0), 1.0, 0.85,
                                 1000.0)
    return paths, n_valids, vc, j_opp, t_opp


@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_velocity_stage_scenario_matches_jax(oval_drive, backend):
    """The fleet's velocity stage on recorded slots: the fb branch with
    per-row gg streams (``const_gg`` None, kernel 5's instance), and the
    sqp branch (5 QPs a scenario in one solve, warm start from a profile)."""
    ja = oval_drive["lat"]
    lat = carry(ja)
    paths, n_valids, vc, j_opp, t_opp = _stage_inputs(oval_drive, lat)
    B, _, P, _ = paths.shape
    gg = np.tile(np.array([[9.0, 8.0]], np.float32), (P, 1))
    red = np.array([[False, False, True, False], [False, True, False, False]])
    v_end_rl = np.array([[30.0, 28.0, 25.0, 30.0], [26.0, 30.0, 30.0, 22.0]],
                        np.float32)
    vel_plan = np.array([38.0, 24.0], np.float32)
    obj_dist = np.array([70.0, 35.0], np.float32)
    x0 = (15.0 + 5.0 * np.cos(np.arange(P) / 23.0)).astype(np.float32)
    x0 = np.broadcast_to(x0, (B, 4, P)).copy()
    sqp_kw = dict(vp_backend=backend, tire_end_idx=2, sqp_m=115)
    ref = []
    for b in range(B):
        jkw = dict(sqp_kw, sqp_x0=jnp.asarray(x0[b]),
                   tire_end_mps2=jnp.float32(9.0), sqp_step=jnp.float32(2.5),
                   veh_turn=jnp.float32(7.0)) if backend == "sqp" else {}
        ref.append(jvp.velocity_stage_scenario(
            jnp.asarray(paths[b]), jnp.asarray(n_valids[b]), jnp.asarray(gg),
            jnp.asarray(vc[b]), jnp.int32(3), jnp.float32(vel_plan[b]),
            jnp.float32(vel_plan[b]), jnp.float32(45.0),
            jnp.asarray(cl.MACHINES), jnp.float32(0.1),
            jnp.asarray(v_end_rl[b]), jnp.asarray(red[b]),
            jnp.float32(obj_dist[b]), jnp.float32(9.0), jnp.float32(30.0),
            j_opp[b][0], j_opp[b][1], j_opp[b][3], jnp.float32(4.7),
            jnp.float32(1.25), jnp.float32(0.025), jnp.float32(0.2),
            jnp.float32(15.0), 1.0, 0.85, 1000.0, follow_slot=1, **jkw))
    tkw = dict(sqp_kw, sqp_x0=torch.from_numpy(x0), tire_end_mps2=_f32(9.0),
               sqp_step=2.5, veh_turn=_f32(7.0)) if backend == "sqp" else {}
    out = tvp.velocity_stage_scenario(
        torch.from_numpy(paths), torch.from_numpy(n_valids).long(),
        torch.from_numpy(gg), torch.from_numpy(vc), torch.full((B,), 3),
        torch.from_numpy(vel_plan), torch.from_numpy(vel_plan), _f32(45.0),
        torch.from_numpy(cl.MACHINES), _f32(0.1), torch.from_numpy(v_end_rl),
        torch.from_numpy(red), torch.from_numpy(obj_dist),
        torch.full((B,), 9.0), _f32(30.0), t_opp[0], t_opp[1], t_opp[3],
        _f32(4.7), _f32(1.25), _f32(0.025), _f32(0.2), _f32(15.0), 1.0, 0.85,
        1000.0, const_gg=None, follow_slot=1, **tkw)
    d_pos = d_vx = d_raw = 0.0
    for b, o in enumerate(ref):
        for k in ("vel_bound", "too_close", "qp_status"):
            np.testing.assert_array_equal(out[k][b].numpy(),
                                          np.asarray(o[k]), err_msg=k)
        d = np.abs(out["trajs"][b].numpy().astype(np.float64)
                   - np.asarray(o["trajs"], np.float64))
        d_pos = max(d_pos, float(d[..., 0:3].max()))
        d_vx = max(d_vx, float(d[..., 5].max()))
        d_raw = max(d_raw, float(np.abs(out["vx_sqp"][b].numpy()
                                        - np.asarray(o["vx_sqp"])).max()))
    print(f"velocity_stage_scenario {backend}: status "
          f"{out['qp_status'].tolist()}; max |d s,x,y| = {d_pos:.3g} m, max "
          f"|d vx| = {d_vx:.3g} m/s, max |d vx_sqp| = {d_raw:.3g} m/s")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX and d_raw <= TOL_VX
    if backend == "fb":
        # the constant-gg instance gives the same profiles bit for bit
        cgg = tvp.velocity_stage_scenario(
            torch.from_numpy(paths), torch.from_numpy(n_valids).long(),
            torch.from_numpy(gg), torch.from_numpy(vc), torch.full((B,), 3),
            torch.from_numpy(vel_plan), torch.from_numpy(vel_plan),
            _f32(45.0), torch.from_numpy(cl.MACHINES), _f32(0.1),
            torch.from_numpy(v_end_rl), torch.from_numpy(red),
            torch.from_numpy(obj_dist), torch.full((B,), 9.0), _f32(30.0),
            t_opp[0], t_opp[1], t_opp[3], _f32(4.7), _f32(1.25),
            _f32(0.025), _f32(0.2), _f32(15.0), 1.0, 0.85, 1000.0,
            const_gg=(9.0, 8.0), follow_slot=1)
        assert torch.equal(cgg["trajs"], out["trajs"])


@pytest.mark.parametrize("b", [0, 1])
def test_stage_and_facade_kernel_agree(oval_drive, b):
    """The fleet's fb stage (per-row gg streams) and the facade's
    ``velocity_kernel`` on one recorded scenario's four slots as four
    actions (the follow slot the one follow action, unit gg scales, no
    smoothing) give the same profiles, bounds and ``too_close`` bit for
    bit."""
    lat = carry(oval_drive["lat"])
    paths, n_valids, vc, _, t_opp = _stage_inputs(oval_drive, lat)
    B, _, P, _ = paths.shape
    gg = torch.from_numpy(np.tile(np.array([[9.0, 8.0]], np.float32),
                                  (P, 1)))
    red = torch.tensor([[False, False, True, False],
                        [False, True, False, False]])
    v_end_rl = torch.tensor([[30.0, 28.0, 25.0, 30.0],
                             [26.0, 30.0, 30.0, 22.0]])
    vel_plan = torch.tensor([38.0, 24.0])
    obj_dist = torch.tensor([70.0, 35.0])
    ctrl = (_f32(4.7), _f32(1.25), _f32(0.025), _f32(0.2), _f32(15.0), 1.0,
            0.85, 1000.0)
    stage = tvp.velocity_stage_scenario(
        torch.from_numpy(paths), torch.from_numpy(n_valids).long(), gg,
        torch.from_numpy(vc), torch.full((B,), 3), vel_plan, vel_plan,
        _f32(45.0), torch.from_numpy(cl.MACHINES), _f32(0.1), v_end_rl, red,
        obj_dist, torch.full((B,), 9.0), _f32(30.0), t_opp[0], t_opp[1],
        t_opp[3], *ctrl, const_gg=None, follow_slot=1)
    R = 4
    kern = tvp.velocity_kernel(
        torch.from_numpy(paths[b]), torch.from_numpy(n_valids[b]).long(),
        gg.expand(R, P, 2), torch.from_numpy(vc[b]), torch.tensor(3),
        vel_plan[b], vel_plan[b], _f32(45.0), _f32(1.0), _f32(1.0),
        torch.from_numpy(cl.MACHINES), _f32(0.1),
        torch.tensor([False, True, False, False]), red[b], v_end_rl[b],
        obj_dist[b].expand(R), torch.full((R,), 9.0), _f32(30.0), t_opp[0][b],
        t_opp[1][b], t_opp[3][b], *ctrl, filt_window=1)
    assert torch.equal(kern["traj"], stage["trajs"][b])
    assert torch.equal(kern["vel_bound"], stage["vel_bound"][b])
    assert bool(kern["too_close"][1]) == bool(stage["too_close"][b])


def test_brake_em_sqp_kernel_matches_jax(oval_drive):
    rec = oval_drive["rec"]
    path, n = _path_inputs(rec[15]["traj_set"]["left"][0])
    rng = np.random.default_rng(1)
    gg = rng.uniform(4.5, 5.5, (448, 2)).astype(np.float32)
    vc = np.zeros(448, np.float32)
    vc[:3] = rec[15]["traj_set"]["left"][0][:3, 5]
    d_vx = 0.0
    for vel_plan, c_len in ((30.0, 3), (12.0, 0)):
        jb = jvp.brake_em_sqp_kernel(
            jnp.asarray(path), jnp.int32(n), jnp.asarray(gg), jnp.asarray(vc),
            jnp.int32(c_len), jnp.float32(vel_plan),
            jnp.asarray(cl.MACHINES), jnp.float32(7.0), jnp.float32(5.0),
            0.85, 1000.0, sqp_m=115)
        tb = tvp.brake_em_sqp_kernel(
            torch.from_numpy(path), n, torch.from_numpy(gg),
            torch.from_numpy(vc), c_len, _f32(vel_plan),
            torch.from_numpy(cl.MACHINES), _f32(7.0), _f32(5.0), 0.85,
            1000.0, sqp_m=115)
        d = np.abs(tb.numpy().astype(np.float64) - np.asarray(jb, np.float64))
        assert d[:, 0:3].max() <= TOL_POS
        d_vx = max(d_vx, float(d[:, 5].max()))
        # the 1 m/s cap
        assert float(tb[c_len + 1:, 5].max()) <= 1.0 + 1e-6
    print(f"brake_em_sqp_kernel: max |d vx| = {d_vx:.3g} m/s")
    assert d_vx <= TOL_VX


# ---- the fleet tick ---------------------------------------------------------

def test_scenario_tick_sqp_matches_jax():
    """The fleet tick under sqp at B=8 on the small oval with 1 opponent,
    cold (the 20 m/s fill) and with seeded warm-start profiles."""
    ja = jax_small_oval()
    lat = carry(ja)
    B = 8
    js = jsc.random_scenarios(ja, B, seed=0, n_objects=1)
    ts = tsc.random_scenarios(lat, B, seed=0, device="cpu", n_objects=1)
    P = tsc.C_PAD + 320
    kw = dict(vp_backend="sqp", tire_end_idx=2, tire_end_mps2=5.0, sqp_m=115,
              sqp_step=float(lat.sampled_resolution))
    jt = jax.jit(lambda scen, x0: jax.vmap(
        lambda s, x: jsc.scenario_tick(ja, s, sqp_x0=x, **kw))(scen, x0))
    tick = tsc.make_batched_tick(lat, device="cpu", **kw)
    rng = np.random.default_rng(5)
    warm = (12.0 + 20.0 * rng.random((B, 4, P))).astype(np.float32)
    for label, x0 in (("cold", None), ("warm", warm)):
        jo = jt(js, jnp.asarray(np.full((B, 4, P), 20.0, np.float32)
                                if x0 is None else x0))
        to = tick(ts, sqp_x0=None if x0 is None else torch.from_numpy(x0))
        for k in EXACT:
            np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                          err_msg=f"{label}: {k}")
        d = np.abs(np.asarray(jo["trajs"], np.float64)
                   - to["trajs"].numpy().astype(np.float64))
        d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
        d_raw = float(np.abs(np.asarray(jo["vx_sqp"])
                             - to["vx_sqp"].numpy()).max())
        print(f"scenario_tick sqp {label} B={B}: status "
              f"{np.unique(to['qp_status'].numpy()).tolist()}; max |d s,x,y| "
              f"= {d_pos:.3g} m, max |d vx| = {d_vx:.3g} m/s, max |d vx_sqp| "
              f"= {d_raw:.3g} m/s")
        assert d_pos <= TOL_POS and d_vx <= TOL_VX and d_raw <= TOL_VX
        assert to["vx_sqp"].shape == (B, 4, P)


# ---- the facade -------------------------------------------------------------

def test_sqp_facade_oval_matches_jax(oval_drive, monkeypatch):
    """The recorded JAX drive replayed through the port's facade: action
    keys and node chains equal on every tick, the warm-start store's keys
    equal after every tick, every action kind reached."""
    r = oval_drive
    ltpl = GraphLTPL(r["pd"], device="cpu", log_to_file=False)
    ltpl.graph_init()
    assert ltpl._oth.vp_backend == "sqp"
    states = []
    rec = cl.drive(ltpl, len(r["rec"]), r["pos"], r["heading"],
                   zones=r["zones"], replay=r["rec"],
                   on_tick=lambda t: states.append(
                       {k: v.copy() for k, v in ltpl._oth.sqp_state.items()}))
    d_pos, d_vx, seen = cl.compare(r["rec"], rec)
    d_state = 0.0
    for tick, (a, b) in enumerate(zip(r["states"], states)):
        assert set(a) == set(b), f"tick {tick}: {sorted(a)} != {sorted(b)}"
        for k in a:
            d_state = max(d_state, float(np.abs(a[k] - b[k]).max()))
    print(f"sqp facade oval, {len(rec)} ticks: max |d s,x,y| = {d_pos:.3g} m, "
          f"max |d vx| = {d_vx:.3g} m/s, warm-start store max |d| = "
          f"{d_state:.3g} m/s, keys {sorted(states[-1])}, actions "
          f"{sorted(seen)}")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX and d_state <= TOL_VX
    assert seen == {"straight", "follow", "left", "right", "emergency"}
    assert ("f", "follow") in states[-1] and ("slr", "straight") in states[-1]


def test_sqp_facade_unclosed_takes_the_sqp_ladder(tmp_path, monkeypatch):
    """Into the unclosed track's end under sqp: the backup ladder brakes
    through ``brake_em_sqp_kernel`` on both sides, the port's drive equals
    the JAX drive tick by tick."""
    pd = _path_dict(str(tmp_path), UNCLOSED_CSV, "unclosed.npz")
    calls = {"jax": 0, "port": 0}

    def counted(mod, key):
        real = mod.vp.brake_em_sqp_kernel

        def f(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod.vp, "brake_em_sqp_kernel", f)
    counted(jhandler, "jax")
    counted(thandler, "port")
    j = JaxGraphLTPL(pd, log_to_file=False)
    j.graph_init()
    pos, heading = cl.start_pose(np.asarray(j.lattice.refline),
                                 START_LAYER_UNCLOSED)
    rec_j = cl.drive(j, TICKS_UNCLOSED, pos, heading)
    ltpl = GraphLTPL(pd, device="cpu", log_to_file=False)
    ltpl.graph_init()
    rec_t = cl.drive(ltpl, TICKS_UNCLOSED, pos, heading, replay=rec_j)
    d_pos, d_vx, seen = cl.compare(rec_j, rec_t)
    print(f"sqp facade unclosed, {len(rec_t)} ticks: max |d s,x,y| = "
          f"{d_pos:.3g} m, max |d vx| = {d_vx:.3g} m/s, SQP ladder "
          f"{calls['jax']} (jax) / {calls['port']} (port), actions "
          f"{sorted(seen)}")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX
    assert calls["port"] == calls["jax"] > 0
