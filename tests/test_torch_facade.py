"""PyTorch port, the interactive path: the port's ``GraphLTPL(device="cpu")``
against the JAX package's ``GraphLTPL`` on the same inputs, tick by tick.

Both facades run under one fake clock (+0.1 s per tick, so the handler's
calc-time feedback is the same) and see one input stream: the JAX run
closes the loop through the vehicle dummy and records every tick's inputs,
and the port replays them open-loop
(``testing_tools/closed_loop.py``).  Gates: action-set keys and node chains
equal on every tick; trajectories within the JAX package's own
cross-backend bar, 2 mm in s, x, y and 0.02 m/s in vx.  Also the md5-keyed
lattice cache (``load_or_build``) and the facade's device contract."""

import os

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.planner.facade import (
    GraphLTPL as JaxGraphLTPL)
from graphbasedlocaltrajectoryplanner_torch.models import lattice as tlat
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)

from torch_port_common import UNCLOSED_CSV, carry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFLINE_INI = os.path.join(ROOT, "params", "ltpl_config_offline.ini")
ONLINE_INI = os.path.join(ROOT, "params", "ltpl_config_online.ini")
SQP_INI = os.path.join(ROOT, "parity", "fixtures",
                       "ltpl_config_online_sqp.ini")
TICKS_OVAL = 20
# unclosed Monteblanco from layer 26, 84 m before the track end, into the
# end: the track gets blocked (all-blocked fallback) and the handler brakes
# on its backup path
TICKS_UNCLOSED = 95
START_LAYER_UNCLOSED = 26


def _path_dict(tmp, track, store, online=ONLINE_INI):
    return {"globtraj_input_path": track,
            "graph_store_path": os.path.join(tmp, store),
            "ltpl_offline_param_path": OFFLINE_INI,
            "ltpl_online_param_path": online,
            "graph_log_id": "test",
            "log_path": os.path.join(tmp, "logs")}


def _arrays_equal(a, b):
    for k in tlat.ARRAY_FIELDS:
        x = getattr(a, k)
        y = getattr(b, k)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        np.testing.assert_array_equal(x.numpy(), y, err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX drives (closed loop, recorded) on both tracks; their lattice
    artifacts are the ones the port's facade then loads."""
    tmp = str(tmp_path_factory.mktemp("facade"))
    out = {"tmp": tmp}
    for name, track, n, layer in (
            ("oval", "oval", TICKS_OVAL, 0),
            ("unclosed", UNCLOSED_CSV, TICKS_UNCLOSED, START_LAYER_UNCLOSED)):
        pd = _path_dict(tmp, track, f"{name}.npz")
        j = JaxGraphLTPL(pd, log_to_file=False)
        j.graph_init()
        lat = j.lattice
        pos, heading = cl.start_pose(np.asarray(lat.refline), layer)
        objs = zones = None
        if name == "oval":
            objs = cl.slow_opponent(np.asarray(lat.raceline),
                                    np.asarray(lat.normvec),
                                    np.asarray(lat.s_rl))
            zones = cl.left_half_zone(np.asarray(lat.nodes_in_layer))
        rec = cl.drive(j, n, pos, heading, objs, zones)
        out[name] = dict(pd=pd, jax_lattice=lat, pos=pos, heading=heading,
                         zones=zones, rec=rec)
    return out


@pytest.mark.parametrize("name", ["oval", "unclosed"])
def test_facade_matches_jax(runs, name, monkeypatch):
    from graphbasedlocaltrajectoryplanner_torch.planner import handler
    r = runs[name]
    ltpl = GraphLTPL(r["pd"], device="cpu")
    ltpl.graph_init()
    assert ltpl.lattice.device.type == "cpu"
    backup = []
    real_backup = handler.vp.brake_on_backup_kernel

    def counted(*a, **k):
        backup.append(1)
        return real_backup(*a, **k)
    monkeypatch.setattr(handler.vp, "brake_on_backup_kernel", counted)
    rec = cl.drive(ltpl, len(r["rec"]), r["pos"], r["heading"],
                   zones=r["zones"], replay=r["rec"])
    d_pos, d_vx, seen = cl.compare(r["rec"], rec)
    print(f"facade {name}, {len(rec)} ticks: max |d s,x,y| = {d_pos:.3g} m, "
          f"max |d vx| = {d_vx:.3g} m/s, actions {sorted(seen)}, "
          f"{len(backup)} backup brake profiles")
    assert d_pos <= 2e-3 and d_vx <= 0.02, (d_pos, d_vx)
    if name == "oval":
        assert seen == {"straight", "follow", "left", "right", "emergency"}
    else:
        assert {"straight", "emergency"} <= seen
        assert backup, "the drive never braked on its backup path"
    # the facade's default log: one data row per tick
    with open(ltpl._path_dict["graph_log_data_path"]) as fh:
        rows = [ln for ln in fh.read().splitlines()
                if ln and not ln.startswith("#")]
    assert len(rows) == 1 + len(rec)


def test_load_or_build_reads_the_jax_artifact(runs):
    # the JAX facade saved the oval under its md5 key; the port's cache
    # computes the same key and reads the arrays bit for bit
    r = runs["oval"]
    lat, built = tlat.load_or_build("oval", OFFLINE_INI,
                                    r["pd"]["graph_store_path"])
    assert not built
    assert lat.device.type == "cpu"
    _arrays_equal(lat, r["jax_lattice"])


def test_load_or_build_builds_then_reloads(runs):
    store = os.path.join(runs["tmp"], "port_unclosed.npz")
    lat, built = tlat.load_or_build(UNCLOSED_CSV, OFFLINE_INI, store)
    assert built and os.path.isfile(store)
    again, built2 = tlat.load_or_build(UNCLOSED_CSV, OFFLINE_INI, store)
    assert not built2
    _arrays_equal(again, lat)
    # the port's build equals the JAX build of the same track and INI
    _arrays_equal(lat, runs["unclosed"]["jax_lattice"])
    assert lat.md5_params == runs["unclosed"]["jax_lattice"].md5_params


def test_facade_device_and_backend_contract(runs, tmp_path):
    pd = _path_dict(str(tmp_path), "oval", "oval.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphLTPL(pd)
    with pytest.raises(NotImplementedError, match="visual"):
        GraphLTPL(pd, visual_mode=True, device="cpu")
    # the sqp velocity backend is ported (tests/test_torch_sqp.py drives it)
    pd_sqp = dict(runs["oval"]["pd"], ltpl_online_param_path=SQP_INI)
    ltpl = GraphLTPL(pd_sqp, log_to_file=False, device="cpu")
    ltpl.graph_init()
    assert ltpl._oth.vp_backend == "sqp"


def _velocity_inputs(runs, seed):
    """A follow path of the recorded oval drive (tick 15, opponent ahead),
    padded as the handler pads it, with a seeded per-point gg."""
    traj = runs["oval"]["rec"][15]["traj_set"]["follow"][0]
    n = traj.shape[0]
    P = 448
    path = np.zeros((P, 5), np.float32)
    path[:n, 0:4] = traj[:, 1:5]
    path[:n - 1, 4] = np.diff(traj[:, 0])
    path[n:, 0:4] = traj[-1, 1:5]
    rng = np.random.default_rng(seed)
    gg = rng.uniform(4.5, 5.5, (P, 2)).astype(np.float32)
    vc = np.zeros(P, np.float32)
    vc[:3] = traj[:3, 5]
    return path, n, gg, vc


@pytest.mark.parametrize("vel_plan,filt", [(12.0, 1), (40.0, 3)])
def test_velocity_kernel_matches_jax(runs, vel_plan, filt):
    import jax.numpy as jnp
    from graphbasedlocaltrajectoryplanner_tpu.planner import velplan as jvp
    from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
    ja = runs["oval"]["jax_lattice"]
    path, n, gg, vc = _velocity_inputs(runs, 0)
    opp = runs["oval"]["rec"][15]["objects"][0]
    opos = np.array([opp["X"], opp["Y"]], np.float32)
    j_opp = jvp.opponent_summary(ja.glob_rl, ja.glob_el, jnp.asarray(opos),
                                 jnp.float32(9.0), 1.0, 0.85, 1000.0)
    lat = carry(ja)
    t_opp = tvp.opponent_summary(lat.glob_rl, lat.glob_el,
                                 torch.from_numpy(opos)[None],
                                 torch.tensor([9.0]), 1.0, 0.85, 1000.0)
    for x, y in zip(j_opp, t_opp):
        np.testing.assert_allclose(y[0].numpy(), np.asarray(x), atol=1e-4)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    # rows: (is_follow, red_len, v_end_rl, obj_dist, v_obj)
    rows = [(True, False, 30.0, 60.0, 9.0), (False, False, 30.0, 0.0, 0.0),
            (True, True, 25.0, 40.0, 9.0), (False, True, 30.0, 0.0, 0.0)]
    machines = cl.MACHINES
    ref = []
    for fol, red, v_end, od, vo in rows:
        o = jvp.velocity_kernel(
            jnp.asarray(path), jnp.int32(n), jnp.asarray(gg), jnp.asarray(vc),
            jnp.int32(3), jnp.float32(vel_plan), jnp.float32(vel_plan),
            jnp.float32(35.0), jnp.float32(0.9), jnp.float32(1.0),
            jnp.asarray(machines), jnp.float32(0.1), fol, red,
            jnp.float32(v_end), jnp.float32(od), jnp.float32(vo),
            jnp.float32(30.0), j_opp[0], j_opp[1], j_opp[3],
            jnp.float32(4.7), jnp.float32(1.25), jnp.float32(0.025),
            jnp.float32(0.2), jnp.float32(1.0), 1.0, 0.85, 1000.0,
            filt_window=filt)
        ref.append(o)
    R = len(rows)
    cols = np.array([r[2:] for r in rows], np.float32)
    out = tvp.velocity_kernel(
        torch.from_numpy(path)[None].expand(R, -1, -1).contiguous(),
        torch.full((R,), n), torch.from_numpy(gg)[None].expand(R, -1, -1),
        torch.from_numpy(vc), torch.tensor(3), f32(vel_plan), f32(vel_plan),
        f32(35.0), f32(0.9), f32(1.0), torch.from_numpy(machines), f32(0.1),
        torch.tensor([r[0] for r in rows]), torch.tensor([r[1] for r in rows]),
        torch.from_numpy(cols[:, 0]), torch.from_numpy(cols[:, 1]),
        torch.from_numpy(cols[:, 2]), f32(30.0), t_opp[0][0], t_opp[1][0],
        t_opp[3][0], f32(4.7), f32(1.25), f32(0.025), f32(0.2), f32(1.0),
        1.0, 0.85, 1000.0, filt_window=filt)
    d_pos = d_vx = 0.0
    for r, o in enumerate(ref):
        for k in ("vel_bound", "too_close"):
            assert bool(out[k][r]) == bool(o[k]), (r, k)
        d = np.abs(out["traj"][r].numpy().astype(np.float64)
                   - np.asarray(o["traj"], np.float64))
        d_pos = max(d_pos, float(d[:, 0:3].max()))
        d_vx = max(d_vx, float(d[:, 5].max()))
    print(f"velocity_kernel vel_plan={vel_plan} filt={filt}: max |d s,x,y| "
          f"= {d_pos:.3g} m, max |d vx| = {d_vx:.3g} m/s")
    assert d_pos <= 2e-3 and d_vx <= 0.02, (d_pos, d_vx)
    # the backup brake profile (the handler's infeasibility ladder)
    jb = jvp.brake_on_backup_kernel(
        jnp.asarray(path), jnp.int32(n), jnp.asarray(gg), jnp.asarray(vc),
        jnp.int32(3), jnp.float32(vel_plan), 1.0, 0.85, 1000.0)
    tb = tvp.brake_on_backup_kernel(
        torch.from_numpy(path), n, torch.from_numpy(gg), torch.from_numpy(vc),
        3, f32(vel_plan), 1.0, 0.85, 1000.0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
