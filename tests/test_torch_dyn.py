"""PyTorch port, the interactive facade under the dynamic-parameter
schedule of ``parity/dyn_schedule.py`` (a per-point ``local_gg`` every
tick, a ``gg_scale`` step at tick 120) with its ``vel_max`` drop deepened
from 24 to 15 m/s for ticks 60-99: the oval drive runs at about 23.8 m/s
when the drop begins, below the schedule's 24 m/s, and only the deeper
drop fires the fb brake prefix.  The JAX package's facade in closed loop,
the port's ``GraphLTPL(device="cpu")`` on its recorded inputs
(``testing_tools/closed_loop.py``); action keys and node chains equal on
every tick, trajectories within 2 mm and 0.02 m/s."""

import os

import numpy as np

from graphbasedlocaltrajectoryplanner_tpu.planner.facade import (
    GraphLTPL as JaxGraphLTPL)
from graphbasedlocaltrajectoryplanner_tpu.planner import handler as jhandler
from graphbasedlocaltrajectoryplanner_torch.planner import handler as thandler
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from parity import dyn_schedule as dynsch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS_DYN = 140
VEL_MAX_DROP = 15.0     # m/s, ticks 60-99


def _dyn_kw(tick, ltpl):
    """The schedule's per-tick arguments (the deeper drop), the local gg
    from the planner's own paths."""
    vel_max = dynsch.vel_max_at(tick)
    if 60 <= tick < 100:
        vel_max = VEL_MAX_DROP
    return dict(vel_max=vel_max,
                gg_scale=dynsch.gg_scale_at(tick),
                local_gg=dynsch.local_gg_dict(ltpl._oth.last_path_param))


def test_facade_dynamic_parameter_schedule(tmp_path, monkeypatch):
    """The oval with its opponent and zone for 140 ticks."""
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": str(tmp_path / "oval.npz"),
          "ltpl_offline_param_path": os.path.join(
              ROOT, "params", "ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              ROOT, "params", "ltpl_config_online.ini"),
          "graph_log_id": "test", "log_path": str(tmp_path / "logs")}
    calls = {"jax": 0, "port": 0}
    for mod, key in ((jhandler, "jax"), (thandler, "port")):
        real = mod.vp.brake_on_backup_kernel

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod.vp, "brake_on_backup_kernel", counted)
    j = JaxGraphLTPL(pd, log_to_file=False)
    j.graph_init()
    lat = j.lattice
    pos, heading = cl.start_pose(np.asarray(lat.refline), 0)
    objs = cl.slow_opponent(np.asarray(lat.raceline), np.asarray(lat.normvec),
                            np.asarray(lat.s_rl))
    zones = cl.left_half_zone(np.asarray(lat.nodes_in_layer))
    rec_j = cl.drive(j, TICKS_DYN, pos, heading, objs, zones, vel_kw=_dyn_kw)
    ltpl = GraphLTPL(pd, device="cpu", log_to_file=False)
    ltpl.graph_init()
    rec_t = cl.drive(ltpl, TICKS_DYN, pos, heading, zones=zones,
                     replay=rec_j, vel_kw=_dyn_kw)
    d_pos, d_vx, seen = cl.compare(rec_j, rec_t)
    v = [r["vel"] for r in rec_j]
    print(f"facade dyn schedule, {TICKS_DYN} ticks: max |d s,x,y| = "
          f"{d_pos:.3g} m, max |d vx| = {d_vx:.3g} m/s, actions "
          f"{sorted(seen)}, backup brake profiles {calls}, v at tick 59 / "
          f"99: {v[59]:.2f} / {v[99]:.2f} m/s")
    assert d_pos <= 2e-3 and d_vx <= 0.02, (d_pos, d_vx)
    assert calls["port"] == calls["jax"]
    assert seen == {"straight", "follow", "left", "right", "emergency"}
    # the drop needs the brake prefix: the car runs above it at tick 59 and
    # comes down to it
    assert v[59] > VEL_MAX_DROP + 0.1 and abs(v[99] - VEL_MAX_DROP) < 1.0
