"""PyTorch port, the example CLIs (``examples/main_{min,std}_example.py``):
each example's loop at 15 ticks on the CPU under a fixed clock step,
against the same loop written here around the JAX package's facade on the
same lattice (the JAX build, which the port loads from its cache).  Gates:
action keys and node chains equal every tick, trajectories within 2 mm in
s, x, y and 0.02 m/s in vx (PARITY.md:311-315).  Both CLIs also run
``--ticks 3 --cpu`` end to end."""

import os
import runpy
import sys

import numpy as np
import pytest

from graphbasedlocaltrajectoryplanner_tpu.models.track import (
    import_globtraj_csv as jax_import_csv, make_oval_track as jax_oval)
from graphbasedlocaltrajectoryplanner_tpu.planner.facade import (
    GraphLTPL as JaxGraphLTPL)
from graphbasedlocaltrajectoryplanner_tpu.testing_tools.objectlist_dummy \
    import ObjectlistDummy as JaxObjectlistDummy
from graphbasedlocaltrajectoryplanner_tpu.testing_tools.vdc_dummy import (
    vdc_dummy as jax_vdc_dummy)
from graphbasedlocaltrajectoryplanner_tpu.utils.veh_dyn import (
    import_veh_dyn_info as jax_veh_dyn)
from graphbasedlocaltrajectoryplanner_torch.examples import (
    main_min_example as mex, main_std_example as sex)
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    import_globtraj_csv, make_oval_track)
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.utils.veh_dyn import (
    import_veh_dyn_info)

from torch_port_common import UNCLOSED_CSV

TICKS = 15
TOP = mex.TOP
VEH_DYN = TOP + "/inputs/veh_dyn_info/ax_max_machines.csv"


def _path_dict(tmp, track, store, log=None):
    pd = {"globtraj_input_path": track,
          "graph_store_path": os.path.join(tmp, store),
          "ltpl_offline_param_path": TOP + "/params/ltpl_config_offline.ini",
          "ltpl_online_param_path": TOP + "/params/ltpl_config_online.ini"}
    if log:
        pd.update(log_path=os.path.join(tmp, log), graph_log_id="ex")
    return pd


def _jax_loop(ltpl, gt, ticks, clock, objects=False, zones=None,
              ax_max_machines=None):
    """The examples' loop around the JAX facade (the JAX vehicle and
    opponent dummies), the clock read once a tick."""
    refline = gt.refline
    pos_est = refline[0, :]
    heading = float(np.arctan2(refline[1, 1] - refline[0, 1],
                               refline[1, 0] - refline[0, 0]) - np.pi / 2)
    ltpl.set_startpos(pos_est=pos_est, heading_est=heading)
    now = clock()
    obj_dummy = JaxObjectlistDummy(dynamic=True, vel_scale=0.3, s0=250.0,
                                   globtraj=gt, clock=lambda: now)
    traj_set = {"straight": None}
    tic = now
    records = []
    for _ in range(ticks):
        now = clock()
        for sel_action in ["right", "left", "straight", "follow"]:
            if sel_action in traj_set:
                break
        obj_list = obj_dummy.get_objectlist() if objects else []
        ltpl.calc_paths(prev_action_id=sel_action, object_list=obj_list,
                        blocked_zones=zones)
        if traj_set[sel_action] is not None:
            pos_est, vel_est = jax_vdc_dummy(
                pos_est, traj_set[sel_action][0][:, 0],
                traj_set[sel_action][0][:, 1:3],
                traj_set[sel_action][0][:, 5], now - tic)
        else:
            vel_est = 0.0
        tic = now
        kw = {} if ax_max_machines is None else dict(
            ax_max_machines=ax_max_machines, incl_emerg_traj=True)
        traj_set = ltpl.calc_vel_profile(pos_est=pos_est, vel_est=vel_est,
                                         **kw)[0]
        if objects:
            ltpl.log()
        records.append(mex.tick_record(ltpl, sel_action, traj_set))
    return records


def _clocked(fn):
    clock = cl.StepClock()
    with cl.fake_time(clock):
        return fn(clock)


def _held(rec_j, rec_t):
    d_pos, d_vx, seen = cl.compare(rec_j, rec_t)
    assert d_pos <= 2e-3 and d_vx <= 0.02, (d_pos, d_vx)
    return seen


def test_min_example_loop_matches_jax(tmp_path):
    pd = _path_dict(str(tmp_path), "oval", "oval.npz")
    j = JaxGraphLTPL(pd, log_to_file=False)
    j.graph_init()
    rec_j = _clocked(lambda c: _jax_loop(j, jax_oval(), TICKS, c))
    t = GraphLTPL(pd, log_to_file=False, device="cpu")
    t.graph_init()
    rec_t = _clocked(lambda c: mex.drive(
        t, *mex.start_pose(make_oval_track().refline), TICKS, clock=c))
    seen = _held(rec_j, rec_t)
    assert "straight" in seen
    assert rec_t[-1]["sel"] == rec_j[-1]["sel"]


def test_std_example_loop_matches_jax(tmp_path):
    """Unclosed Monteblanco with the opponent dummy, the sample zone and
    logging on."""
    tmp = str(tmp_path)
    j = JaxGraphLTPL(_path_dict(tmp, UNCLOSED_CSV, "mb.npz", "logs_jax"),
                     log_to_file=True)
    j.graph_init()
    t = GraphLTPL(_path_dict(tmp, UNCLOSED_CSV, "mb.npz", "logs_torch"),
                  log_to_file=True, device="cpu")
    t.graph_init()
    zones = sex.sample_zone(t)
    rec_j = _clocked(lambda c: _jax_loop(
        j, jax_import_csv(UNCLOSED_CSV), TICKS, c, objects=True,
        zones=zones, ax_max_machines=jax_veh_dyn(
            ax_max_machines_import_path=VEH_DYN)[1]))
    rec_t = _clocked(lambda c: sex.drive(
        t, import_globtraj_csv(UNCLOSED_CSV), TICKS,
        import_veh_dyn_info(ax_max_machines_import_path=VEH_DYN)[1],
        zones=zones, clock=c))
    seen = _held(rec_j, rec_t)
    assert {"emergency", "follow"} <= seen, seen
    data = t._path_dict["graph_log_data_path"]
    with open(data) as fh:
        assert len(fh.read().splitlines()) == 2 + TICKS


@pytest.mark.parametrize("module,args", [
    ("main_min_example", ["--ticks", "3", "--cpu"]),
    ("main_std_example", ["--track", UNCLOSED_CSV, "--ticks", "3", "--zone",
                          "--cpu"]),
])
def test_cli_runs_on_the_cpu(module, args, monkeypatch, capsys):
    name = "graphbasedlocaltrajectoryplanner_torch.examples." + module
    monkeypatch.setattr(sys, "argv", [name] + args)
    monkeypatch.delitem(sys.modules, name, raising=False)   # run it afresh
    try:
        runpy.run_module(name, run_name="__main__", alter_sys=True)
    except SystemExit as e:          # argparse or the CLI's own exit
        assert e.code in (0, None), e
    out = capsys.readouterr().out
    assert "tick    0" in out and "done" in out
