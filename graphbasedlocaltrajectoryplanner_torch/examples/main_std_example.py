"""Standard example: dynamic opponent + blocked zone + logging — the port's
counterpart of the JAX package's ``examples/main_std_example.py`` (the
reference's main_std_example.py).

Usage:
    python -m \\
        graphbasedlocaltrajectoryplanner_torch.examples.main_std_example \\
        --track <path-to-csv> [--ticks 300] [--visual] [--zone] \\
        [--veh-dyn <csv>] [--cpu]

The repository's own track CSV is
``parity/fixtures/traj_ltpl_unclosed_monteblanco.csv``.  The planner runs
on the card; ``--cpu`` runs its plain PyTorch path on the CPU.  The lattice
is cached in ``artifacts/stored_graph_torch_std.npz``, the logs go to
``logs/graph_ltpl_torch/`` (read them with
``python -m graphbasedlocaltrajectoryplanner_torch.visualization.log_viewer``).
"""

import argparse
import datetime
import time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.examples.main_min_example import (
    ACTION_PRIORITY, TOP, start_pose, tick_record)
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    import_globtraj_csv)
from graphbasedlocaltrajectoryplanner_torch.testing_tools.vdc_dummy import (
    vdc_dummy)
from graphbasedlocaltrajectoryplanner_torch.testing_tools.objectlist_dummy \
    import ObjectlistDummy
from graphbasedlocaltrajectoryplanner_torch.utils.veh_dyn import (
    import_veh_dyn_info)


def sample_zone(ltpl) -> dict:
    """A blocked zone over half the nodes of layers 20-22, in the facade's
    ``blocked_zones`` format (zone type "nodes")."""
    nil = ltpl.lattice.nodes_in_layer.cpu().numpy()
    layers, nodes = [], []
    for l in (20, 21, 22):
        for n in range(int(nil[l]) // 2):
            layers.append(l)
            nodes.append(n)
    return {"sample_zone": [layers, nodes,
                            np.zeros((2, 2)), np.zeros((2, 2))]}


def drive(ltpl, gt, ticks: int, ax_max_machines, zones=None,
          clock=time.time, report_every: int = 20):
    """The example's closed loop on ``ltpl`` (``graph_init`` done) from the
    start of track ``gt``, with an opponent replaying the raceline at 0.3 of
    its speed from 250 m on, the machine limits ``ax_max_machines``,
    ``zones`` blocked and every tick logged.
    ``clock`` is read once a tick: the opponent and the vehicle dummy move
    by the time it advanced since the previous tick.  Returns one
    ``tick_record`` a tick."""
    ltpl.set_startpos(*start_pose(gt.refline))
    pos_est = gt.refline[0, :]
    now = clock()
    obj_dummy = ObjectlistDummy(dynamic=True, vel_scale=0.3, s0=250.0,
                                globtraj=gt, clock=lambda: now)
    traj_set = {"straight": None}
    records = []
    tic = now
    for tick in range(ticks):
        now = clock()
        for sel_action in ACTION_PRIORITY:
            if sel_action in traj_set:
                break
        obj_list = obj_dummy.get_objectlist()
        ltpl.calc_paths(prev_action_id=sel_action, object_list=obj_list,
                        blocked_zones=zones)
        if traj_set[sel_action] is not None:
            pos_est, vel_est = vdc_dummy(
                pos_est, traj_set[sel_action][0][:, 0],
                traj_set[sel_action][0][:, 1:3],
                traj_set[sel_action][0][:, 5], now - tic)
        else:
            vel_est = 0.0
        tic = now
        traj_set = ltpl.calc_vel_profile(pos_est=pos_est, vel_est=vel_est,
                                         ax_max_machines=ax_max_machines,
                                         incl_emerg_traj=True)[0]
        ltpl.log()
        ltpl.visual()
        records.append(tick_record(ltpl, sel_action, traj_set))
        if report_every and tick % report_every == 0:
            print(f"tick {tick:4d}  action={sel_action:8s}  "
                  f"v={vel_est:5.1f} m/s  set={sorted(traj_set)}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", required=True,
                    help="path to a 12-column LTPL track CSV")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--visual", action="store_true")
    ap.add_argument("--zone", action="store_true",
                    help="activate a sample blocked zone (layers 20-22)")
    ap.add_argument("--veh-dyn",
                    default=TOP + "/inputs/veh_dyn_info/ax_max_machines.csv",
                    help="machine acceleration limit table (csv)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    ax_max_machines = import_veh_dyn_info(
        ax_max_machines_import_path=args.veh_dyn)[1]

    path_dict = {
        "globtraj_input_path": args.track,
        "graph_store_path": TOP + "/artifacts/stored_graph_torch_std.npz",
        "ltpl_offline_param_path": TOP + "/params/ltpl_config_offline.ini",
        "ltpl_online_param_path": TOP + "/params/ltpl_config_online.ini",
        "log_path": TOP + "/logs/graph_ltpl_torch/",
        "graph_log_id": datetime.datetime.now().strftime("%Y_%m_%d__%H_%M_%S"),
    }
    ltpl = GraphLTPL(path_dict, visual_mode=args.visual, log_to_file=True,
                     device="cpu" if args.cpu else None)
    ltpl.graph_init()
    drive(ltpl, import_globtraj_csv(args.track), args.ticks, ax_max_machines,
          zones=sample_zone(ltpl) if args.zone else None)
    print("done — logs in", path_dict["log_path"])


if __name__ == "__main__":
    main()
