"""Minimal example: offline lattice + closed-loop driving on a track without
objects or logging — the port's counterpart of the JAX package's
``examples/main_min_example.py`` (the reference's main_min_example.py).

Usage:
    python -m \\
        graphbasedlocaltrajectoryplanner_torch.examples.main_min_example \\
        [--track oval|<path-to-csv>] [--ticks 200] [--visual] [--cpu]

With ``--track oval`` (default from params/driving_task.ini) the built-in
synthetic track is used, so no data files are required.  Any
reference-format 12-column LTPL CSV can be passed instead.  The planner
runs on the card; ``--cpu`` runs its plain PyTorch path on the CPU.  The
lattice is cached in ``artifacts/stored_graph_torch.npz``.
"""

import argparse
import os
import time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    import_globtraj_csv, make_oval_track)
from graphbasedlocaltrajectoryplanner_torch.utils.config import (
    read_track_name)
from graphbasedlocaltrajectoryplanner_torch.testing_tools.vdc_dummy import (
    vdc_dummy)

TOP = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ACTION_PRIORITY = ("right", "left", "straight", "follow")


def resolve_track(track: str):
    """Return (globtraj, csv_path_or_None)."""
    if track == "oval":
        return make_oval_track(), None
    if os.path.isfile(track):
        return import_globtraj_csv(track), track
    raise SystemExit(f"unknown track {track!r} (not 'oval', not a file)")


def start_pose(refline: np.ndarray):
    """The first reference-line point, heading along the line (0 = north)."""
    heading = float(np.arctan2(refline[1, 1] - refline[0, 1],
                               refline[1, 0] - refline[0, 0]) - np.pi / 2)
    return refline[0, :], heading


def tick_record(ltpl, sel_action: str, traj_set: dict) -> dict:
    """What a tick planned: the pursued action, the action set (host
    arrays) and its node chains."""
    return dict(sel=sel_action,
                traj_set={k: [np.array(t) for t in v]
                          for k, v in traj_set.items()},
                nodes={k: [[list(n) for n in chain] for chain in v]
                       for k, v in ltpl._oth.last_nodes.items()})


def drive(ltpl, pos_est, heading_est, ticks: int, clock=time.time,
          report_every: int = 20):
    """The example's closed loop on ``ltpl`` (``graph_init`` done): the
    vehicle dummy follows the pursued trajectory for the time ``clock``
    advanced since the previous tick (read once a tick).  Returns one
    :func:`tick_record` a tick."""
    ltpl.set_startpos(pos_est=pos_est, heading_est=heading_est)
    traj_set = {"straight": None}
    records = []
    tic = clock()
    for tick in range(ticks):
        now = clock()
        for sel_action in ACTION_PRIORITY:
            if sel_action in traj_set:
                break
        ltpl.calc_paths(prev_action_id=sel_action, object_list=[])
        if traj_set[sel_action] is not None:
            pos_est, vel_est = vdc_dummy(
                pos_est, traj_set[sel_action][0][:, 0],
                traj_set[sel_action][0][:, 1:3],
                traj_set[sel_action][0][:, 5], now - tic)
        else:
            vel_est = 0.0
        tic = now
        traj_set = ltpl.calc_vel_profile(pos_est=pos_est, vel_est=vel_est)[0]
        ltpl.visual()
        records.append(tick_record(ltpl, sel_action, traj_set))
        if report_every and tick % report_every == 0:
            print(f"tick {tick:4d}  action={sel_action:8s}  "
                  f"v={vel_est:5.1f} m/s  set={sorted(traj_set)}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", default=None)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--visual", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    track = args.track or read_track_name(TOP + "/params/driving_task.ini")
    gt, csv_path = resolve_track(track)

    path_dict = {
        "globtraj_input_path": csv_path or "oval",
        "graph_store_path": TOP + "/artifacts/stored_graph_torch.npz",
        "ltpl_offline_param_path": TOP + "/params/ltpl_config_offline.ini",
        "ltpl_online_param_path": TOP + "/params/ltpl_config_online.ini",
    }
    ltpl = GraphLTPL(path_dict, visual_mode=args.visual, log_to_file=False,
                     device="cpu" if args.cpu else None)
    ltpl.graph_init()
    drive(ltpl, *start_pose(gt.refline), args.ticks)
    print("done.")


if __name__ == "__main__":
    main()
