"""All-tracks validation: build the lattice and drive a short closed loop on
each track — the port's counterpart of the JAX package's
``tools/validate_tracks.py``.

For every track it runs the full stack through ``GraphLTPL`` (offline
build, ``set_startpos``, then per tick ``calc_paths`` and
``calc_vel_profile`` with a dynamic opponent) and reports build time,
lattice shape, tick latency and action-set health.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.validate_tracks \\
        [--tracks oval CSV ...] [--tracks-dir DIR] [--ticks 40] \\
        [--report artifacts/validate_tracks_torch.md] [--store-dir DIR] \\
        [--force-rebuild] [--cpu]

By default it runs the in-repo unclosed Monteblanco CSV
(``parity/fixtures/traj_ltpl_unclosed_monteblanco.csv``) and the built-in
oval (``oval``).  Stored lattices and the report go under ``artifacts/``.
The planner runs on the card; ``--cpu`` runs its plain PyTorch path on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import glob
import os
import sys
import time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.models.track import (
    import_globtraj_csv, make_oval_track)
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools.closed_loop import (
    fake_time)
from graphbasedlocaltrajectoryplanner_torch.testing_tools.objectlist_dummy \
    import ObjectlistDummy
from graphbasedlocaltrajectoryplanner_torch.testing_tools.vdc_dummy import (
    vdc_dummy)
from graphbasedlocaltrajectoryplanner_torch.utils.veh_dyn import (
    import_veh_dyn_info)

TOP = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TRACKS = (os.path.join(
    TOP, "parity", "fixtures", "traj_ltpl_unclosed_monteblanco.csv"), "oval")
DEFAULT_REPORT = os.path.join(TOP, "artifacts", "validate_tracks_torch.md")
TICK_DT = 0.1


def run_track(csv_or_name: str, ticks: int, store_dir: str,
              force_rebuild: bool = False, *, device=None,
              kernels: bool = True, clock=None, records=None) -> dict:
    """The closed loop on one track (a CSV path, or ``"oval"``).

    :param clock: a ``closed_loop.StepClock`` (or any callable time
        source with a ``time()`` reading): the loop then runs under it,
        calling it once a tick, so that the planner's and the opponent's
        clocks advance one fixed step a tick.  Default the wall clock.
    :param records: a list that receives one record a tick in
        ``closed_loop.drive``'s format (``sel``, ``objects``, ``pos``,
        ``vel``, ``traj_set``, ``nodes``), for ``closed_loop.compare``.
    :returns: dict(name, start_ok, rl_points, layers, nodes, track_len_m,
        closed, build_s, ticks, mean_actions, empty_sets, tick_ms_p50,
        v_end), as the JAX package's ``run_track``.
    """
    if csv_or_name == "oval":
        name, gt = "oval", make_oval_track()
    else:
        name = os.path.basename(csv_or_name).replace("traj_ltpl_cl_", "") \
            .replace(".csv", "")
        gt = import_globtraj_csv(csv_or_name)
    path_dict = {
        "globtraj_input_path": csv_or_name,
        "graph_store_path": os.path.join(store_dir,
                                         f"validate_torch_{name}.npz"),
        "ltpl_offline_param_path": TOP + "/params/ltpl_config_offline.ini",
        "ltpl_online_param_path": TOP + "/params/ltpl_config_online.ini",
    }
    if force_rebuild and os.path.isfile(path_dict["graph_store_path"]):
        os.remove(path_dict["graph_store_path"])
    ax_max_machines = import_veh_dyn_info(
        ax_max_machines_import_path=TOP
        + "/inputs/veh_dyn_info/ax_max_machines.csv")[1]

    with (fake_time(clock) if clock is not None
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        ltpl = GraphLTPL(path_dict, visual_mode=False, log_to_file=False,
                         device=device, kernels=kernels)
        ltpl.graph_init()
        t_build = time.perf_counter() - t0
        lat = ltpl.lattice

        refline = gt.refline
        pos_est = refline[0, :]
        heading_est = float(np.arctan2(refline[1, 1] - refline[0, 1],
                                       refline[1, 0] - refline[0, 0])
                            - np.pi / 2)
        # set_startpos returns True when out of track (retry semantics)
        ok = not ltpl.set_startpos(pos_est=pos_est, heading_est=heading_est)

        obj_dummy = ObjectlistDummy(dynamic=True, vel_scale=0.3,
                                    s0=float(lat.s_rl[min(10, lat.L - 1)]),
                                    globtraj=gt)

        traj_set = {"straight": None}
        n_actions, tick_ms = [], []
        empty_sets = 0
        vel_est = 0.0
        for _ in range(ticks if ok else 0):
            sel_action = next((a for a in ("right", "left", "straight",
                                           "follow") if a in traj_set), None)
            if sel_action is None:
                # empty action set: recorded as a failure, stop the loop
                empty_sets += 1
                break
            if clock is not None:
                clock()
            obj_list = obj_dummy.get_objectlist()
            t1 = time.perf_counter()
            ltpl.calc_paths(prev_action_id=sel_action, object_list=obj_list)
            if traj_set[sel_action] is not None:
                pos_est, vel_est = vdc_dummy(
                    pos_est, traj_set[sel_action][0][:, 0],
                    traj_set[sel_action][0][:, 1:3],
                    traj_set[sel_action][0][:, 5], TICK_DT)
            else:
                vel_est = 0.0
            traj_set = ltpl.calc_vel_profile(
                pos_est=pos_est, vel_est=vel_est,
                ax_max_machines=ax_max_machines, incl_emerg_traj=True)[0]
            tick_ms.append((time.perf_counter() - t1) * 1e3)
            n_actions.append(len(traj_set))
            if records is not None:
                records.append(dict(
                    sel=sel_action, objects=copy.deepcopy(obj_list),
                    pos=pos_est, vel=vel_est,
                    traj_set={k: [np.array(t) for t in v]
                              for k, v in traj_set.items()},
                    nodes={k: [[list(n) for n in chain] for chain in v]
                           for k, v in ltpl._oth.last_nodes.items()}))
            if not traj_set:
                empty_sets += 1

    return dict(
        name=name,
        start_ok=bool(ok),
        rl_points=int(refline.shape[0]),
        layers=int(lat.L), nodes=int(lat.N),
        track_len_m=float(lat.s_rl[-1]),
        closed=bool(lat.closed),
        build_s=t_build,
        ticks=ticks,
        mean_actions=float(np.mean(n_actions)) if n_actions else 0.0,
        empty_sets=empty_sets,
        tick_ms_p50=float(np.percentile(tick_ms[1:] if len(tick_ms) > 1
                                        else tick_ms, 50))
        if tick_ms else float("nan"),
        v_end=float(vel_est),
    )


def table(rows) -> str:
    lines = ["| track | rl pts | layers | max nodes | length | closed | "
             "build [s] | actions/tick | empty sets | tick p50 [ms] | "
             "end vel [m/s] |", "|" + "---|" * 11]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['rl_points']} | {r['layers']} | "
            f"{r['nodes']} | {r['track_len_m']:.0f} m | "
            f"{'yes' if r['closed'] else 'no'} | {r['build_s']:.1f} | "
            f"{r['mean_actions']:.2f} | {r['empty_sets']} | "
            f"{r['tick_ms_p50']:.1f} | {r['v_end']:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracks", nargs="*", default=None,
                    help="'oval' and/or track CSV paths")
    ap.add_argument("--tracks-dir", default=None,
                    help="also every *.csv in this directory")
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--report", default=DEFAULT_REPORT,
                    help="the markdown results table's path")
    ap.add_argument("--store-dir", default=os.path.join(TOP, "artifacts"),
                    help="where the lattices are stored")
    ap.add_argument("--force-rebuild", action="store_true",
                    help="delete stored lattices first so the build column "
                         "reports cold offline-build times")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    tracks = list(args.tracks or [])
    if args.tracks_dir:
        csvs = sorted(glob.glob(os.path.join(args.tracks_dir, "*.csv")))
        if not csvs:
            print(f"no track CSVs in {args.tracks_dir}", file=sys.stderr)
            return 1
        tracks += csvs
    tracks = tracks or list(DEFAULT_TRACKS)
    os.makedirs(args.store_dir, exist_ok=True)
    device = "cpu" if args.cpu else None

    rows = []
    for track in tracks:
        print(f"=== {os.path.basename(track)} ===", flush=True)
        r = run_track(track, args.ticks, args.store_dir,
                      force_rebuild=args.force_rebuild, device=device)
        rows.append(r)
        print(f"  {r['name']}: L={r['layers']} N={r['nodes']} "
              f"len={r['track_len_m']:.0f} m closed={r['closed']} "
              f"build={r['build_s']:.1f} s  start_ok={r['start_ok']}  "
              f"actions/tick={r['mean_actions']:.2f} "
              f"empty={r['empty_sets']}  p50={r['tick_ms_p50']:.1f} ms "
              f"v_end={r['v_end']:.1f} m/s", flush=True)
    tab = table(rows)
    print(tab)
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as fh:
        fh.write("# Track validation (PyTorch port)\n\n"
                 f"Offline build + {args.ticks} online ticks with a dynamic "
                 "opponent on each track, `python -m graphbasedlocal"
                 "trajectoryplanner_torch.testing_tools.validate_tracks` on "
                 f"{'the CPU' if args.cpu else 'the card'}.\n\n" + tab
                 + "\n\nGenerated " + datetime.date.today().isoformat()
                 + ".\n")
    bad = [r["name"] for r in rows
           if not r["start_ok"] or r["empty_sets"] > 0]
    if bad:
        print(f"FAILED tracks: {bad}", file=sys.stderr)
        return 1
    print(f"all {len(rows)} tracks ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
