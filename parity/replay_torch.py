"""Replay a recorded reference run (a ``parity/fixtures/ref_*.npz`` fixture
of ``parity/run_reference.py``) through the PyTorch port's ``GraphLTPL``
and measure the per-tick trajectory deviation from the reference.

The port sees the reference's inputs: its recorded position and velocity
stream, its action-selection sequence and its deterministic clock
(``time.time`` faked, +0.1 s per tick).  The configuration is the
repository's own ``params/ltpl_config_{online,offline}.ini`` (the SQP
fixtures' online INI is ``parity/fixtures/ltpl_config_online_sqp.ini``),
and the lattice is built into a temporary directory.  Deviation metric and
report: those of ``parity/replay_tpu.py`` (the reference's trajectory
stations interpolated on the replayed one; the north star is 2 cm /
0.1 m/s).

A fixture needs its track: ``ref_unclosed_monteblanco_220.npz`` carries
its CSV in ``parity/fixtures/``; the closed tracks' CSVs of the other
fixtures are not in the repository, and their replay raises.

    python parity/replay_torch.py --ticks 60 --device cpu

(the default fixture is ``ref_unclosed_monteblanco_220.npz``).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOP = os.path.dirname(HERE)
if TOP not in sys.path:
    sys.path.insert(0, TOP)

from parity.replay_tpu import TICK_DT, FakeClock, compare_traj  # noqa: E402

PARAMS = os.path.join(TOP, "params")
SQP_ONLINE_INI = os.path.join(HERE, "fixtures", "ltpl_config_online_sqp.ini")
# the std-example blocked zone the recorder drove with (run_reference.py)
SAMPLE_ZONE = {"sample_zone": [
    [64, 64, 64, 64, 64, 64, 64, 65, 65, 65, 65, 65, 65, 65,
     66, 66, 66, 66, 66, 66, 66],
    [0, 1, 2, 3, 4, 5, 6, 0, 1, 2, 3, 4, 5, 6,
     0, 1, 2, 3, 4, 5, 6],
    np.array([[-20.54, 227.56], [23.80, 186.64]]),
    np.array([[-23.80, 224.06], [20.17, 183.60]])]}


def _track_csv(fix) -> str:
    """The fixture's track CSV inside the repository, or raise."""
    if "csv_path" in fix.files:
        csv = os.path.join(HERE, "fixtures",
                           os.path.basename(fix["csv_path"].item().decode()))
        if os.path.isfile(csv):
            return csv
    track = fix["track"].item().decode()
    raise FileNotFoundError(
        f"the track CSV of fixture {track!r} is not in the repository "
        "(only the unclosed Monteblanco track is)")


def replay(fixture_path, ticks=None, device=None, kernels: bool = True,
           verbose: bool = False):
    """Replay ``ticks`` ticks (default: all) of a fixture through
    ``GraphLTPL(device=device, kernels=kernels)``.  Returns ``(report,
    rows)`` as ``parity/replay_tpu.replay`` does."""
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    fix = np.load(fixture_path)
    n_ticks = int(fix["ticks"]) if ticks is None else ticks
    track = fix["track"].item().decode()
    csv_path = _track_csv(fix)
    vp_type = (fix["vp_type"].item().decode()
               if "vp_type" in fix.files else "fb")
    dyn_params = bool(fix["dyn_params"]) if "dyn_params" in fix.files \
        else False
    zone_normals = (np.asarray(fix["zone_normals"])
                    if "zone_normals" in fix.files else None)
    if dyn_params or zone_normals is not None:
        from parity import dyn_schedule as dynsch
    if "with_zone" in fix.files:
        with_zone = bool(fix["with_zone"])
    else:       # older fixtures: the _obj scenario carried the zone
        with_zone = any(k.endswith("_obj") for k in fix.files)
    zones = SAMPLE_ZONE if with_zone else None

    clock = FakeClock()
    real_time = time.time
    rows, missing, extra = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        path_dict = {
            "globtraj_input_path": csv_path,
            "graph_store_path": os.path.join(tmp,
                                             f"parity_lattice_{track}.npz"),
            "ltpl_offline_param_path": os.path.join(
                PARAMS, "ltpl_config_offline.ini"),
            "ltpl_online_param_path": (
                SQP_ONLINE_INI if vp_type == "sqp"
                else os.path.join(PARAMS, "ltpl_config_online.ini")),
        }
        time.time = clock.time
        try:
            ltpl = GraphLTPL(path_dict, visual_mode=False, log_to_file=False,
                             device=device, kernels=kernels)
            ltpl.graph_init()
            refline = np.loadtxt(csv_path, comments="#",
                                 delimiter=";")[:, 0:2]
            heading = float(np.arctan2(refline[1, 1] - refline[0, 1],
                                       refline[1, 0] - refline[0, 0])
                            - np.pi / 2)
            ltpl.set_startpos(pos_est=refline[0, :], heading_est=heading)
            for tick in range(n_ticks):
                sel = fix[f"t{tick:04d}_sel"].item().decode()
                okey = f"t{tick:04d}_obj"
                obj_list = ([{"X": r[0], "Y": r[1], "theta": r[2], "v": r[3],
                              "length": r[4], "id": int(r[5]),
                              "type": "physical"} for r in fix[okey]]
                            if okey in fix.files else [])
                if zone_normals is not None:
                    if tick < dynsch.NORMZONE_REMOVE_TICK:
                        ltpl._obj_zone = ltpl._obj_list_handler.update_zone(
                            zone_id="norm_zone", zone_data=zone_normals,
                            zone_type="normals")
                    elif tick == dynsch.NORMZONE_REMOVE_TICK:
                        ltpl._obj_zone = ltpl._obj_list_handler.update_zone(
                            zone_id=None, zone_data=None)
                ltpl.calc_paths(prev_action_id=sel, object_list=obj_list,
                                blocked_zones=zones)
                pos = fix[f"t{tick:04d}_pos"]
                vel = float(fix[f"t{tick:04d}_vel"])
                if dyn_params:
                    traj_set = ltpl.calc_vel_profile(
                        pos_est=pos, vel_est=vel,
                        vel_max=dynsch.vel_max_at(tick),
                        gg_scale=dynsch.gg_scale_at(tick),
                        local_gg=dynsch.local_gg_dict(
                            ltpl._oth.last_path_param),
                        incl_emerg_traj=True)[0]
                else:
                    traj_set = ltpl.calc_vel_profile(pos_est=pos,
                                                     vel_est=vel)[0]
                ref_actions = {k.split("_a_")[1] for k in fix.files
                               if k.startswith(f"t{tick:04d}_a_")}
                missing += [(tick, a) for a in
                            sorted(ref_actions - set(traj_set))]
                extra += [(tick, a) for a in
                          sorted(set(traj_set) - ref_actions)]
                for a in sorted(ref_actions & set(traj_set)):
                    rows.append((tick, a) + compare_traj(
                        fix[f"t{tick:04d}_a_{a}"],
                        np.asarray(traj_set[a][0], float)))
                    if verbose and tick % 25 == 0:
                        print(f"tick {tick:4d} {a:9s} d_pos="
                              f"{rows[-1][2] * 100:7.2f} cm  d_vel="
                              f"{rows[-1][3]:6.3f} m/s")
                clock.advance(TICK_DT)
        finally:
            time.time = real_time

    d_pos_all = np.array([r[2] for r in rows])
    d_vel_all = np.array([r[3] for r in rows])
    report = {
        "fixture": os.path.basename(str(fixture_path)),
        "ticks": n_ticks,
        "pairs_compared": len(rows),
        "actions_missing_in_port": missing,
        "actions_extra_in_port": extra,
        "max_d_pos_m": float(np.max(d_pos_all)),
        "p99_d_pos_m": float(np.percentile(d_pos_all, 99)),
        "mean_d_pos_m": float(np.mean(d_pos_all)),
        "max_d_vel_mps": float(np.max(d_vel_all)),
        "p99_d_vel_mps": float(np.percentile(d_vel_all, 99)),
        "max_d_pos_exec_m": float(np.max([r[4] for r in rows])),
        "max_d_vel_exec_mps": float(np.max([r[5] for r in rows])),
        "worst_tick": int(rows[int(np.argmax(d_pos_all))][0]),
    }
    return report, rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default=os.path.join(
        HERE, "fixtures", "ref_unclosed_monteblanco_220.npz"))
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--plain", action="store_true",
                    help="the plain PyTorch versions instead of the kernels")
    args = ap.parse_args()
    rep, _ = replay(args.fixture, ticks=args.ticks, device=args.device,
                    kernels=not args.plain, verbose=True)
    print(json.dumps(rep, indent=2, default=str))
