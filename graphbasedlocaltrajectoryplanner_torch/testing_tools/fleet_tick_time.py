"""Host-clock time of the batched fleet tick on one NVIDIA GPU, for
comparing two checkouts of the repository on the same card, back to back.

    python3 fleet_tick_time.py --root CHECKOUT [--ticks 40] [--batch 1024]
        [--facade]

Imports the port from CHECKOUT (default: the checkout this file lies in),
builds its kernels, runs ``make_batched_tick`` on the default oval with one
opponent, and prints one line: the median and the quartiles of ``--ticks``
synchronised ticks in ms, the card and its power limit.  The tick is what
``make_batched_tick`` returns in that checkout: a CUDA graph a signature
where the port compiles it, op by op in checkouts from before.  With
``--facade`` it times the interactive facade instead, as ``chip_smoke.py``
does: a 100-tick real-clock drive on the default oval with a slower
opponent and a zone, ``calc_paths`` + ``calc_vel_profile`` per tick, p50
and p99 over ticks 5-99 (its lattice cache under
``artifacts/fleet_tick_time/`` of CHECKOUT).  Run the checkouts in turns (A, B, B, A): both are bound by the
host, whose speed drifts.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--facade", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fleet_tick_time: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if args.facade:
        facade_latency(args.root, card)
        return
    lat = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                           md5_params="oval").to("cuda")
    scen = sc.random_scenarios(lat, args.batch, seed=0, n_objects=1,
                               device="cuda")
    tick = sc.make_batched_tick(lat, device="cuda")
    for _ in range(3):
        tick(scen)
    ts = []
    for _ in range(args.ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick(scen)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    print(f"fleet tick oval_1opp B={args.batch} from {args.root} on {card}: "
          f"median {med:.2f} ms (quartiles {q1:.2f} - {q3:.2f}, "
          f"{args.ticks} ticks) = {args.batch / med * 1e3:.1f} replans/s",
          flush=True)


def facade_latency(root, card):
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    store = os.path.join(os.path.abspath(root), "artifacts",
                         "fleet_tick_time")
    os.makedirs(store, exist_ok=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": os.path.join(store, "oval.npz"),
          "ltpl_offline_param_path": os.path.join(
              here, "params/ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              here, "params/ltpl_config_online.ini"),
          "graph_log_id": "oval", "log_path": os.path.join(store, "logs")}
    ltpl = GraphLTPL(pd, device="cuda", log_to_file=False)
    ltpl.graph_init()
    h = ltpl._oth
    pos, heading = cl.start_pose(h.np_refline)
    timings = []
    cl.drive(ltpl, 100, pos, heading,
             cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl),
             cl.left_half_zone(h.np_nodes_in_layer), fake_clock=False,
             timings=timings)
    t = np.asarray(timings[5:]) * 1e3
    p50, p99 = np.percentile(t, [50, 99])
    print(f"facade latency oval from {root} on {card}: p50 {p50:.2f} ms "
          f"p99 {p99:.2f} ms (ticks 5-99)", flush=True)


if __name__ == "__main__":
    main()
