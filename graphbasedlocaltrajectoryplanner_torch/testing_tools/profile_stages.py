"""Devtool: where the fleet tick's time goes on one NVIDIA GPU, by stage.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_stages \\
        [--sqp] [--batch 1024] [--iters 3]

The port's counterpart of the root ``profile_stages.py`` and of
``profile_sqp.trace_attribution``: builds the kernels and the default oval
lattice, runs ``parallel/profiling.stage_timings_trace`` on the fb fleet
tick (and, with ``--sqp``, on the warm sqp tick: the export window of 115
points, as the SQP INI gives it) and ``stage_timings`` on the fb tick, at
``--batch`` scenarios with one opponent each, and prints one JSON line
with both results, the host cost of one range (``range_us``), the ticks'
host times run in turns before the first profiler session and after the
last (``tick_ms_before``, ``tick_ms_after``), the card's name and its power
limit.  Needs a card.

Its readings are per ``gltpl.*`` range, so it reads the eager tick
(``tick.__wrapped__`` of ``make_batched_tick``, the body a CUDA-graph
replay runs without ranges), and so do its host times;
``stage_timings`` reads the compiled tick's traced replays (device ms by
range from timing events in the graph).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def sqp_options(lat) -> dict:
    """The SQP window of the online INI's ``vp_type=sqp`` planner: 115
    export points on the lattice's spline step, the tire window over the
    first 5 m at 10 m/s^2."""
    step = float(lat.sampled_resolution)
    return dict(vp_backend="sqp", sqp_m=115, sqp_step=step,
                tire_end_idx=int(np.ceil(0.1 * 50 / step)),
                tire_end_mps2=10.0)


def alternating_ms(ticks: dict, scen, rounds: int = 20) -> dict:
    """Median host time of each tick of ``ticks`` (name -> fleet tick), the
    ticks run in turns for ``rounds`` rounds, each synchronised; a sqp tick
    (its name starting with "sqp") starts warm from its previous profiles.
    The first two rounds are not counted."""
    warm, ms = {}, {name: [] for name in ticks}
    for _ in range(rounds + 2):
        for name, tick in ticks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tick(scen, **warm.get(name, {}))
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if name.startswith("sqp"):
                warm[name] = dict(sqp_x0=out["vx_sqp"])
    return {name: round(float(np.median(v[2:])), 3)
            for name, v in ms.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--sqp", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device")
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    cuda_build.build_all()
    lat = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                           md5_params="oval").to("cuda")
    scen = sc.random_scenarios(lat, args.batch, seed=0, n_objects=1,
                               device="cuda")
    ticks = {"fb": sc.make_batched_tick(lat, device="cuda").__wrapped__}
    if args.sqp:
        ticks["sqp"] = sc.make_batched_tick(lat, device="cuda",
                                            **sqp_options(lat)).__wrapped__
    rep = dict(card=card, device=torch.cuda.get_device_name(0),
               batch=args.batch, range_us=profiling.range_cost_us(),
               tick_ms_before=alternating_ms(ticks, scen),
               fb_trace=profiling.stage_timings_trace(lat, scen,
                                                      iters=args.iters),
               fb_stages=profiling.stage_timings(lat, scen))
    if args.sqp:
        rep["sqp_trace"] = profiling.stage_timings_trace(
            lat, scen, iters=args.iters, **sqp_options(lat))
    rep["tick_ms_after"] = alternating_ms(ticks, scen)
    print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
