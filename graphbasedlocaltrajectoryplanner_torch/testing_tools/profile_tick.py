"""Devtool: stage timings and a profiler trace of the fb fleet tick — the
port's counterpart of the root ``profile_tick.py``.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_tick \\
        [--batch 1024] [--iters 5] [--no-trace] [--cpu] [--track oval|CSV] \\
        [--out artifacts]

Times progressively larger prefixes of the tick, cut by its ``until``
option: ``"decide"`` (obstacle selection, window DP, the decision tree),
``"assembly"`` (+ walk, C2-refit assembly, const splice) and the full tick
(+ velocity and emergency profiles), each the mean of ``--iters`` ticks
between two CUDA events on the card (the host clock on the CPU), and
derives the three stages from their differences.  The timed ticks are
what ``make_batched_tick`` returns: compiled on the card (one CUDA graph
a prefix), eager on the CPU.  Then writes a ``torch.profiler`` Chrome
trace of 3 ticks of the eager body (``tick.__wrapped__`` on the card; CPU
and device activity, the tick's ``gltpl.*`` ranges naming its stages,
which a graph replay does not show) to ``<out>/profile/<ts>/``, and the
report to ``<out>/TICK_PROFILE_torch.json``.

The lattice is the default oval (``--track oval``) or the one built from a
track CSV; the batch holds seeded scenarios with one opponent each.  Runs
on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREFIXES = ("decide", "assembly", None)


def setup(track: str, batch: int, cpu: bool, seed: int = 0):
    """(lattice, scenarios, device, device description) of a tool run: the
    lattice of ``track`` (``"oval"`` or a CSV path) on the card (the CPU
    with ``cpu``), ``batch`` seeded scenarios with one opponent each."""
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    dev = resolve_device("cpu" if cpu else None)
    gt = (tt.make_oval_track() if track == "oval"
          else tt.import_globtraj_csv(track))
    lat = tl.build_lattice(gt, OfflineConfig(),
                           md5_params=os.path.basename(track)).to(dev)
    scen = sc.random_scenarios(lat, batch, seed=seed, n_objects=1,
                               device=dev)
    return lat, scen, dev, describe(dev)


def describe(dev: torch.device) -> dict:
    """The device a run measured: on the card its name and what
    ``nvidia-smi`` says of it (name, power limit)."""
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", card=None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                card=card)


def time_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean ms of one ``fn()`` over ``iters`` calls after one warm-up call:
    between two CUDA events on the card (the device clock), on the host
    clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def prefix_timings(lat, scen, iters: int, dev: torch.device) -> dict:
    """ms of the tick cut at each of :data:`PREFIXES`, and the stages by
    difference (``window_decide``, ``assembly``, ``velocity``)."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    ms = {}
    for until in PREFIXES:
        tick = sc.make_batched_tick(lat, device=dev, until=until)
        ms[until or "tick"] = time_ms(lambda: tick(scen), iters, dev)
    B = int(scen.start_layer.shape[0])
    return dict(
        prefix_ms={k: round(v, 4) for k, v in ms.items()},
        stage_ms=dict(window_decide=round(ms["decide"], 4),
                      assembly=round(ms["assembly"] - ms["decide"], 4),
                      velocity=round(ms["tick"] - ms["assembly"], 4)),
        replans_per_sec=round(B / ms["tick"] * 1e3, 1))


def write_trace(lat, scen, dev: torch.device, trace_dir: str,
                iters: int = 3) -> dict:
    """A Chrome trace of ``iters`` eager fb ticks (after one under the
    profiler's schedule) in ``trace_dir``; returns its path and, on the
    card, its device kernels a tick."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    tick = cuda_graph.eager(sc.make_batched_tick(lat, device=dev))
    tick(scen)
    prof, wall_ms, _ = profiling.profiled_ticks(tick, scen, iters, dev)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    kernels = None
    if dev.type == "cuda":
        kernels = round(
            len(profiling.device_kernels(prof.events())) / iters, 2)
    return dict(path=path, ticks=iters, profiled_tick_ms=round(wall_ms, 3),
                device_kernels=kernels)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-trace", action="store_true",
                    help="skip the profiler trace, just time the prefixes")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--track", default="oval",
                    help="'oval' or a 12-column LTPL track CSV")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)

    lat, scen, dev, info = setup(args.track, args.batch, args.cpu)
    rep = dict(device=info, track=args.track, batch=args.batch,
               iters=args.iters, clock="device" if dev.type == "cuda"
               else "host", **prefix_timings(lat, scen, args.iters, dev))
    print(f"device={info['card'] or info['kind']}  batch={args.batch}  "
          f"track={args.track}")
    for k, v in rep["prefix_ms"].items():
        print(f"  until={k:10s} {v:10.3f} ms/tick")
    for k, v in rep["stage_ms"].items():
        print(f"  {k:16s} {v:10.3f} ms/tick")
    rep["trace"] = None
    if not args.no_trace:
        rep["trace"] = write_trace(lat, scen, dev, os.path.join(
            args.out, "profile", time.strftime("%Y%m%d_%H%M%S")))
        print(f"trace written to {rep['trace']['path']} (ranges gltpl.*)")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "TICK_PROFILE_torch.json"), "w") as fh:
        json.dump(rep, fh, indent=1)
    return rep


if __name__ == "__main__":
    main()
