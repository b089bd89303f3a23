"""Devtool: where the SQP fleet tick's time goes — the port's counterpart of
the root ``profile_sqp.py``.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_sqp \\
        [--batch 1024] [--m 115] [--iters 5] [--cpu] [--track oval|CSV] \
        [--out artifacts]

Writes ``<out>/SQP_PROFILE_torch.json`` with
  * the fb tick, its ``until="assembly"`` cut (the prefix both backends
    share) and the sqp tick (the online INI's SQP window of 115 points,
    ``profile_stages.sqp_options``), each the mean of ``--iters`` ticks
    on the device clock (``profile_tick.time_ms``), and the sqp tick's
    replans per second: the ticks ``make_batched_tick`` returns, compiled
    on the card;
  * the warm sqp tick's device time by ``gltpl.*`` range and stage
    (``parallel/profiling.stage_timings_trace``, as
    ``testing_tools/profile_stages.py --sqp``, on the eager body; None on
    the CPU, where no device is traced);
  * :func:`trace_attribution` (the root ``profile_sqp.trace_attribution``,
    which the port's bench calls): the warm-started sqp tick's device ms
    by stage;
  * :func:`qp_micro`: the batched velocity QPs alone, ``ops/qp.qp_vel_profile``
    at the fleet shape (5 rows a scenario of ``--m`` points) at 60 and at 5
    ADMM iterations on the device clock, and from the two the time of one
    iteration and of the setup and factorisation.  On the card each solve
    is one launch of the ADMM kernel (``csrc/admm_vel.cu``).

Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_tick import (
    ROOT, describe, setup, time_ms)


def isolated_ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of one ``fn()`` run alone, over ``reps`` calls after one
    warm-up call: each call starts on an idle device and is timed between
    two CUDA events (the device clock) on the card, on the host clock on
    the CPU.  Back-to-back calls would let one call's host-side setup hide
    behind the previous call's device work."""
    fn()
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# the stage names of the root profile_sqp.SQP_SCOPES, where the port's
# profiling.SCOPE_TO_STAGE names them otherwise
SQP_STAGE_NAMES = {"velocity": "velocity_other"}


def trace_attribution(tick, scen, iters: int = 3):
    """Device ms of the warm-started sqp fleet tick ``tick`` on ``scen`` by
    stage
    (window, assembly, qp_setup, qp_factor, qp_iters, velocity_other,
    other), per tick: ``profiling.profiled_ticks`` on the tick's eager body
    (``tick.__wrapped__`` on the card; one tick under the profiler before
    the ``iters`` it records, each tick starting from the previous tick's
    profiles) and ``profiling.attribute``.

    :returns: dict(stage_ms, total_ms); None on the CPU, where no device is
        traced.  On the card a trace without device time raises.
    """
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    dev = scen.start_layer.device
    if dev.type != "cuda":
        return None
    prof, _, _ = profiling.profiled_ticks(cuda_graph.eager(tick), scen, iters,
                                          dev, warm_sqp=True)
    stage_ms, _, _ = profiling.attribute(prof.events(), iters)
    total = sum(stage_ms.values())
    if total <= 0:
        raise RuntimeError("trace_attribution: the profiler traced no "
                           "device time")
    return dict(stage_ms={SQP_STAGE_NAMES.get(k, k): round(v, 3)
                          for k, v in sorted(stage_ms.items())},
                total_ms=round(total, 3))


def qp_inputs(batch5: int, m: int, dev: torch.device):
    """The seeded QP rows of the root ``profile_sqp.qp_micro``: curvature
    uniform in +-0.05 1/m, 2.5 m elements, gg 10 m/s^2, a flat machine
    table, start speeds 15-40 m/s, warm start 20 m/s."""
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        kappa=f32(rng.uniform(-0.05, 0.05, (batch5, m))),
        el=f32(np.full((batch5, m), 2.5)),
        gg=f32(np.full((batch5, m, 2), 10.0)),
        machines=f32([[0.0, 5.0], [100.0, 5.0]]),
        v_start=f32(rng.uniform(15.0, 40.0, (batch5,))),
        x0=f32(np.full((batch5, m), 20.0)))


def qp_micro(batch5: int = 5120, m: int = 115, device=None,
             reps: int = 20) -> dict:
    """The batched velocity QPs alone at ``batch5`` rows of ``m`` points:
    ``qp_vel_profile`` at 60 and at 5 ADMM iterations (each the median of
    ``reps`` calls run alone, :func:`isolated_ms`), the time of one
    iteration and of setup + factorisation from the two, and the ADMM
    kernel's launches a solve (on the card)."""
    from graphbasedlocaltrajectoryplanner_torch import resolve_device
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    from graphbasedlocaltrajectoryplanner_torch.ops.qp import qp_vel_profile
    dev = resolve_device(device)
    d = qp_inputs(batch5, m, dev)

    def solve(iters):
        return qp_vel_profile(d["kappa"], d["el"], d["gg"], d["machines"],
                              70.0, d["v_start"], v_end=10.0, end_idx=m,
                              pin_idx=0, x0_v=d["x0"], iters=iters)[0]
    t = {iters: isolated_ms(lambda: solve(iters), reps, dev)
         for iters in (60, 5)}
    cuda_admm.admm_vel.launches = 0
    v = solve(60)
    per_iter = (t[60] - t[5]) / 55.0
    return dict(batch5=batch5, m=m, device=describe(dev), reps=reps,
                clock="device" if dev.type == "cuda" else "host",
                t_iters60_ms=round(t[60], 4), t_iters5_ms=round(t[5], 4),
                per_iteration_ms=round(per_iter, 5),
                setup_factor_ms=round(t[5] - 5.0 * per_iter, 4),
                admm_launches_per_solve=cuda_admm.admm_vel.launches,
                finite=bool(torch.isfinite(v).all()))


def main(argv=None) -> dict:
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_stages \
        import sqp_options

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--m", type=int, default=115,
                    help="points a QP row in qp_micro")
    ap.add_argument("--iters", type=int, default=5,
                    help="ticks a timing window")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--track", default="oval",
                    help="'oval' or a 12-column LTPL track CSV")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)

    lat, scen, dev, info = setup(args.track, args.batch, args.cpu, seed=3)
    rep = dict(device=info, track=args.track, batch=args.batch)
    tick_fb = sc.make_batched_tick(lat, device=dev)
    rep["fb_tick_ms"] = round(time_ms(lambda: tick_fb(scen), args.iters,
                                      dev), 3)
    tick_asm = sc.make_batched_tick(lat, device=dev, until="assembly")
    rep["assembly_cut_ms"] = round(time_ms(lambda: tick_asm(scen),
                                           args.iters, dev), 3)
    tick_sqp = sc.make_batched_tick(lat, device=dev, **sqp_options(lat))
    t_sqp = time_ms(lambda: tick_sqp(scen), args.iters, dev)
    rep["sqp_tick_ms"] = round(t_sqp, 3)
    rep["sqp_replans_per_sec"] = round(args.batch / t_sqp * 1e3, 1)
    rep["sqp_trace"] = profiling.stage_timings_trace(
        lat, scen, device=dev, **sqp_options(lat))
    rep["qp_micro"] = qp_micro(batch5=args.batch * 5, m=args.m, device=dev)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "SQP_PROFILE_torch.json"), "w") as fh:
        json.dump(rep, fh, indent=1)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
