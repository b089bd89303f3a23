"""Benchmark of the port: full action-set replans a second on one card —
the counterpart of the root ``bench.py``.

    python -m graphbasedlocaltrajectoryplanner_torch.bench [--batch 1024] \\
        [--iters 20] [--seed 0] [--track oval|CSV] \\
        [--sweep 256,1024,2048,4096,8192] [--cpu] [--out artifacts]

One replan is all the reference does in one 100 ms tick (the path search
for every action and the velocity profiles): here one scenario of the
compiled fleet tick, ``parallel/scenario.make_batched_tick`` (on the card
one CUDA graph per input signature).  The baseline is the reference's real
time budget, 10 replans a second (``params/ltpl_config_online.ini``,
``calc_time_warn_threshold = 0.1``).

Sections, in the root bench's order (scenario seeds as offsets from
``--seed``, so that ``--seed 0`` makes the root bench's scenarios):
  a. headline: the fb tick on ``--batch`` scenarios with one opponent,
     one warm-up call (the capture), then 3 windows of ``--iters`` ticks,
     each ended by a device synchronise; the median window's replans/s;
     timed first in the process, before any other section captures;
  b. B=1 latency: :data:`LATENCY_CALLS` synchronised calls (p50, p99);
  c. 3 opponents with one prediction point each at 16 collision slots;
  d. the batch sweep ``--sweep``, ``max(3, min(iters, 32768 // b))`` ticks
     a window;
  e. the sqp backend (``vp_backend="sqp"``, ``sqp_m=115``), and the
     device time by stage of its warm-started eager tick
     (``profile_sqp.trace_attribution``);
  f. the stage times of the compiled tick's traced replays
     (``profiling.stage_timings``) and the device time by ``gltpl.*``
     range (``profiling.stage_timings_trace``), with the roofline's rates
     from the traced stages;
  g. the parity gate, ``testing_tools/cuda_parity.run(batch=128)`` (on the
     CPU at ``min(128, --batch)``: there it holds the plain versions
     against themselves).
Every timed section (a-f's prefixes) runs before every profiled reading
(b's device compute, d's traced window, e's stages, f's trace).  Each
section records its set-up (first call: warm-up and capture, its graphs'
pools, the peak of allocated memory), its input signatures and the kernel
launches it made (warm-up and capture: a replay runs no Python); its tick
is dropped and the allocator's cache emptied before the next section.

Writes ``<out>/BENCH_DETAILS_torch.json`` and prints every timing window,
then as its last line one JSON object: ``metric``, ``value``, ``unit``,
``vs_baseline`` and ``device``.  Runs on the card unless ``--cpu`` is
given (the plain PyTorch path, host clock: the metric is then named for
the CPU and no device reading is taken).  A section that fails raises; the
exit code is 1 when a gate of the parity run fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFLINE_INI = os.path.join(ROOT, "params", "ltpl_config_offline.ini")
BASELINE_REPLANS_PER_SEC = 10.0
METRIC = "full_action_set_replans_per_sec_per_chip"
METRIC_CPU = "full_action_set_replans_per_sec_on_cpu"
DETAILS = "BENCH_DETAILS_torch.json"
# the scenarios of each section: the root bench's seed (an offset from
# --seed) and options of random_scenarios (O_PAD = 16 collision slots)
SCENARIOS = dict(
    headline=dict(seed=0, n_objects=1),
    latency=dict(seed=1, n_objects=1),
    multi_opponent=dict(seed=2, n_objects=3, n_pred=1, o_pad=16),
    sqp=dict(seed=3, n_objects=1),
    sweep=dict(seed=5, n_objects=1),
)
SQP = dict(vp_backend="sqp", sqp_m=115)
WINDOWS = 3
PARITY_BATCH = 128
# synchronised calls of the B=1 latency: p99 then has 10 calls beyond it
LATENCY_CALLS = 1000
# ticks a window of the stage timings (fewer when --iters is smaller)
STAGE_ITERS = 10
KEYS = (
    "device", "track", "lattice", "batch", "iters", "seed", "build_s",
    "headline", "throughput_replans_per_sec",
    "latency", "single_replan_latency_ms_p50",
    "single_replan_latency_ms_p99", "single_replan_budget_ms",
    "single_replan_device_compute_ms",
    "multi_opponent", "collision_slots_headline",
    "multi_opponent_3veh_o16_replans_per_sec",
    "batch_sweep", "batch_sweep_replans_per_sec", "batch_sweep_note",
    "window_dp_gb_per_s_at_peak_batch",
    "sqp", "sqp_backend_replans_per_sec", "sqp_stages",
    "stages", "parity", "kernel_parity_ok", "cross_backend_max_dxy_m",
    "cross_backend_max_dv_mps", "cross_backend_sqp_max_dxy_m",
    "cross_backend_sqp_max_dv_mps", "seconds")


def lattice(track: str, store_dir: str):
    """The lattice of ``track`` (``"oval"``: ``make_oval_track()``, or a
    track CSV) under the repository's offline INI, through
    ``models/lattice.load_or_build`` (keyed by track and INI) in
    ``<store_dir>/bench_torch_lattices/``; on the CPU."""
    from graphbasedlocaltrajectoryplanner_torch.models.lattice import (
        load_or_build)
    name = "oval" if track == "oval" else \
        os.path.splitext(os.path.basename(track))[0]
    store = os.path.join(store_dir, "bench_torch_lattices", f"{name}.npz")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    return load_or_build(track, OFFLINE_INI, store, graph_id=name)[0]


def describe(dev: torch.device) -> dict:
    """The device of a run: on the card its name, ``nvidia-smi``'s line
    (``profile_tick.describe``) and power limit, which must be readable,
    and the card count."""
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        profile_tick)
    info = profile_tick.describe(dev)
    if dev.type != "cuda":
        return dict(platform="cpu", name="cpu", power_limit_w=None,
                    count=0, card=None)
    limit = info["card"].rsplit(",", 1)[-1].strip()
    if not limit.endswith(" W"):
        raise RuntimeError(f"nvidia-smi gave no power limit: {info['card']!r}")
    return dict(platform="gpu", name=info["kind"],
                power_limit_w=float(limit[:-2]),
                count=torch.cuda.device_count(), card=info["card"])


def scenarios(lat, section: str, batch: int, seed: int, dev):
    """The scenarios of ``section`` (:data:`SCENARIOS`) for ``--seed``."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    kw = dict(SCENARIOS[section])
    return sc.random_scenarios(lat, batch, seed=seed + kw.pop("seed"),
                               device=dev, **kw)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _release(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _check_out(out, batch: int, what: str):
    """A tick's result is usable: finite trajectories of the batch, some
    valid action."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    tr = out["trajs"]
    if tr.shape[:2] != (batch, sc.N_OUT) or not bool(torch.isfinite(tr).all()) \
            or not bool(out["valid"].any()):
        raise RuntimeError(f"{what}: bad tick result (trajs {tuple(tr.shape)}"
                           f", {int(out['valid'].sum())} valid actions)")


def first_call(tick, scen, dev) -> dict:
    """The tick's first call (on the card its warm-up and capture), timed
    on the host clock, with the kernel launches it made and, on the card,
    the peak of allocated memory over it and each graph's capture cost."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, launches = cuda_build.counted(lambda: tick(scen), dev)
    rep = dict(setup_s=time.perf_counter() - t0, launches=launches,
               peak_mem_bytes=None, graphs=None)
    if dev.type == "cuda":
        rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        rep["graphs"] = [dict(warmup_ms=c.warmup_ms, capture_ms=c.capture_ms,
                              pool_bytes=c.pool_bytes)
                         for c in tick.graphs.values()]
    return rep, out


def signatures(tick, dev):
    """The compiled tick's captured signatures; None where it is eager."""
    return len(tick.graphs) if dev.type == "cuda" else None


def timed_section(label: str, tick, scen, n: int, dev) -> dict:
    """One section: the first call, then :data:`WINDOWS` windows of ``n``
    ticks, each ended by a device synchronise; every window printed.  On
    the card every call must replay the one graph of the first."""
    batch = int(scen.start_layer.shape[0])
    rep, out = first_call(tick, scen, dev)
    _check_out(out, batch, label)
    dts = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(n):
            out = tick(scen)
        _sync(dev)
        dts.append(time.perf_counter() - t0)
    _check_out(out, batch, label)
    rates = [batch * n / dt for dt in dts]
    rep.update(batch=batch, ticks_per_window=n, windows_s=dts,
               window_replans_per_sec=rates,
               replans_per_sec=batch * n / float(np.median(dts)),
               signatures=signatures(tick, dev))
    print(f"{label}: B={batch}, {n} ticks a window: "
          + ", ".join(f"{dt * 1e3:.3f} ms ({r:.1f} replans/s)"
                      for dt, r in zip(dts, rates))
          + f"; median {rep['replans_per_sec']:.1f} replans/s; first call "
          f"{rep['setup_s']:.3f} s", flush=True)
    if dev.type == "cuda" and rep["signatures"] != 1:
        raise RuntimeError(f"{label}: {rep['signatures']} signatures")
    return rep


def latency_section(tick, scen, calls: int, dev) -> dict:
    """Section b: ``calls`` synchronised calls at batch 1, one graph."""
    rep, out = first_call(tick, scen, dev)
    _check_out(out, 1, "latency")
    lats = []
    for _ in range(calls):
        t0 = time.perf_counter()
        tick(scen)
        _sync(dev)
        lats.append((time.perf_counter() - t0) * 1e3)
    rep.update(calls=calls, p50_ms=float(np.percentile(lats, 50)),
               p99_ms=float(np.percentile(lats, 99)), max_ms=max(lats),
               signatures=signatures(tick, dev))
    print(f"latency: B=1, {calls} calls: p50 {rep['p50_ms']:.3f} ms, p99 "
          f"{rep['p99_ms']:.3f} ms, max {rep['max_ms']:.3f} ms", flush=True)
    if dev.type == "cuda" and rep["signatures"] != 1:
        raise RuntimeError(f"latency: {rep['signatures']} signatures")
    return rep


def _traced(st, what: str, dev):
    """A ``stage_timings_trace`` reading: on the card it must have traced
    device time."""
    if dev.type == "cuda" and st is None:
        raise RuntimeError(f"{what}: the profiler traced no device time")
    return st


def roofline(cum: dict, trace: dict) -> dict:
    """``stage_timings``' roofline with its rates from the traced stage
    times (device ms), as the root bench re-derives them: the window DP's
    and the assembly's rates scaled by the timed over the traced stage
    time, the velocity stage's ns a sequential step from its traced
    time."""
    roof = dict(cum["roofline"])
    timed, st = cum["stage_ms"], trace["stage_ms"]
    roof.update(
        window_logical_gb_per_s=roof["window_logical_gb_per_s"]
        * timed["window"] / st["window"],
        velocity_ns_per_step=st["velocity"] * 1e6
        / max(roof["velocity_sequential_steps"], 1),
        assembly_gflops_per_s=roof["assembly_gflops_per_s"]
        * timed["assembly"] / st["assembly"],
        note="rates from the traced stage times (device clock)")
    return roof


def run(lat, args, dev) -> dict:
    """Every section on ``lat`` (already on ``dev``); returns the details."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        cuda_parity, profile_sqp)
    t_run = time.perf_counter()
    on_card = dev.type == "cuda"
    d = dict(device=describe(dev), track=args.track,
             lattice=dict(L=lat.L, N=lat.N, S=lat.S, H=lat.H_max,
                          closed=bool(lat.closed)),
             batch=args.batch, iters=args.iters, seed=args.seed, build_s=None)
    print(f"device: {d['device']['card'] or 'cpu'}; lattice {d['lattice']}",
          flush=True)
    if on_card:
        from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build
        t0 = time.perf_counter()
        cuda_build.build_all()
        d["build_s"] = time.perf_counter() - t0

    def section(name, batch, tick_kw, n, label=None):
        scen = scenarios(lat, name, batch, args.seed, dev)
        tick = sc.make_batched_tick(lat, device=dev, **tick_kw)
        rep = timed_section(label or name, tick, scen, n, dev)
        return rep, scen, cuda_graph.eager(tick)

    # ---- a. headline: first in the process ---------------------------
    d["headline"], scen_a, _ = section("headline", args.batch, {},
                                       args.iters)
    d["throughput_replans_per_sec"] = d["headline"]["replans_per_sec"]
    _release(dev)

    # ---- b. B=1 latency ------------------------------------------------
    scen1 = scenarios(lat, "latency", 1, args.seed, dev)
    tick1 = sc.make_batched_tick(lat, device=dev)
    d["latency"] = latency_section(tick1, scen1, LATENCY_CALLS, dev)
    d["single_replan_latency_ms_p50"] = d["latency"]["p50_ms"]
    d["single_replan_latency_ms_p99"] = d["latency"]["p99_ms"]
    d["single_replan_budget_ms"] = 100.0
    del tick1
    _release(dev)

    # ---- c. 3 opponents, 16 collision slots ------------------------------
    n_half = max(args.iters // 2, 5)
    d["collision_slots_headline"] = int(scen_a.obj_pos.shape[1])
    d["multi_opponent"], _, _ = section("multi_opponent", args.batch, {},
                                        n_half)
    d["multi_opponent_3veh_o16_replans_per_sec"] = \
        d["multi_opponent"]["replans_per_sec"]
    _release(dev)

    # ---- d. batch sweep --------------------------------------------------
    d["batch_sweep"] = {}
    for b in args.sweep:
        nb = max(3, min(args.iters, 32768 // b))
        d["batch_sweep"][str(b)], _, _ = section("sweep", b, {}, nb,
                                                 f"sweep B={b}")
        _release(dev)
    rates = {int(k): v["replans_per_sec"]
             for k, v in d["batch_sweep"].items()}
    d["batch_sweep_replans_per_sec"] = {str(k): v for k, v in rates.items()}
    b_best = max(rates, key=rates.get)
    d["batch_sweep_note"] = (
        f"peak {rates[b_best]:.1f} replans/s at batch {b_best}; largest "
        f"batch {max(rates)} ({rates[max(rates)]:.1f} replans/s)")

    # ---- e. sqp backend --------------------------------------------------
    d["sqp"], scen_q, tick_q = section("sqp", args.batch, SQP, n_half)
    d["sqp_backend_replans_per_sec"] = d["sqp"]["replans_per_sec"]
    _release(dev)

    # ---- f. stage times of the compiled tick's traced replays -----------
    cum = profiling.stage_timings(lat, scen_a,
                                  iters=min(STAGE_ITERS, args.iters),
                                  device=dev)
    roof_host = cum.pop("roofline")
    _release(dev)

    # ---- profiled readings, after every timed section --------------------
    st1 = _traced(profiling.stage_timings_trace(lat, scen1, iters=5,
                                                device=dev),
                  "single replan", dev)
    d["single_replan_device_compute_ms"] = st1 and st1["total_ms"]
    scen_p = scenarios(lat, "sweep", b_best, args.seed, dev)
    stp = _traced(profiling.stage_timings_trace(lat, scen_p, iters=3,
                                                device=dev),
                  "peak batch", dev)
    d["window_dp_gb_per_s_at_peak_batch"] = stp and (
        b_best * 4 * lat.H_max * lat.N * lat.N * 4 / 1e9
        / (stp["stage_ms"]["window"] / 1e3))
    # the warm-started eager tick (each from the previous tick's profiles);
    # section e timed the compiled tick from cold profiles
    d["sqp_stages"] = profile_sqp.trace_attribution(tick_q, scen_q, iters=3)
    del tick_q
    trace = _traced(profiling.stage_timings_trace(lat, scen_a, iters=3,
                                                  device=dev),
                    "stages", dev)
    d["stages"] = dict(cumulative=cum, trace=trace,
                       roofline=trace and roofline(
                           dict(cum, roofline=roof_host), trace))
    _release(dev)

    # ---- g. parity gate --------------------------------------------------
    prep = cuda_parity.run(batch=PARITY_BATCH if on_card
                           else min(PARITY_BATCH, args.batch), lat=lat,
                           device=dev,
                           out=os.path.join(args.out, cuda_parity.REPORT))
    d["parity"] = dict(
        vacuous=prep["vacuous"], kernels_ok=prep["kernels_ok"],
        kernels={k: dict(equal=g["equal"], launches=g["launches"],
                         max_abs_diff=g["max_abs_diff"])
                 for k, g in prep["kernels"].items()},
        end_to_end=prep["end_to_end"], end_to_end_sqp=prep["end_to_end_sqp"],
        report=cuda_parity.REPORT)
    d["kernel_parity_ok"] = bool(prep["ok"])
    d["cross_backend_max_dxy_m"] = prep["end_to_end"]["max_dxy_m"]
    d["cross_backend_max_dv_mps"] = prep["end_to_end"]["max_dv_mps"]
    d["cross_backend_sqp_max_dxy_m"] = prep["end_to_end_sqp"]["max_dxy_m"]
    d["cross_backend_sqp_max_dv_mps"] = prep["end_to_end_sqp"]["max_dv_mps"]
    for k, g in prep["kernels"].items():
        print(f"parity {k}: equal={g['equal']} launches={g['launches']} "
              f"shapes={g['shapes']}", flush=True)
    for k in ("end_to_end", "end_to_end_sqp"):
        g = prep[k]
        print(f"parity {k}: max|d xy| {g['max_dxy_m']:.3g} m (bar "
              f"{g['bar_dxy']}), max|d v| {g['max_dv_mps']:.3g} m/s (bar "
              f"{g['bar_dv']}), valid equal {g['valid_sets_equal']}, "
              f"n_valid equal {g['n_valid_equal']}", flush=True)
    d["seconds"] = time.perf_counter() - t_run
    return d


def _sizes(text: str):
    return [int(b) for b in text.split(",") if b.strip()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20,
                    help="ticks a timing window of the headline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--track", default="oval",
                    help="'oval' or a 12-column LTPL track CSV")
    ap.add_argument("--sweep", type=_sizes, default=[256, 1024, 2048, 4096,
                                                     8192])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    lat = lattice(args.track, args.out).to(dev)
    d = run(lat, args, dev)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, DETAILS), "w") as fh:
        json.dump(d, fh, indent=1)
    value = d["throughput_replans_per_sec"]
    dv = d["device"]
    print(json.dumps({
        "metric": METRIC if dev.type == "cuda" else METRIC_CPU,
        "value": round(value, 1), "unit": "replans/s",
        "vs_baseline": round(value / BASELINE_REPLANS_PER_SEC, 1),
        "device": {k: dv[k] for k in ("platform", "name", "power_limit_w",
                                      "count")}}), flush=True)
    return d


if __name__ == "__main__":
    sys.exit(0 if main()["kernel_parity_ok"] else 1)
