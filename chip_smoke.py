"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``graphbasedlocaltrajectoryplanner_torch/csrc``
(nvcc, one process per source), builds the default oval lattice and the
unclosed Monteblanco lattice with the port's builder, then:

1. holds every kernel of the fleet tick against its plain PyTorch version
   on the inputs the tick gives it at batch 1024, bit-equal, with two
   times each — the device time of one launch (many launches captured in
   a CUDA graph and replayed between two CUDA events, so the host is not
   in the reading) and the time of one call of the wrapper — beside the
   least time the card could take for the same work; then holds both
   velocity-scan instances, the window DP and the slab-hit kernel against
   their plain versions, bit-equal, on seeded inputs at ragged shapes the
   main paths do not reach, the walk and the min-plus scan on the seeded
   cases of ``testing_tools/walk_cases``, the path assembly on those of
   ``testing_tools/assemble_cases``, and the velocity scans'
   branch-free division and square root (``csrc/ieee_fast.cuh``) against
   the plain operators on every float32 (the root, dividends over a few
   divisors) and on random pairs; times the walk alone on a table already
   on chip (``testing_tools/walk_variants.cu``), its chain floor;
2. runs the fleet tick (``make_batched_tick``) at batch 1024 in three
   mixes — default oval with 1 opponent, default oval with 3 opponents and
   16 collision slots, unclosed Monteblanco with 1 opponent — with the
   kernels and with the plain versions on the same card: ``valid``,
   ``h_eff``, ``cost``, ``n_valid``, ``case_a``, ``relabel`` and
   ``em_base`` equal, trajectories within 2 mm and 0.02 m/s, and every
   kernel's launch count above zero in the kernel tick; the window-DP,
   slab-hit and walk calls of the second and third mix are held against
   their plain versions and timed too.  On the card ``make_batched_tick``
   returns the compiled tick (one CUDA graph per input signature), whose
   replays run no Python: here and in 6, 8 and 11 the launches are counted
   and the kernel calls recorded on its eager body (``tick.__wrapped__``),
   the ticks timed are the compiled ones, and 12 holds the two equal;
3. runs the dense-window search (``pathgen.plan_window_dense`` and
   ``search.search_window``, B=1024 on the default oval with 1 opponent)
   through the min-plus kernel: the kernel bit-equal to its plain version,
   the dense frontiers and backpointers equal to ``plan_window_kernel``'s
   (the window-DP kernel), the search equal to its plain version;
4. drives the interactive facade (``GraphLTPL``) in closed loop on the
   card — default oval for 100 ticks with a slower opponent and a zone,
   unclosed Monteblanco into its track end — and replays the same input
   stream through ``GraphLTPL(kernels=False)``: action sets and node
   chains equal on every tick, trajectories within 2 mm and 0.02 m/s,
   every kernel of the path launched; on two recorded ticks every kernel
   call is held against its plain version.  On the card the facade runs
   its device steps as captured calls (one CUDA graph per input
   signature), whose replays run no Python: here and in 5-7, 9 and 11 the
   facade drives whose launches are counted or whose kernel calls are
   recorded run its eager calls (``cuda_graph.disabled()``), and 13 holds
   the two equal;
5. times the facade per tick (``calc_paths`` + ``calc_vel_profile``) on
   the real clock, on its eager calls;
6. the SQP velocity backend (``vp_type=sqp``): the ADMM kernel
   (``csrc/admm_vel.cu``: its warp design for n <= 128, its block design
   above, each line naming the one that ran) bit-equal to its plain
   version (``ops/qp.admm_vel_qp``) on the SQP fleet tick's, the SQP
   facade's and the SQP ladder's recorded calls and on the seeded ragged
   calls of ``testing_tools/admm_cases``, timed beside the kernel's first
   design, one block a row, on the same calls
   (``testing_tools/admm_variants.cu``), one row's chain floor, its bounds
   (67 TFLOP/s, and one add or multiply a lane and cycle, since it may not
   contract) and the plain version (and the plain version's kernel
   launches a solve); the fleet tick under
   ``vp_backend="sqp"`` at batch 1024, kernels against plain, and one warm
   sqp tick under ``torch.profiler``; the facade under the SQP INI on the
   oval (kernels against plain, tick by tick, latency per tick) and into
   the unclosed Monteblanco track end, where the SQP backup ladder
   (``brake_em_sqp_kernel``) brakes;
7. replays the recorded reference run ``ref_unclosed_monteblanco_220``
   through the facade with the kernels (``parity/replay_torch.py``) at the
   north-star bar (2 cm, 0.1 m/s);
8. the fleet tick's options at batch 1024 on the default oval with one
   opponent, kernels against plain on the same card, each kernel's
   launches per run: ``filt_window=5``, ``incl_emergency=False``,
   ``p_max`` one block of 64 rows above the default, the ``until``
   cutoffs ``"assembly"`` and ``"decide"``, and the sqp tick at that
   ``p_max`` (naming the ADMM design that ran); the stage profile
   (``parallel/profiling.py``): the fb and the warm sqp tick's device
   time, host time and launches by ``gltpl.*`` range, and the fb tick's
   stage times from its traced replays; the log replay
   (``utils/replay.py``) of the data log that the oval facade drive of 4
   wrote, with the kernels and with the plain versions, equal reports;
9. the host side: the min example's loop (``examples/main_min_example``,
   default oval) and the std example's (``examples/main_std_example``,
   unclosed Monteblanco with its opponent, zone and logging) through
   ``GraphLTPL()`` and ``GraphLTPL(kernels=False)`` under one fixed clock
   step, tick by tick as in 4; the log viewer
   (``visualization/log_viewer``) on the std loop's log and on the oval
   drive's of 4, validating with the kernels and with the plain versions
   (equal reports) and rendering a tick; the facade's visual mode drawing
   the min loop; both rendering steps only where matplotlib is installed
   (else it says so); the native library (``native.py``, built with g++
   here) as an oracle of the min-plus kernel's frontier and walk on the
   dense window and of the general velocity-scan kernel; ``profile_tick``'s
   prefix timings, ``profile_assembly``'s split and
   ``profile_sqp.qp_micro``;
10. the multi-device paths (``parallel/distributed.py``,
   ``make_sharded_tick``, ``parallel/spatial.py``): NCCL at world 1 in
   this process — ``make_sharded_tick`` at batch 1024 on the default oval
   with one opponent, kernels against plain, every field equal to
   ``make_batched_tick``'s, the fleet statistics out of an NCCL
   ``all_reduce``; then four ranks sharing the card over gloo (NCCL refuses
   two ranks on one device), fresh processes started after the kernels
   are built (``testing_tools/dist_cases``, size ``chip``): the ``dp=4``
   tick and the composed ``(dp=2, mp=2)`` tick at batch 1024 in all and
   ``spatial_window_dp`` with ``mp=4`` on 64 unclosed-Monteblanco
   scenarios, each rank's kernel run against its plain run, every rank's
   statistics equal, the gathered results against the unsharded tick and
   the spatial tables against ``plan_window_kernel``; the spatial path's
   ``hit_slab`` and ``minplus`` calls, recorded by rank 0, held against
   their plain versions and timed here; per part the ms of an eager tick
   a rank and the share of it in collectives;
11. the entry tools: ``entry()``'s fleet tick (the small oval, B=8) on the
   card, made by ``entry._entry_on`` once with the kernels and once with
   the plain versions over one lattice and the same scenarios (``valid``
   and ``cost`` equal, trajectories within 2 mm and 0.02 m/s, kernels 1-5
   launched); ``testing_tools/validate_tracks.run_track`` on its two
   default tracks (unclosed Monteblanco, the oval): 30 ticks with the
   kernels on the real clock (build time, tick p50, end velocity), then
   the first 10 ticks with the kernels and with the plain versions under
   one fixed clock step, their per-tick records held by
   ``closed_loop.compare`` (action sets and node chains equal on every
   tick, trajectories within 2 mm and 0.02 m/s); and
   ``entry.dryrun_multidevice(4, "gloo")``, four ranks sharing the card,
   each rank's three parts held against their plain runs on the same
   inputs (``dist_cases.tick_case`` and ``spatial_run``: exact fields,
   statistics and spatial tables equal, trajectories within 2 mm and
   0.02 m/s, the goal cost's walk equal) with their kernels launched, and
   its four numbers equal to those of the same dry run on the CPU;
12. the compiled fleet tick (``make_batched_tick`` on the card, captured by
   ``ops/cuda_graph.capture``) against its eager body
   (``tick.__wrapped__``), ``torch.equal`` on every output field: the
   three mixes of 2 on the capture's batch and on a batch made after the
   capture, with tick n's outputs unchanged by tick n+1; a 3-tick sqp
   warm-start chain; the options of 8 and a shared and a per-scenario zone
   mask; ``entry()``'s B=8 tick; then the fb tick at B=1024 and B=1 and the
   warm sqp tick, eager and compiled in turns (eager, compiled, compiled,
   eager; every window printed), each compiled tick's device kernels and
   busy share from a profiled replay (the fleet kernels among them, the
   path assembly exactly once in the fb replay), and what each signature
   cost to capture (warm-up, capture, graph pool) and its kernel nodes;
13. the compiled facade (``GraphLTPL`` on the card, its device steps
   captured by ``ops/cuda_graph.capture_on_card``) against the same
   facade's eager calls (``cuda_graph.disabled()``) on the compiled drive's
   inputs, ``np.array_equal`` on every tick's action keys, node chains and
   trajectories: the oval (100 ticks, fb; the second half captures no new
   signature), the oval under the SQP INI (40 ticks), unclosed Monteblanco
   into its end (fb ladder from layer 26, SQP ladder from layer 30; every
   ladder call on one signature); the signatures of each drive and what
   each cost to capture (warm-up, capture, graph pool); on the oval, fb and
   sqp, the latency per tick eager and compiled in turns on the real clock
   (eager, compiled, compiled, eager; p50 and p99), and one eager and one
   compiled tick under ``torch.profiler`` (device kernels, busy share, the
   host's share of the tick);
14. the compiled sharded tick and the compiled dense window:
   (a) NCCL at world 1 in this process, ``make_sharded_tick`` on the card
   compiled as one CUDA graph per signature holding its collectives — the
   data-parallel tick, the spatial tick on a ``(dp=1, mp=1)`` mesh and
   the data-parallel tick under per-scenario zones at batch 1024 on the
   default oval — each against its eager tick (``tick.__wrapped__``),
   ``torch.equal`` on every field and both statistics, on the capture's
   batch and on a batch made after the capture, tick n's outputs
   unchanged by tick n+1; the dp and spatial ticks eager and compiled in
   turns, a replay's device kernels, copies and NCCL kernels under
   ``torch.profiler`` (NCCL at world 1 launches no kernel for the tick's
   in-place reductions), its host-side collective calls (none) against
   the eager tick's, what each signature cost to capture; (b) phase 10's
   four gloo ranks: each rank's staged compiled ``dp=4``, ``(dp=2, mp=2)``
   and spatial ``mp=4`` ticks held against their eager ticks on the rank,
   ``torch.equal``, their ms eager and compiled, collective shares and
   graph pools; (c) ``plan_window_dense`` at batch 1024, compiled
   (captured as in 3, which freed its graph) against eager,
   ``torch.equal`` on ``best``, ``bp``, ``vg``, ``win_layers``,
   ``blocked`` and ``w_all``, timed in turns.
   Phases 3, 10 and 11 count launches on the eager bodies and read the
   eager sharded ticks' times; the ranks of 10 and 11 run the compiled
   ticks too;
15. the port's bench and its parity gate: one compiled fb replay at batch
   1024 under ``torch.profiler`` read with the session started at the
   call and after a warm-up step (the form of every profile in 2, 6, 12
   and 14: started at the call, a session lost the first kernels late in
   a run), twice each, kernel counts and busy ms; then ``python -m
   graphbasedlocaltrajectoryplanner_torch.bench`` with its defaults in a
   fresh process (after the kernels are built): exit 0, the five keys of
   its last line, every key of ``BENCH_DETAILS_torch.json``, one signature
   in every timed section, the fleet kernels launched by the headline's
   capture and ``admm_vel`` by the sqp section's, and its parity gate
   (``testing_tools/cuda_parity``): all eight kernels launched and
   ``torch.equal`` to their plain versions, the compiled fb and sqp ticks
   within their bars of the CPU oracle; prints the headline and its three
   windows, the B=1 percentiles, the sweep, the sqp rate, the stages and
   each gate's maxima.

The facade's lattice cache, logs and messages go to ``artifacts/chip_smoke/``
inside the checkout.

Prints the card and its power limit, per-kernel and per-mix lines, one
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure is an exception and a
non-zero exit; without a CUDA device it exits non-zero before printing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B = 1024
# published peaks of one H100 SXM (NVIDIA data sheet): HBM rate and
# float32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 adds or multiplies without contraction into FMAs (the ADMM kernel
# is built with -fmad=false and must round each on its own): one a lane and
# cycle, 132 SMs x 128 lanes x 1.98 GHz
PEAK_F32_NOFMA_OPS_S = 132 * 128 * 1.98e9
TPU = "graphbasedlocaltrajectoryplanner_tpu/ops/"
CSRC = "graphbasedlocaltrajectoryplanner_torch/csrc/"
KERNELS = [
    # name, wrapper module attr, source, TPU kernel replaced (the first
    # six run in the fleet tick, the next in the dense-window search)
    ("hit_slab", "cuda_collision.hit_slab", CSRC + "hit_slab.cu",
     TPU + "pallas_collision.py:112"),
    ("window_dp", "cuda_window.fused_window_dp", CSRC + "window_dp.cu",
     TPU + "pallas_window.py:379"),
    ("backtrace", "cuda_backtrace.backtrace_walk", CSRC + "backtrace.cu",
     TPU + "pallas_backtrace.py:69"),
    ("vel_scan_cgg", "cuda_velocity.vel_scan_cgg", CSRC + "vel_scan.cu",
     TPU + "pallas_velocity.py:357"),
    ("vel_scan", "cuda_velocity.vel_scan", CSRC + "vel_scan.cu",
     TPU + "pallas_velocity.py:160"),
    # no Pallas kernel: the JAX package assembles the paths in XLA
    ("assemble", "cuda_assemble.assemble_path", CSRC + "assemble.cu",
     "graphbasedlocaltrajectoryplanner_tpu/planner/pathgen.py:377"),
    ("minplus", "cuda_minplus.minplus_scan", CSRC + "minplus.cu",
     TPU + "pallas_minplus.py:90"),
    # no Pallas kernel: the JAX package's ADMM is a lax.scan in XLA
    ("admm_vel", "cuda_admm.admm_vel", CSRC + "admm_vel.cu",
     TPU + "qp.py:211"),
]
FLEET = ("hit_slab", "window_dp", "backtrace", "vel_scan_cgg", "vel_scan",
         "assemble")
# timed in every fleet mix and in the facade, beside their bounds
REDESIGNED = ("hit_slab", "window_dp", "backtrace", "assemble")
# the kernels of the interactive facade's path
FACADE = ("hit_slab", "window_dp", "backtrace", "vel_scan", "assemble")
# 100 of the fb oval drive's 150 earlier ticks: its plain replay was most
# of the run, and every action kind is reached by tick 15
FACADE_TICKS_OVAL = 100
# the SQP paths: the facade on the oval, and into the unclosed track's end
# from layer 30, where the SQP backup ladder brakes at ticks 52-56
SQP_TICKS_OVAL = 40
SQP_TICKS_UNCLOSED = 60
SQP_START_LAYER_UNCLOSED = 30
SQP_INI = "parity/fixtures/ltpl_config_online_sqp.ini"
REPLAY_FIXTURE = "parity/fixtures/ref_unclosed_monteblanco_220.npz"
# unclosed Monteblanco: from 85 m before the track end (layer 26) into the
# end, where the track is blocked and the backup brake profile takes over
FACADE_TICKS_UNCLOSED = 100
FACADE_START_LAYER_UNCLOSED = 26


def _check(ok, what):
    if not ok:
        raise RuntimeError(what)


def _sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _median_ms(fn, reps):
    """Median device time of one call, CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def _device_ms(fn, launches=20, replays=5):
    """Device time of one launch: ``launches`` calls of ``fn`` captured once
    in a CUDA graph, so that the device never waits for the host between
    them, the graph replayed between two CUDA events; the median over the
    replays, divided by the count.  The launches run back to back on the
    same inputs (the L2 cache is warm, as it is for a caller whose inputs
    the previous kernels just wrote)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _median_ms(graph.replay, replays) / launches


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---- bytes and operations each kernel's work needs, from its inputs --------

def _cost_hit_slab(args, out):
    samples, slab, pos, ref2, app = args
    S = samples.shape[3]
    n_edges = int(app.sum()) * 2 * samples.shape[1] * samples.shape[2]
    ops = n_edges * (S * 6 + 1)        # 2 sub, 2 mul, add, min per sample
    return _nbytes(samples, slab, pos, ref2, app, out), ops


def _cost_window_dp(args, out, H):
    w, zone, sl, sn, slab, hit, p_obs, in_win, obs, last, fac = args
    Bn, N = sl.shape[0], w.shape[1]
    ops = Bn * H * 4 * N * N * 2        # add + compare per (slot, n, m)
    return _nbytes(w, zone, sl, sn, slab, hit, p_obs, in_win, obs, last,
                   fac, *out), ops


def _cost_backtrace(args, out):
    bp, goal, heff, *slot = args[:4]
    # one 4-byte load and one compare per walked layer
    walked = int(heff.to(torch.int64).clamp(0, bp.shape[-2] - 1).sum())
    return walked * 4 + _nbytes(goal, heff, *slot, out), walked


_MODE_OPS = {0: 24, 1: 13, 2: 28}      # flops per step: FWD, BRAKE, BWD
_MODE_STREAMS = {0: 3, 1: 2, 2: 4}     # k/ds/v_lim streams read per step


def _cost_vel(args, out, const_gg):
    k1, T = args[0], args[0].shape[1]
    mode = args[5] if const_gg else args[9]
    counts = {m: int((mode == m).sum()) for m in (0, 1, 2)}
    gg_streams = {0: 2, 1: 2, 2: 4} if not const_gg else {0: 0, 1: 0, 2: 0}
    nbytes = sum(c * T * 4 * (_MODE_STREAMS[m] + gg_streams[m])
                 for m, c in counts.items())
    nbytes += k1.shape[0] * 8 + _nbytes(out)
    ops = sum(c * T * _MODE_OPS[m] for m, c in counts.items())
    return nbytes, ops


# float operations a resampled point (the refit's position, derivatives
# and curvature, the stored edge at two parameters, the heading's wrap;
# atan2 and pow one each) and a chain node (the system, the sweep, the
# Hermite coefficients)
_ASM_POINT_OPS, _ASM_NODE_OPS = 64, 48


def _cost_assemble(args, out):
    """Bytes: the outputs, each row's H + 1 packed edges (40 bytes each)
    and the index inputs; operations per point and per chain node."""
    packed, win, nodes, h_eff, psi, p_max = args
    R, Hp1 = nodes.shape
    nb = _nbytes(*_as_tuple(out), win, nodes, h_eff, psi) + R * Hp1 * 40
    return nb, R * (p_max * _ASM_POINT_OPS + Hp1 * _ASM_NODE_OPS)


def _as_tuple(out):
    """A kernel's outputs as a tuple (an assembly's dict in its order)."""
    if isinstance(out, dict):
        return tuple(out.values())
    return out if isinstance(out, tuple) else (out,)


def _call_shape(name, a):
    """The shape printed for a recorded call: its first input's (the node
    chains' for an assembly)."""
    return "x".join(str(d) for d in a[2 if name == "assemble" else 0].shape)


def _cost_minplus(w, start, best, bp):
    R, H, N, _ = w.shape
    return _nbytes(w, start, best, bp), R * H * N * N * 2   # add + compare


def ragged_vel_scans(chunk):
    """Both velocity-scan instances against the plain version, bit-equal,
    on seeded inputs (``testing_tools/vel_cases``): R and T around a warp
    and a chunk, the three modes in an irregular order, ``dyn_model_exp``
    1 and 1.5, machine tables of 2, 16 and 23 rows, zero-length tails and
    rows without a limit.  Returns the number of calls compared."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velocity
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        vel_cases as vc)
    n = 0
    for ri in range(len(vc.RAGGED_R)):
        for ti in range(len(vc.ragged_t(chunk))):
            for cgg in (False, True):
                case, R, T, exp = vc.ragged_case(ri, ti, cgg, chunk)
                t = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
                _check(len(set(case["mode"].tolist())) == min(R, 3),
                       "ragged case: a mode is missing")
                if cgg:
                    a = [t[k] for k in vc.CGG_ARGS] + [exp, 0.85, 1000.0,
                                                       10.0, 9.0]
                    ko = cuda_velocity.vel_scan_cgg(*a)
                    po = velops.stacked_vel_scan_cgg_auto(*a, kernels=False)
                else:
                    a = [t[k] for k in vc.GENERAL_ARGS] + [exp, 0.85, 1000.0]
                    ko = cuda_velocity.vel_scan(*a)
                    po = velops.stacked_vel_scan(*a)
                torch.cuda.synchronize()
                _check(ko.shape == (R, T + 1) and torch.equal(ko, po),
                       f"ragged vel_scan{'_cgg' if cgg else ''} R={R} T={T} "
                       f"exp={exp} M={len(case['machines'])}: max |kernel - "
                       f"plain| = "
                       f"{float((ko - po).abs().nan_to_num(1e9).max())}")
                n += 1
    # a one-row machine table (the facade's default), which the wrapper
    # passes as two knots
    case, R, T, exp = vc.ragged_case(2, 3, False, chunk)
    t = {k: torch.from_numpy(v).cuda() for k, v in case.items()}
    a = [t[k] for k in vc.GENERAL_ARGS] + [exp, 0.85, 1000.0]
    a[10] = torch.tensor([[100.0, 5.0]], device="cuda")
    ko = cuda_velocity.vel_scan(*a)
    po = velops.stacked_vel_scan(*a)
    torch.cuda.synchronize()
    _check(torch.equal(ko, po), "vel_scan with a one-row machine table: "
           f"max |kernel - plain| = {float((ko - po).abs().max())}")
    return n + 1


def _cost(name, a, kw, out):
    """(bytes, operations) that one recorded call of a kernel needs."""
    out_t = out if isinstance(out, tuple) else (out,)
    if name == "hit_slab":
        return _cost_hit_slab(a, out)
    if name == "window_dp":
        return _cost_window_dp(a, out_t, kw["h_max"])
    if name == "backtrace":
        return _cost_backtrace(a, out)
    if name == "assemble":
        return _cost_assemble(a, out)
    return _cost_vel(a, out, name == "vel_scan_cgg")


def _bound(nb, ops):
    """(bound ms, what bounds it) of that many bytes and operations."""
    t_b, t_o = nb / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def held_and_timed(name, where, kern, plain, a, kw, plain_reps=0):
    """One recorded call: the kernel held bit-equal to its plain version,
    then timed on the device and per wrapper call (the plain version too
    when ``plain_reps``), beside its bound.  Prints a line, returns the
    numbers."""
    po = plain(*a, **kw)
    po_t = _as_tuple(po)
    for x in po_t:
        _spoil(x.shape, x.dtype)
    ko = kern(*a, **kw)
    torch.cuda.synchronize()
    ko_t = _as_tuple(ko)
    err = max(float((x.double() - y.double()).abs().max())
              for x, y in zip(ko_t, po_t))
    for x, y in zip(ko_t, po_t):
        _check(x.shape == y.shape and torch.equal(x, y),
               f"{name} {where}: not bit-equal, max |kernel - plain| {err}")
    ms = _device_ms(lambda: kern(*a, **kw))
    wrapper_ms = _median_ms(lambda: kern(*a, **kw), 30)
    plain_ms = (_median_ms(lambda: plain(*a, **kw), plain_reps)
                if plain_reps else None)
    nb, ops = _cost(name, a, kw, ko)
    bound_ms, by = _bound(nb, ops)
    shape = _call_shape(name, a)
    rows = (a[1].shape[0] if name == "backtrace" else
            a[2].shape[0] if name == "assemble" else a[0].shape[0])
    print(f"kernel {name} {where} {rows} rows [{shape}]: "
          f"max|kernel-plain|={err:.3g} (bit-equal) kernel {ms:.4f} ms on "
          f"the device, {wrapper_ms:.4f} ms a wrapper call; "
          + (f"plain {plain_ms:.4f} ms " if plain_reps else "")
          + f"bound {bound_ms:.4f} ms ({by}: {nb} B, {ops} ops)", flush=True)
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bytes=nb,
                ops=ops, err=err)


def _spoil(shape, dtype):
    """Leave the allocator a freed block of the size of a kernel's output
    that holds neither a valid result nor zeros, so that what a kernel does
    not write shows in the comparison."""
    t = torch.empty(shape, dtype=dtype, device="cuda")
    t.reshape(-1).view(torch.uint8).fill_(0xA5)
    del t


def ragged_window_kernels():
    """The window-DP and the slab-hit kernel against their plain versions,
    bit-equal, on the seeded raw cases of ``testing_tools/window_cases``:
    batches and node counts around the kernels' tiles, windows that wrap a
    short closed track, open tracks near their end, obstacle steps and
    nodes at their extremes, tied and INF costs, clipped slab layers,
    objects exactly at their radius; and one case each repeated to a batch
    of more than 4096.  Returns the numbers of calls compared."""
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_collision,
                                                            cuda_window)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        window_cases as wc)

    def on_card(case, keys, wide):
        """The case's tensors; every other case with int64 indices, which
        the kernels read as they are."""
        ts = [torch.from_numpy(case[k]).cuda() for k in keys]
        return [t.long() if wide and t.dtype == torch.int32 else t
                for t in ts]
    def tiled(case, keys, times):
        """The case with its batch repeated: thousands of scenarios (the
        tables and a zone shared by all scenarios stay as they are)."""
        shared = [k for k in keys if k in ("w", "w_last_factors", "samples_xy")
                  or (k == "zone_block" and case[k].ndim == 2)]
        return dict(case, **{k: np.concatenate([case[k]] * times)
                             for k in keys if k not in shared})

    windows = list(wc.window_cases())
    windows.append((windows[2][0] + "-x32", tiled(
        windows[2][1], wc.WINDOW_ARGS, 32)))            # B = 4160
    hits = list(wc.hit_cases())
    hits.append((hits[2][0] + "-x16", tiled(
        hits[2][1], wc.HIT_ARGS, 16)))                  # B = 4112
    n_w = n_h = 0
    for label, case in windows:
        a = on_card(case, wc.WINDOW_ARGS, n_w % 2 == 1)
        kw = dict(closed=case["closed"], h_max=case["h_max"])
        po = cuda_window.fused_window_dp_plain(*a, **kw)
        for x in po:
            _spoil(x.shape, x.dtype)
        ko = cuda_window.fused_window_dp(*a, **kw)
        torch.cuda.synchronize()
        for what, x, y in zip(("best", "bp"), ko, po):
            _check(x.shape == y.shape and torch.equal(x, y),
                   f"ragged window_dp {label}: {what} differs in "
                   f"{int((x != y).sum())} of {x.numel()} places")
        n_w += 1
    for label, case in hits:
        a = on_card(case, wc.HIT_ARGS, n_h % 2 == 1)
        po = cuda_collision.hit_slab_plain(*a)
        _spoil(po.shape, po.dtype)
        ko = cuda_collision.hit_slab(*a)
        torch.cuda.synchronize()
        _check(ko.shape == po.shape and ko.dtype == po.dtype
               and torch.equal(ko.view(torch.uint8), po.view(torch.uint8)),
               f"ragged hit_slab {label}: differs in "
               f"{int((ko.view(torch.uint8) != po.view(torch.uint8)).sum())}"
               f" of {ko.numel()} bytes")
        n_h += 1
    return n_w, n_h


def ragged_walk_kernels():
    """The walk and the min-plus kernel against their plain versions,
    bit-equal, on the seeded raw cases of ``testing_tools/walk_cases``: rows
    around a warp and beyond 4,096, node counts around a warp and beyond
    64, horizons of 0, 1, H and beyond, DP and random tables, the slot
    form, tied, INF and overflowing costs; the index arrays as the case has
    them (int32 and int64 mixed), every other case all int64; output memory
    spoiled before each call.  And the first N = 24 min-plus case once more
    with its window 4 bytes off 16-byte alignment (the kernel's 4-byte
    ``cp.async`` path at an even N).  Returns the numbers of calls
    compared."""
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_backtrace,
                                                            cuda_minplus)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        walk_cases as kc)

    def index(x, wide):
        t = torch.from_numpy(x).cuda()
        return t.long() if wide else t

    def held(what, label, ko, po):
        for x, y in zip(ko, po):
            _check(x.shape == y.shape and torch.equal(x, y),
                   f"ragged {what} {label}: differs in "
                   f"{int((x != y).sum())} of {x.numel()} places")
    n_w = n_m = 0
    for i in range(len(kc.WALK_CASES)):
        label, case = kc.walk_label(i), kc.walk_case_at(i)
        bp, *idx = kc.walk_args(case)
        a = [torch.from_numpy(bp).cuda()] + [index(x, i % 2) for x in idx]
        po = cuda_backtrace.backtrace_walk_plain(*a)
        _spoil(po.shape, po.dtype)
        held("backtrace", label, (cuda_backtrace.backtrace_walk(*a),), (po,))
        n_w += 1
    misaligned = False
    for i in range(len(kc.MINPLUS_CASES)):
        label, case = kc.minplus_label(i), kc.minplus_case_at(i)
        w = torch.from_numpy(case["w_window"]).cuda()
        start = index(case["start_node"], i % 2)
        po = cuda_minplus.minplus_scan_plain(w, start)
        for x in po:
            _spoil(x.shape, x.dtype)
        held("minplus", label, cuda_minplus.minplus_scan(w, start), po)
        n_m += 1
        if w.shape[-1] == 24 and not misaligned:
            buf = torch.empty(w.numel() + 1, device="cuda")
            w_off = buf[1:].view(w.shape)
            w_off.copy_(w)
            for x in po:
                _spoil(x.shape, x.dtype)
            held("minplus", label + " (window 4 bytes off alignment)",
                 cuda_minplus.minplus_scan(w_off, start), po)
            misaligned = True
            n_m += 1
        del w
    torch.cuda.synchronize()
    return n_w, n_m


def ragged_assemble(lats):
    """The assembly kernel against its plain version, bit-equal, on the
    seeded calls of ``testing_tools/assemble_cases`` on each lattice of
    ``lats``: every horizon mode (1, about H/2, H_max, mixed), ``p_max``
    the tick's, 64 rows more and 200 rows fewer, the window one row a row
    and one a scenario, 4, 36 and 4,096 rows, the index tensors int64 and
    (every other call) int32; output memory spoiled before each call.
    Returns the number of calls compared."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_assemble
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        assemble_cases as ac)
    n = 0
    for lat in lats:
        packed = pg.packed_edge_table(lat)
        for h_mode in ac.H_MODES:
            for p_extra in (0, 64, -200):
                for shared in (False, True):
                    for rows in (4, 36, 4096):
                        a = ac.case(lat, packed, rows, h_mode, p_extra,
                                    shared, seed=n,
                                    index_dtype=(torch.int32 if n % 2
                                                 else torch.int64))
                        po = _as_tuple(cuda_assemble.assemble_path_plain(*a))
                        for x in po:
                            _spoil(x.shape, x.dtype)
                        ko = _as_tuple(cuda_assemble.assemble_path(*a))
                        for x, y in zip(ko, po):
                            _check(x.shape == y.shape and torch.equal(x, y),
                                   f"ragged assemble L={lat.L} {h_mode} "
                                   f"p_max {a[5]} shared={shared} R={rows}: "
                                   f"differs in {int((x != y).sum())} of "
                                   f"{x.numel()} places")
                        n += 1
    torch.cuda.synchronize()
    return n


def dense_window_inputs(lat, scen):
    """``(win_args, start4, shrink4)`` of the dense-window search over a
    fleet's scenarios: the arguments of ``plan_window_dense`` (no zone,
    the default last-path factors) and each scenario's start node and
    horizon-shrink flags in its four slots."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    B = scen.start_node.shape[0]
    obs = sc._select_obstacle(lat, scen)
    zone0 = torch.zeros((lat.L, lat.N), dtype=torch.bool, device="cuda")
    w_fac = torch.tensor([0.0, 0.5, 0.8], device="cuda")
    win_args = (lat, scen.start_layer, scen.start_node, zone0,
                scen.obj_pos, scen.obj_radius, scen.obj_active,
                obs["obs_layer"], obs["obs_node"], obs["obs_found"],
                scen.last_nodes, w_fac)
    start4 = scen.start_node.long()[:, None].expand(B, 4)
    shrink4 = torch.tensor([True, True, False, False],
                           device="cuda").expand(B, 4)
    return win_args, start4, shrink4


def _cost_admm(d, iters, n_out):
    """(bytes, operations) of one ADMM solve: the 11 input rows read once,
    ``n_out`` output tensors written once; per point and step 53 + 4 L
    float32 operations (L = ceil(log2 n) PCR levels; a division, a
    maximum or a minimum counts one), the band and its factor (12 + 8 L a
    point) and the residuals (20 a point) once."""
    n = d["q"].shape[-1]
    pts = d["q"].numel()
    levels = max(n - 1, 1).bit_length()
    ins = [d[k] for k in ("e", "f", "rho_acc", "rho_dec", "u_acc", "u_dec",
                          "rho_box", "q", "x0", "l_box", "u_box")]
    nb = _nbytes(*ins) + _nbytes(*n_out)
    ops = pts * (iters * (53 + 4 * levels) + 12 + 8 * levels + 20)
    return nb, ops


def admm_held_and_timed(where, d, kw, plain_reps=0, variant=None,
                        chain=None):
    """One recorded ADMM call: the kernel (with the duals) bit-equal to
    ``qp.admm_vel_qp`` on spoiled output memory, then timed on the device
    and per wrapper call (the plain version too when ``plain_reps``),
    beside the block design on the same call (``variant``, the launch of
    ``testing_tools/admm_variants.cu``), one row's chain floor (``chain``,
    ms) and both bounds: f32 operations at 67 TFLOP/s and at one add or
    multiply a lane and cycle.  Prints a line naming the design that ran,
    returns the numbers."""
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_admm,
                                                            cuda_build, qp)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        admm_variants as av)
    iters = kw.get("iters", 60)
    w_smooth = kw.get("w_smooth", 1e-4)
    px, pr = qp.admm_vel_qp(d, iters=iters, w_smooth=w_smooth)
    plain = (px, pr["r_prim"], pr["r_dual"], pr["y"])
    for x in plain:
        _spoil(x.shape, x.dtype)
    kx, kr = cuda_admm.admm_vel(d, iters=iters, w_smooth=w_smooth,
                                with_y=True)
    torch.cuda.synchronize()
    kern = (kx, kr["r_prim"], kr["r_dual"], kr["y"])
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(kern, plain))
    for what, a, b in zip(("x", "r_prim", "r_dual", "y"), kern, plain):
        _check(a.shape == b.shape and torch.equal(a, b),
               f"admm_vel {where}: {what} not bit-equal, max |kernel - "
               f"plain| {err}")

    def call():
        return cuda_admm.admm_vel(d, iters=iters, w_smooth=w_smooth)
    ms = _device_ms(call)
    wrapper_ms = _median_ms(call, 30)
    plain_ms = (_median_ms(lambda: qp.admm_vel_qp(d, iters=iters,
                                                  w_smooth=w_smooth),
                           plain_reps) if plain_reps else None)
    baseline_ms = (av.variant_ms(_device_ms, variant, cuda_build, "baseline",
                                 d, kw, cuda_admm.WARP_ROWS)
                   if variant is not None else None)
    nb, ops = _cost_admm(d, iters, (kx, kr["r_prim"], kr["r_dual"]))
    bound_ms, by = _bound(nb, ops)
    nofma_ms = max(ops / PEAK_F32_NOFMA_OPS_S, nb / PEAK_BYTES_S) * 1e3
    n = d["q"].shape[-1]
    design = cuda_admm.design(n)
    print(f"kernel admm_vel {where} {d['q'].numel() // n} "
          f"rows [{'x'.join(map(str, d['q'].shape))}] {iters} iterations, "
          f"{design} design: max|kernel-plain|={err:.3g} (x, r_prim, r_dual, "
          f"y bit-equal) kernel {ms:.4f} ms on the device, {wrapper_ms:.4f} "
          f"ms a wrapper call; "
          + (f"block design {baseline_ms:.4f} ms; "
             if baseline_ms is not None else "")
          + (f"faster than it: {ms < baseline_ms}; "
             if baseline_ms is not None else "")
          + (f"chain floor {chain:.4f} ms; " if chain is not None else "")
          + (f"plain {plain_ms:.4f} ms " if plain_reps else "")
          + f"bound {bound_ms:.5f} ms ({by}: {nb} B, {ops} ops), "
          f"{nofma_ms:.5f} ms without FMA", flush=True)
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, err=err,
                baseline_ms=baseline_ms, bound_nofma_ms=nofma_ms,
                design=design)


def plain_admm_launches(d, kw):
    """Device kernels the plain version launches for one solve of ``d``
    (``torch.profiler``), or None where the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile
    from graphbasedlocaltrajectoryplanner_torch.ops import qp
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        qp.admm_vel_qp(d, iters=kw.get("iters", 60),
                       w_smooth=kw.get("w_smooth", 1e-4))
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA"))
    return n or None


def ragged_admm():
    """The ADMM kernel against its plain version, bit-equal (x, r_prim,
    r_dual, y) on spoiled output memory, on the seeded calls of
    ``testing_tools/admm_cases``, a line each naming the design that ran.
    Returns the number of calls."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm, qp
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        admm_cases as ac)
    for i in range(len(ac.CASES)):
        d, iters = ac.case(i, "cuda")
        px, pr = qp.admm_vel_qp(d, iters=iters)
        plain = (px, pr["r_prim"], pr["r_dual"], pr["y"])
        for x in plain:
            _spoil(x.shape, x.dtype)
        kx, kr = cuda_admm.admm_vel(d, iters=iters, with_y=True)
        torch.cuda.synchronize()
        for what, a, b in zip(("x", "r_prim", "r_dual", "y"),
                              (kx, kr["r_prim"], kr["r_dual"], kr["y"]),
                              plain):
            _check(a.shape == b.shape and torch.equal(a, b),
                   f"ragged admm_vel {ac.label(i)}: {what} differs in "
                   f"{int((a != b).sum())} of {a.numel()} places")
        print(f"ragged admm_vel {ac.label(i)}, "
              f"{cuda_admm.design(ac.CASES[i][0])} design: x, r_prim, "
              f"r_dual, y bit-equal", flush=True)
    return len(ac.CASES)


def profile_device(fn):
    """``fn()`` under ``torch.profiler``, after one call of ``fn`` as the
    profiler's warm-up step (``profiling.profiled_ticks``' schedule: a
    session started at the call lost the first kernels of a compiled
    replay late in a run, phase 15): its device kernels (kernel events
    only: the aten ops that launch them carry the same device time again)
    as ``dict(n, busy_ms, top, ms_of, count_of)``, ``top`` the six longest
    by name, ``ms_of(word)`` and ``count_of(word)`` the device time and
    the number of the kernels whose name holds ``word``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return _kernel_summary(prof)


def profile_at_call(fn):
    """:func:`profile_device` with the session started at the call (no
    warm-up step): the reading phase 15 holds the warm-up form against."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_summary(prof)


def _kernel_summary(prof):
    """The device kernels of a finished ``torch.profiler`` run, as
    :func:`profile_device` returns them."""
    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the profiler also draws a device span per gltpl.* range and per
    # scheduled step (ProfilerStep#n): not kernels
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and self_dev_us(e) > 0
           and not e.key.startswith(("gltpl.", "ProfilerStep"))]
    top = sorted(dev, key=self_dev_us, reverse=True)[:6]
    return dict(
        n=sum(e.count for e in dev),
        busy_ms=sum(self_dev_us(e) for e in dev) / 1e3,
        top=[f"{e.key[:48]} x{e.count} {self_dev_us(e) / 1e3:.3f} ms"
             for e in top],
        ms_of=lambda word: sum(self_dev_us(e) for e in dev
                               if word in e.key) / 1e3,
        count_of=lambda word: sum(e.count for e in dev if word in e.key))


def _sqp_pd(store, tname, track):
    return {"globtraj_input_path": track,
            "graph_store_path": os.path.join(store, f"sqp_{tname}.npz"),
            "ltpl_offline_param_path": os.path.join(
                ROOT, "params/ltpl_config_offline.ini"),
            "ltpl_online_param_path": os.path.join(ROOT, SQP_INI),
            "graph_log_id": f"sqp_{tname}",
            "log_path": os.path.join(store, "logs")}


class Recorder:
    """Replaces kernel wrappers by recorders while in a ``with`` block: each
    call is passed on, and its arguments are cloned into ``calls[name]``
    while ``on`` is set.  A wrapper counts its launches through its module
    name, which is the recorder while it is in place; the counts are handed
    back to the wrapper on exit."""

    def __init__(self, targets):
        self.targets = targets          # name -> (owner module, attribute)
        self.calls = {name: [] for name in targets}
        self.on = True

    def __enter__(self):
        self.saved = []
        for name, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)

            def rec(*a, _o=orig, _n=name, **k):
                if self.on:
                    self.calls[_n].append((
                        tuple(x.clone() if torch.is_tensor(x) else x
                              for x in a), dict(k)))
                return _o(*a, **k)
            rec.launches = 0
            setattr(owner, attr, rec)
            self.saved.append((owner, attr, orig, rec))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig, rec in self.saved:
            setattr(owner, attr, orig)
            orig.launches += rec.launches
        return False


def _run_counted(wrapper, fn, eager=True):
    """``fn()`` with every kernel's launch count set to 0 just before it
    and read just after (synchronised), its compiled calls run eagerly
    (``cuda_graph.disabled``: a replay runs no Python and counts nothing);
    with ``eager=False`` they stay compiled, and the counts are those of
    the captures' warm-ups and captures, which put each kernel into its
    graph."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
    with (cuda_graph.disabled() if eager else contextlib.nullcontext()):
        out = fn()
    torch.cuda.synchronize()
    return out, {name: wrapper(path).launches for name, path, *_ in KERNELS}


def _held(label, out_k, out_p, exact, traj):
    """Kernel output against plain output: ``exact`` fields equal, the
    ``traj`` tensor within 2 mm (x, y and s columns) and 0.02 m/s (vx)."""
    for k in exact:
        _check(torch.equal(out_k[k], out_p[k]), f"{label}: {k} differs")
    d = (out_k[traj].double() - out_p[traj].double()).abs()
    _check(bool(torch.isfinite(out_k[traj]).all()), f"{label}: non-finite")
    if traj == "trajs":
        d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
    else:                                   # paths [x y psi kappa el]
        d_pos, d_vx = float(d[..., 0:2].max()), 0.0
    _check(d_pos <= 2e-3 and d_vx <= 0.02,
           f"{label}: deviates by {d_pos} m, {d_vx} m/s")
    return d_pos, d_vx


def options_phase(oval, scen, card, wrapper, fb_prof):
    """Phase 8 of the docstring: the fleet tick's options, kernels against
    plain, then the stage profile."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        profile_stages)
    exact = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel",
             "em_base")
    p_big = sc.default_p_max(oval) + 64
    fleet5 = set(FLEET)
    runs = [
        ("filt_window=5", dict(filt_window=5), exact, "trajs", fleet5),
        ("incl_emergency=False", dict(incl_emergency=False), exact,
         "trajs", fleet5),
        (f"p_max={p_big}", dict(p_max=p_big), exact, "trajs", fleet5),
        ("until=assembly", dict(until="assembly"),
         ("n_valid", "cost", "h_eff", "valid"), "paths",
         {"hit_slab", "window_dp", "backtrace", "assemble"}),
        ("until=decide", dict(until="decide"), ("src", "h_eff", "valid"),
         "h_eff", {"hit_slab", "window_dp"}),
    ]
    # the launches counted on the eager body (a replay runs no Python); the
    # compiled ticks of these options are phase 12's
    for label, kw, fields, traj, need in runs:
        tick_k = sc.make_batched_tick(oval, device="cuda", **kw).__wrapped__
        tick_p = sc.make_batched_tick(oval, device="cuda", kernels=False,
                                      **kw)
        out_k, counts = _run_counted(wrapper, lambda: tick_k(scen))
        _check(all(counts[k] > 0 for k in need),
               f"options {label}: a kernel was not launched: {counts}")
        out_p = tick_p(scen)
        torch.cuda.synchronize()
        d_pos, d_vx = _held(f"options {label}", out_k, out_p, fields, traj)
        shape = tuple(out_k[traj].shape)
        print(f"options tick oval_1opp B={B} {label} on {card}: kernel "
              f"launches { {k: v for k, v in counts.items() if v} }; "
              f"{', '.join(fields)} equal; {traj} {shape} max|d pos|="
              f"{d_pos:.3g} m max|d vx|={d_vx:.3g} m/s", flush=True)

    sqp_kw = dict(profile_stages.sqp_options(oval), p_max=p_big)
    tick_k = sc.make_batched_tick(oval, device="cuda", **sqp_kw).__wrapped__
    tick_p = sc.make_batched_tick(oval, device="cuda", kernels=False,
                                  **sqp_kw)
    rec = Recorder({"admm_vel": (cuda_admm, "admm_vel")})
    with rec:
        out_k, counts = _run_counted(wrapper, lambda: tick_k(scen))
    _check(all(counts[k] > 0 for k in ("hit_slab", "window_dp", "backtrace",
                                       "vel_scan", "admm_vel")),
           f"options sqp p_max={p_big}: a kernel was not launched: {counts}")
    out_p = tick_p(scen)
    torch.cuda.synchronize()
    d_pos, d_vx = _held(f"options sqp p_max={p_big}", out_k, out_p,
                        exact + ("qp_status",), "trajs")
    n = rec.calls["admm_vel"][0][0][0]["q"].shape[-1]
    print(f"options tick oval_1opp sqp B={B} p_max={p_big} on {card}: "
          f"kernel launches { {k: v for k, v in counts.items() if v} }; "
          f"equal fields and qp_status equal; trajs "
          f"{tuple(out_k['trajs'].shape)} max|d pos|={d_pos:.3g} m "
          f"max|d vx|={d_vx:.3g} m/s; admm_vel rows of n={n} points, "
          f"{cuda_admm.design(n)} design", flush=True)

    # the stage profile: device time by launching gltpl.* range
    t0 = time.perf_counter()
    traces = {"fb": profiling.stage_timings_trace(oval, scen),
              "sqp warm": profiling.stage_timings_trace(
                  oval, scen, **profile_stages.sqp_options(oval))}
    for name, tr in traces.items():
        _check(tr is not None, f"stage profile {name}: no device kernel")
        tot = sum(tr["stage_ms"].values())
        _check(abs(tot - tr["total_ms"]) <= 0.01 * tr["total_ms"],
               f"stage profile {name}: stages {tot} ms != {tr['total_ms']}")
        _check(tr["unmatched_launches"] == 0
               and all(tr["stage_ms"][k] > 0
                       for k in ("window", "assembly", "velocity")),
               f"stage profile {name}: not attributed: {tr}")
        print(f"stage profile tick oval_1opp {name} B={B} on {card}: "
              f"device {tr['total_ms']:.3f} ms a tick over "
              f"{tr['launches']} kernels; host {tr['tick_ms']:.3f} ms a "
              f"tick unprofiled, {tr['profiled_tick_ms']:.3f} ms profiled; "
              f"stages (ms) {tr['stage_ms']}; shares {tr['stage_share']}",
              flush=True)
        for scope, v in tr["scopes"].items():
            print(f"  scope {scope}: device {v['device_ms']:.4f} ms, host "
                  f"{v['host_ms']:.4f} ms, {v['launches']:g} launches a "
                  f"tick", flush=True)
    fb = traces["fb"]
    if fb_prof["n"]:
        ratio = fb["total_ms"] / fb_prof["busy_ms"]
        print(f"stage profile fb against phase 2's profile: "
              f"{fb['total_ms']:.3f} ms and {fb['launches']} kernels "
              f"against {fb_prof['busy_ms']:.3f} ms and {fb_prof['n']} "
              f"(ratio {ratio:.3f})", flush=True)
        _check(0.8 <= ratio <= 1.25,
               "stage profile fb: disagrees with the tick's profile")
    range_us = profiling.range_cost_us()
    print(f"gltpl ranges: {range_us:.2f} us of host time a range when no "
          f"profiler listens; {len(traces['fb']['scopes']) - 1} ranges a "
          f"fb tick, {len(traces['sqp warm']['scopes']) - 1} a sqp tick",
          flush=True)
    st = profiling.stage_timings(oval, scen)
    print(f"stage timings tick oval_1opp fb B={B} on {card} (device "
          f"clock, the compiled tick's traced replays; median of 10): "
          f"{st['stage_ms']} ms, "
          f"total {st['total_ms']} ms; shares {st['stage_share']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def log_replay_phase(data_csv, lat, card, wrapper):
    """Phase 8 of the docstring, last part: the oval facade drive's data
    log replayed with the kernels and with the plain versions."""
    import dataclasses
    from graphbasedlocaltrajectoryplanner_torch.utils import replay
    t0 = time.perf_counter()
    rep_k, counts = _run_counted(wrapper, lambda: (
        replay.replay_validate(data_csv, lat, device="cuda")))
    t_k = time.perf_counter() - t0
    rep_p = replay.replay_validate(data_csv, lat, device="cuda",
                                   kernels=False)
    _check(dataclasses.asdict(rep_k) == dataclasses.asdict(rep_p),
           f"log replay: kernel report {rep_k} != plain report {rep_p}")
    _check(rep_k.ticks > 0 and counts["window_dp"] > 0
           and counts["backtrace"] > 0,
           f"log replay: nothing re-planned ({rep_k.ticks} ticks, {counts})")
    print(f"log replay {os.path.basename(data_csv)} on {card}: "
          f"{rep_k.ticks} ticks, {rep_k.actions_checked} actions checked, "
          f"edge violations {rep_k.edge_violations}, node mismatches "
          f"{rep_k.node_mismatches} ({rep_k.node_mismatch_failures} "
          f"failures), ok={rep_k.ok}; kernel launches "
          f"{ {k: v for k, v in counts.items() if v} }; kernels "
          f"report == plain report; kernel replay {t_k:.1f} s", flush=True)


# phase 9: the example loops' lengths (the plain replays on the card take
# about 1.3 s a tick and are most of the phase)
MIN_EXAMPLE_TICKS = 30
STD_EXAMPLE_TICKS = 30
VISUAL_TICKS = 20
UNCLOSED_CSV = "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv"


def _example_pd(store, track, name, log=False):
    pd = {"globtraj_input_path": track,
          "graph_store_path": os.path.join(store, f"{name}.npz"),
          "ltpl_offline_param_path": os.path.join(
              ROOT, "params/ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              ROOT, "params/ltpl_config_online.ini")}
    if log:
        pd.update(log_path=os.path.join(store, "logs_examples"),
                  graph_log_id=f"{name}_example")
    return pd


def example_loops_phase(store, card, wrapper):
    """Phase 9 (a) and (b): the min example's loop on the default oval and
    the std example's on unclosed Monteblanco (opponent, zone, logging),
    each through ``GraphLTPL()`` and ``GraphLTPL(kernels=False)`` on the
    card under one fixed clock step, tick by tick.  Returns the std run's
    data log and archived lattice."""
    from graphbasedlocaltrajectoryplanner_torch.examples import (
        main_min_example as mex, main_std_example as sex)
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    from graphbasedlocaltrajectoryplanner_torch.utils.veh_dyn import (
        import_veh_dyn_info)
    csv = os.path.join(ROOT, UNCLOSED_CSV)
    machines = import_veh_dyn_info(ax_max_machines_import_path=os.path.join(
        ROOT, "inputs/veh_dyn_info/ax_max_machines.csv"))[1]
    gt_min, gt_std = tt.make_oval_track(), tt.import_globtraj_csv(csv)
    runs = [
        ("min", "oval", MIN_EXAMPLE_TICKS,
         lambda ltpl, n, clock: mex.drive(
             ltpl, *mex.start_pose(gt_min.refline), n, clock=clock,
             report_every=0)),
        ("std", csv, STD_EXAMPLE_TICKS,
         lambda ltpl, n, clock: sex.drive(
             ltpl, gt_std, n, machines, zones=sex.sample_zone(ltpl),
             clock=clock, report_every=0)),
    ]
    std_log = None
    for name, track, n, loop in runs:
        log = name == "std"
        recs, counts, secs = {}, None, {}
        for kernels in (True, False):
            ltpl = GraphLTPL(_example_pd(store, track, name, log),
                             log_to_file=log and kernels, device="cuda",
                             kernels=kernels)
            ltpl.graph_init()
            clock = cl.StepClock()
            t0 = time.perf_counter()
            with cl.fake_time(clock):
                if kernels:
                    recs[kernels], counts = _run_counted(
                        wrapper, lambda: loop(ltpl, n, clock))
                    if log:
                        std_log = (ltpl._path_dict["graph_log_data_path"],
                                   ltpl._path_dict["graph_log_path"])
                else:
                    recs[kernels] = loop(ltpl, n, clock)
            secs[kernels] = time.perf_counter() - t0
        _check(all(counts[k] > 0 for k in FACADE),
               f"{name} example: a kernel was not launched: {counts}")
        d_pos, d_vx, seen = cl.compare(recs[True], recs[False])
        _check(d_pos <= 2e-3 and d_vx <= 0.02,
               f"{name} example: trajs deviate by {d_pos} m, {d_vx} m/s")
        for r in recs[True]:
            for trajs in r["traj_set"].values():
                for t in trajs:
                    _check(t.ndim == 2 and t.shape[1] == 7
                           and bool(np.isfinite(t).all()),
                           f"{name} example: bad trajectory {t.shape}")
        print(f"example {name} {n} ticks ({os.path.basename(track)}, fixed "
              f"clock step {cl.TICK_DT} s) on {card}: kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }; action sets and "
              f"node chains equal on every tick, actions {sorted(seen)}, "
              f"last pursued {recs[True][-1]['sel']}; max|d s,x,y|="
              f"{d_pos:.3g} m max|d vx|={d_vx:.3g} m/s; kernel loop "
              f"{secs[True]:.1f} s, plain loop {secs[False]:.1f} s",
              flush=True)
    return std_log


def viewer_phase(store, card, wrapper, std_log, oval_log, plot):
    """Phase 9 (c): the log viewer on the std example's log (the last tick
    rendered to a PNG when ``plot``) and on the oval facade drive's log
    (its object-free tick 5 rendered with its badge): the whole-log
    validation with the kernels and with the plain versions, equal
    reports."""
    import contextlib
    import dataclasses
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.visualization import (
        log_viewer)
    for name, (data, lattice), tick in (("std_example", std_log, -1),
                                        ("oval_facade", oval_log, 5)):
        png = os.path.join(store, f"viewer_{name}.png")
        lat = tl.load_lattice(lattice).to("cuda")
        # the viewer prints its report: the line below says what it held
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            if plot:
                rep_k, counts = _run_counted(wrapper, lambda: (
                    log_viewer.main(["--data", data, "--lattice", lattice,
                                     "--tick", str(tick), "--out", png,
                                     "--validate"])))
            else:
                rep_k, counts = _run_counted(
                    wrapper, lambda: log_viewer.validate_log(data, lat))
            rep_p = log_viewer.validate_log(data, lat, kernels=False)
        _check(dataclasses.asdict(rep_k) == dataclasses.asdict(rep_p),
               f"viewer {name}: kernel report {rep_k} != plain {rep_p}")
        _check(rep_k.ticks > 0 and rep_k.actions_checked > 0,
               f"viewer {name}: nothing validated: {rep_k}")
        if name == "oval_facade":
            _check(all(counts[k] > 0 for k in ("hit_slab", "window_dp",
                                               "backtrace")),
                   f"viewer {name}: the re-planning kernels did not run: "
                   f"{counts}")
        shown = "not rendered"
        if plot:
            _check(os.path.getsize(png) > 10_000, f"viewer {name}: no PNG")
            shown = f"tick {tick} rendered with its badge to {png}"
        print(f"viewer {name} {os.path.basename(data)} on {card}: "
              f"{rep_k.ticks} ticks, {rep_k.actions_checked} actions, edge "
              f"violations {rep_k.edge_violations}, node mismatches "
              f"{rep_k.node_mismatches}, ok={rep_k.ok}; kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }; kernels report "
              f"== plain report; {shown}", flush=True)


def visual_phase(store, card):
    """Phase 9 (d): a visual facade drives the min example's loop and saves
    its last frame."""
    from graphbasedlocaltrajectoryplanner_torch.examples import (
        main_min_example as mex)
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    t0 = time.perf_counter()
    ltpl = GraphLTPL(_example_pd(store, "oval", "min"), visual_mode=True,
                     log_to_file=False, device="cuda")
    ltpl.graph_init()
    clock = cl.StepClock()
    with cl.fake_time(clock):
        mex.drive(ltpl, *mex.start_pose(tt.make_oval_track().refline),
                  VISUAL_TICKS, clock=clock, report_every=0)
    png = os.path.join(store, "visual_last_frame.png")
    ltpl._plot_handler.save(png)
    _check(ltpl._plot_handler._tick_no == VISUAL_TICKS
           and os.path.getsize(png) > 10_000, "visual: no frame drawn")
    ltpl._plot_handler._plt.close("all")
    print(f"visual: {VISUAL_TICKS} ticks of the min example drawn on "
          f"{card}, last frame {png} ({os.path.getsize(png)} B); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def native_phase(card, wrapper, dense, sw, start4, h_goal4, shrink4):
    """Phase 9 (e): the native library built on this machine, its scalar
    oracles against the kernels: ``minplus_dp`` on 16 scenarios of the
    dense window (4 slots each) against the min-plus kernel's frontier and
    the walk, ``fb_profile`` on 8 seeded rows against the general
    velocity-scan kernel."""
    from graphbasedlocaltrajectoryplanner_torch import native
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    t0 = time.perf_counter()
    lib = native.build()
    t_build = time.perf_counter() - t0
    w_all = dense["w_all"][:16].cpu().numpy()
    vg = dense["vg"][:16].cpu().numpy()
    st, hg, sh = (x[:16].cpu().numpy() for x in (start4, h_goal4, shrink4))
    h_k, c_k = sw["h_eff"][:16].cpu().numpy(), sw["cost"][:16].cpu().numpy()
    d_cost, n_feas = 0.0, 0
    for b in range(w_all.shape[0]):
        for s in range(4):
            h, nodes, cost = native.minplus_dp(w_all[b, s], vg[b, s],
                                               st[b, s], hg[b, s],
                                               shrink=bool(sh[b, s]))
            _check(h == int(h_k[b, s]), f"native minplus_dp scenario {b} "
                   f"slot {s}: h_eff {h} != kernel {h_k[b, s]}")
            if h >= 1:
                n_feas += 1
                d = abs(cost - float(c_k[b, s]))
                d_cost = max(d_cost, d)
                _check(d < 1e-2, f"native minplus_dp scenario {b} slot {s}:"
                       f" cost {cost} != kernel {c_k[b, s]}")
    _check(n_feas > 0, "native minplus_dp: no feasible row")
    rng = np.random.default_rng(9)
    P, R = 200, 8
    kappa = rng.normal(0, 0.01, (R, P))
    el = np.full((R, P), 2.5)
    gg = rng.uniform(8.0, 12.0, (R, P, 2))
    machines = np.array([[0.0, 5.0], [60.0, 3.0]])
    v_start = rng.uniform(5.0, 30.0, R)
    ref = np.stack([native.fb_profile(kappa[r], el[r], gg[r], machines,
                                      60.0, v_start[r], v_end=10.0)
                    for r in range(R)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    args = (f32(kappa), f32(el), f32(gg), f32(machines), 60.0, f32(v_start))
    v_k, counts = _run_counted(wrapper, lambda: velops.calc_vel_profile_fb(
        *args, v_end=10.0))
    v_p = velops.calc_vel_profile_fb(*args, v_end=10.0, kernels=False)
    _check(counts["vel_scan"] == 2, f"native fb_profile: {counts}")
    _check(torch.equal(v_k, v_p), "fb profile: kernel != plain")
    v_k = v_k.double().cpu().numpy()
    err = float(np.max(np.abs(v_k - ref)))
    _check(np.allclose(v_k, ref, rtol=1e-4, atol=1e-3),
           f"native fb_profile against the vel_scan kernel: max |d| {err}")
    print(f"native {os.path.basename(str(lib))} built in {t_build:.1f} s "
          f"(g++ {' '.join(native.CXX_FLAGS)}) on {card}: minplus_dp on "
          f"{w_all.shape[0]} scenarios x 4 slots: h_eff equal to the kernels'"
          f" ({n_feas} feasible), max |d cost| {d_cost:.3g}; fb_profile on "
          f"{R} rows of {P} points against the vel_scan kernel (2 launches, "
          f"bit-equal to its plain version): max |d v| {err:.3g} m/s "
          f"(rtol 1e-4, atol 1e-3)", flush=True)


def profile_tools_phase(oval, scen, card, wrapper):
    """Phase 9 (f): ``profile_tick``'s prefix timings (3 ticks each, device
    clock), ``profile_assembly``'s split and ``profile_sqp.qp_micro`` at
    the fleet shape."""
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        profile_assembly, profile_sqp, profile_tick)
    dev = torch.device("cuda")
    pt = profile_tick.prefix_timings(oval, scen, 3, dev)
    print(f"profile_tick oval_1opp B={B} on {card} (device clock, mean of 3"
          f" ticks): until {pt['prefix_ms']} ms; stages {pt['stage_ms']} "
          f"ms; {pt['replans_per_sec']} replans/s", flush=True)
    pa = profile_assembly.split(oval, scen, dev, 3)
    _check(pa["assembly"]["device_ms"] > 0 and pa["assemble_top"]
           and pa["unmatched_launches"] == 0,
           f"profile_assembly: nothing attributed: {pa}")
    print(f"profile_assembly oval_1opp B={B} on {card} (a tick of "
          f"until=assembly, {pa['tick_ms']} ms profiled): "
          + "; ".join(f"{k} device {v['device_ms']} ms host {v['host_ms']} "
                      f"ms {v['launches']:g} launches"
                      for k, v in list(pa["scopes"].items())
                      + [("assembly", pa["assembly"]),
                         ("rest", pa["rest"])]), flush=True)
    for r in pa["assemble_top"]:
        name = r["name"].replace("void ", "").replace("at::native::", "")
        print(f"  assemble kernel {r['ms']} ms x{r['launches']:g}: "
              f"{name[:150]}", flush=True)
    q, counts = _run_counted(wrapper, lambda: profile_sqp.qp_micro(
        5 * B, 115, device="cuda"))
    _check(q["finite"] and q["admm_launches_per_solve"] == 1
           and counts["admm_vel"] > 0, f"qp_micro: {q}")
    print(f"qp_micro {q['batch5']} rows x {q['m']} points on {card}: "
          f"60 iterations {q['t_iters60_ms']} ms, 5 iterations "
          f"{q['t_iters5_ms']} ms (device clock, median of {q['reps']} "
          f"calls, each alone); "
          f"{q['per_iteration_ms']} ms an iteration, setup + factor "
          f"{q['setup_factor_ms']} ms; {q['admm_launches_per_solve']} "
          f"admm_vel launch a solve", flush=True)
    return pa, q


def host_side_phase(store, card, wrapper, oval, scen, oval_log, dense_ctx):
    """Phase 9 of the docstring."""
    import importlib.util
    t0 = time.perf_counter()
    plot = importlib.util.find_spec("matplotlib") is not None
    if plot:
        import matplotlib
        matplotlib.use("Agg")
    else:
        print("visual: matplotlib not installed", flush=True)
    std_log = example_loops_phase(store, card, wrapper)
    viewer_phase(store, card, wrapper, std_log, oval_log, plot)
    if plot:
        visual_phase(store, card)
    native_phase(card, wrapper, *dense_ctx)
    profile_tools_phase(oval, scen, card, wrapper)
    print(f"host side phase: {time.perf_counter() - t0:.1f} s", flush=True)


def multi_device_phase(card, wrapper, oval, mb):
    """Phase 10 of the docstring.  Returns each kernel's launches a rank
    in each part and the spatial path's recorded calls' numbers."""
    import torch.distributed as dist
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_collision, cuda_minplus)
    from graphbasedlocaltrajectoryplanner_torch.parallel import (
        distributed as tdist)
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        dist_cases as dc)
    t_phase = time.perf_counter()
    exact = dc.EXACT

    def _ms(fn, reps=10):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    # (a) NCCL at world 1, in this process
    t0 = time.perf_counter()
    tdist.init_distributed(
        coordinator_address=f"localhost:{tdist.free_port()}",
        num_processes=1, process_id=0, backend="nccl", device="cuda")
    _check(dist.get_backend() == "nccl", "multi-device: not on nccl")
    mesh = tdist.DistMesh((1,), ("dp",))
    scen = sc.random_scenarios(oval, B, seed=dc.SEED_DP, n_objects=1,
                               device="cuda")
    local = tdist.shard_scenarios(scen, mesh)
    tick_k = sc.make_sharded_tick(oval, mesh)
    tick_p = sc.make_sharded_tick(oval, mesh, kernels=False)
    (res_k, st_k), nccl_counts = _run_counted(wrapper,
                                              lambda: tick_k(local))
    _check(all(nccl_counts[k] > 0 for k in FLEET),
           f"sharded tick nccl: a kernel was not launched: {nccl_counts}")
    res_p, st_p = tick_p(local)
    d_pos, d_vx = _held("sharded tick nccl world 1", res_k, res_p, exact,
                        "trajs")
    ref_a = sc.make_batched_tick(oval, device="cuda")(scen)
    torch.cuda.synchronize()
    for k in ref_a:
        _check(torch.equal(res_k[k], ref_a[k]),
               f"sharded tick nccl: {k} differs from make_batched_tick")
    cost = torch.where(ref_a["valid"], ref_a["cost"], torch.inf)
    host = (float(cost.min()), int(ref_a["valid"].sum()))
    got = (float(st_k["fleet_min_cost"]), int(st_k["fleet_actions"]))
    _check(got == host and got == (float(st_p["fleet_min_cost"]),
                                   int(st_p["fleet_actions"])),
           f"sharded tick nccl: stats {got}, host reduction {host}")
    # the eager tick's time and collective share (the compiled tick's
    # are phase 14's)
    ms = _ms(lambda: tick_k.__wrapped__(local))
    share = tdist.collective_share(tick_k.__wrapped__, (local,))["share"]
    dist.destroy_process_group()
    print(f"multi-device nccl world 1: make_sharded_tick oval_1opp B={B} on "
          f"{card}: kernel launches "
          f"{ {k: v for k, v in nccl_counts.items() if v} }; kernels vs "
          f"plain fields equal, max|d pos|={d_pos:.3g} m max|d vx|="
          f"{d_vx:.3g} m/s; every field equal to make_batched_tick; stats "
          f"fleet_min_cost={got[0]} fleet_actions={got[1]} from an NCCL "
          f"all_reduce, equal to the host's reduction; eager {ms:.2f} ms a "
          f"tick a rank, {100 * share:.2f} % of a tick in collectives "
          f"({mesh.n_collectives} collectives); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (b) four ranks sharing the card over gloo (the kernels built above)
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "artifacts", "chip_smoke", "dist")
    reports = dc.run(out_dir, "chip", cpu=False, backend="gloo",
                     timeout_s=420.0)
    secs = time.perf_counter() - t0
    # every rank's stats equal and its kernels launched, the gathered
    # results against the unsharded kernel tick, the spatial tables
    # against plan_window_kernel
    m = dc.check(out_dir, reports, "chip", torch.device("cuda"))
    rank_counts = {c: (reports[0][c] if c != "c" else reports[0]["c"]["mb"])
                   ["launches"] for c in ("a", "b", "c")}
    # the spatial path's kernel calls, recorded by rank 0, held and timed
    rec = torch.load(os.path.join(out_dir, "rec_spatial.pt"))
    spatial_stats = {}
    for name, key, plain in (
            ("hit_slab", "hit_slab", cuda_collision.hit_slab_plain),
            ("minplus", "minplus_scan", cuda_minplus.minplus_scan_plain)):
        _check(rec[key], f"multi-device c: no {name} call recorded")
        a, kw = rec[key][0]
        a = [x.cuda() for x in a]
        kern = wrapper(dict((n, p) for n, p, *_ in KERNELS)[name])
        if name == "minplus":
            po = plain(*a)
            for x in po:
                _spoil(x.shape, x.dtype)
            ko = kern(*a)
            torch.cuda.synchronize()
            for x, y in zip(ko, po):
                _check(torch.equal(x, y), "minplus spatial call: not "
                       "bit-equal")
            rows = a[0].shape[0] * a[0].shape[1]
            wflat = a[0].reshape(rows, *a[0].shape[2:])
            nb, ops = _cost_minplus(wflat, a[1], *ko)
            b_ms, by = _bound(nb, ops)
            r = dict(ms=_device_ms(lambda: kern(*a)),
                     wrapper_ms=_median_ms(lambda: kern(*a), 30),
                     plain_ms=_median_ms(lambda: plain(*a), 10), err=0.0)
            print(f"kernel minplus spatial re-run call {rows} rows "
                  f"[{'x'.join(map(str, a[0].shape))}]: max|kernel-plain|=0 "
                  f"(best, bp bit-equal) kernel {r['ms']:.4f} ms on the "
                  f"device, {r['wrapper_ms']:.4f} ms a wrapper call; plain "
                  f"{r['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({by}: {nb} "
                  f"B, {ops} ops)", flush=True)
            r["bound_ms"], r["bound_by"] = b_ms, by
        else:
            r = held_and_timed(name, "spatial call", kern, plain, a, kw, 10)
            r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["ops"])
        spatial_stats[name] = r
    part = {"a": "dp=4 tick oval_1opp", "b": "(dp=2, mp=2) tick oval_1opp",
            "c": "spatial_window_dp mp=4 unclosed_monteblanco"}
    # the eager ticks' readings (the compiled ticks' are phase 14's)
    for case in ("a", "b", "c"):
        rs = [r[case] if case != "c" else r[case]["mb"] for r in reports]
        ms, sh = ("ms", "collective_share") if case == "c" else (
            "eager_ms", "eager_collective_share")
        print(f"multi-device gloo 4 ranks on one card, {part[case]} "
              f"(B={B if case != 'c' else dc.SIZES['chip']['n_spatial']} in "
              f"all) on {card}: eager "
              f"{max(x[ms] for x in rs):.2f} ms a tick a rank (ranks "
              f"{[round(x[ms], 2) for x in rs]}), "
              f"{100 * max(x[sh] for x in rs):.2f} % of a "
              f"tick in collectives (ranks "
              f"{[round(100 * x[sh], 2) for x in rs]} %); "
              f"launches a rank {rank_counts[case]}", flush=True)
    print(f"multi-device gloo 4 ranks: every rank's stats equal (a "
          f"{reports[0]['a']['stats']}, b {reports[0]['b']['stats']}); a "
          f"equals the unsharded tick {m['a']}; b against it (exact fields "
          f"but cost equal, cost within rtol 1e-4) {m['b']}; c tables "
          f"equal on every rank, against plan_window_kernel {m['c_mb']}; "
          f"ranks' kernels vs plain "
          f"{[r['a']['kernels_vs_plain'] for r in reports]} (a) "
          f"{[r['b']['kernels_vs_plain'] for r in reports]} (b); ranks "
          f"{secs:.1f} s", flush=True)
    print(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(nccl=nccl_counts, rank=rank_counts, spatial=spatial_stats,
                reports=reports)


# phase 11: validate_tracks' ticks on the real clock, and those held
# kernels against plain (a plain facade tick costs 1.3-1.5 s on the card)
VALIDATE_TICKS = 30
VALIDATE_HELD_TICKS = 10


def entry_tools_phase(card, wrapper):
    """Phase 11 of the docstring.  Returns the launches of ``entry()``'s
    tick and of rank 0's dry-run parts."""
    from graphbasedlocaltrajectoryplanner_torch import entry as tentry
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        dist_cases as dc)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        validate_tracks as vt)
    t_phase = time.perf_counter()

    # (a) entry()'s tick, with the kernels and plain, over one lattice; the
    # launches counted on the eager body of the same tick (a replay of the
    # compiled one runs no Python)
    lat = tentry.small_lattice("cuda")
    fn_k, (scen,) = tentry._entry_on(lat, "cuda")
    fn_p, _ = tentry._entry_on(lat, "cuda", kernels=False)
    _, entry_counts = _run_counted(
        wrapper, lambda: sc.make_batched_tick(lat, device="cuda").__wrapped__(
            scen))
    _check(all(entry_counts[k] > 0 for k in FLEET),
           f"entry tick: a kernel was not launched: {entry_counts}")
    trajs_k, valid_k, cost_k = fn_k(scen)
    trajs_p, valid_p, cost_p = fn_p(scen)
    d_pos, d_vx = _held("entry tick", dict(trajs=trajs_k, valid=valid_k,
                                           cost=cost_k),
                        dict(trajs=trajs_p, valid=valid_p, cost=cost_p),
                        ("valid", "cost"), "trajs")
    ms_k = _median_ms(lambda: fn_k(scen), 10)
    ms_p = _median_ms(lambda: fn_p(scen), 3)
    print(f"entry tick small oval B={tentry.BATCH} on {card}: kernel "
          f"launches { {k: v for k, v in entry_counts.items() if v} }; "
          f"valid and cost equal to the plain tick, max|d s,x,y|="
          f"{d_pos:.3g} m max|d vx|={d_vx:.3g} m/s; {int(valid_k.sum())} "
          f"valid actions, min cost "
          f"{float(torch.where(valid_k, cost_k, torch.inf).min()):.2f}; "
          f"{ms_k:.2f} ms a tick, plain {ms_p:.2f} ms", flush=True)

    # (b) validate_tracks on its default tracks
    store = os.path.join(ROOT, "artifacts", "chip_smoke", "validate")
    os.makedirs(store, exist_ok=True)
    for track in vt.DEFAULT_TRACKS:
        r = vt.run_track(track, VALIDATE_TICKS, store)
        _check(r["start_ok"] and r["empty_sets"] == 0
               and r["mean_actions"] > 0, f"validate {track}: {r}")
        print(f"validate_tracks {r['name']} {VALIDATE_TICKS} ticks on "
              f"{card}: L={r['layers']} N={r['nodes']} closed={r['closed']} "
              f"build_s={r['build_s']:.3f} tick_ms_p50="
              f"{r['tick_ms_p50']:.2f} v_end={r['v_end']:.3f} m/s, actions "
              f"a tick {r['mean_actions']:.2f}", flush=True)
        rec_k, rec_p = [], []
        rk, counts = _run_counted(wrapper, lambda: vt.run_track(
            track, VALIDATE_HELD_TICKS, store, clock=cl.StepClock(),
            records=rec_k))
        rp = vt.run_track(track, VALIDATE_HELD_TICKS, store, kernels=False,
                          clock=cl.StepClock(), records=rec_p)
        _check(all(counts[k] > 0 for k in FACADE),
               f"validate {track}: a kernel was not launched: {counts}")
        _check(len(rec_k) == VALIDATE_HELD_TICKS,
               f"validate {track}: {len(rec_k)} ticks recorded")
        d_pos, d_vx, seen = cl.compare(rec_k, rec_p)
        _check(d_pos <= 2e-3 and d_vx <= 0.02,
               f"validate {track}: trajs deviate by {d_pos} m, {d_vx} m/s")
        for k in ("start_ok", "mean_actions", "empty_sets"):
            _check(rk[k] == rp[k], f"validate {track}: {k} {rk[k]} with the "
                   f"kernels, {rp[k]} plain")
        d_v = abs(rk["v_end"] - rp["v_end"])
        _check(d_v <= 0.02, f"validate {track}: v_end deviates by {d_v}")
        print(f"validate_tracks {r['name']} first {VALIDATE_HELD_TICKS} "
              f"ticks (fixed clock step {cl.TICK_DT} s) on {card}: kernel "
              f"launches { {k: v for k, v in counts.items() if v} }; action "
              f"sets and node chains equal to the plain run on every tick, "
              f"actions {sorted(seen)}, max|d s,x,y|={d_pos:.3g} m max|d vx|"
              f"={d_vx:.3g} m/s, |d v_end|={d_v:.3g} m/s; kernel tick p50 "
              f"{rk['tick_ms_p50']:.2f} ms, plain {rp['tick_ms_p50']:.2f} ms",
              flush=True)

    # (c) the multi-device dry run, four gloo ranks sharing the card (each
    # rank holds its parts against their plain runs), against the CPU's
    t0 = time.perf_counter()
    d = tentry.dryrun_multidevice(4, "gloo")
    secs = time.perf_counter() - t0
    parts = {"dp": "a", "spatial": "c", "dp_mp": "b"}
    for rep in d["reports"]:
        for part, case in parts.items():
            cnt = rep[part]["launches"]
            _check(all(cnt[k] > 0 for k in dc.CASE_KERNELS[case]),
                   f"dry run rank {rep['rank']} {part}: launches {cnt}")
    t0 = time.perf_counter()
    d_cpu = tentry.dryrun_multidevice(4, "gloo", device="cpu")
    secs_cpu = time.perf_counter() - t0
    nums = {k: d[k] for k in tentry.KEYS}
    _check(nums == {k: d_cpu[k] for k in tentry.KEYS},
           f"dry run: card {nums}, CPU { {k: d_cpu[k] for k in tentry.KEYS} }")
    rank0 = {p: {k: v for k, v in d["reports"][0][p]["launches"].items()
                 if v} for p in parts}
    held = [(r["dp"]["kernels_vs_plain"], r["dp_mp"]["kernels_vs_plain"])
            for r in d["reports"]]
    print(f"dryrun_multidevice(4, 'gloo') on {card}: fleet_min_cost="
          f"{d['fleet_min_cost']} actions={d['actions']} "
          f"spatial_dp_goal_cost={d['spatial_dp_goal_cost']} "
          f"dp_mp_composed_min_cost={d['dp_mp_composed_min_cost']}, equal "
          f"to the CPU dry run's; every rank agrees; each rank's parts "
          f"equal to their plain runs (dp, dp_mp max|d s,x,y|, |d vx|: "
          f"{held}); "
          f"rank 0's launches {rank0}; card {secs:.1f} s, CPU "
          f"{secs_cpu:.1f} s", flush=True)
    print(f"entry tools phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(entry=entry_counts,
                dryrun={p: d["reports"][0][p]["launches"] for p in parts})


# phase 12: synchronised ticks a window of the paired readings (eager,
# compiled, compiled, eager)
PAIRED_TICKS = 20
# the fleet kernels by a word of their device name, and the least count of
# launches a compiled fb tick's replay shows
FLEET_NAMES = (("hit_slab", "hit_slab", 1), ("window_dp", "window_dp", 1),
               ("backtrace", "walk_kernel", 1),
               ("vel_scan", "vel_scan_kernel", 6),
               ("assemble", "assemble_kernel", 1))
# words of the kernels' device names counted in a replay's profile (the
# two velocity-scan instances by their first template argument, CGG)
REPLAY_WORDS = ("hit_slab", "window_dp", "walk_kernel",
                "vel_scan_kernel<true", "vel_scan_kernel<false", "admm_vel",
                "assemble_kernel")


def _tick_ms(fn, n):
    """Median host ms of ``n`` synchronised calls of ``fn``."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _same(label, out_c, out_e):
    """The compiled tick's outputs against the eager tick's: the same
    fields, each ``torch.equal``."""
    _check(set(out_c) == set(out_e),
           f"{label}: fields {sorted(out_c)} against {sorted(out_e)}")
    for k in out_e:
        _check(torch.equal(out_c[k], out_e[k]),
               f"{label}: {k} differs from the eager tick's")


def _capture_cost(tick):
    """What each signature of a compiled tick cost to capture, and its
    graph's kernel nodes."""
    return "; ".join(
        f"warm-up {c.warmup_ms:.1f} ms, capture {c.capture_ms:.1f} ms, "
        f"graph pool {c.pool_bytes / 2 ** 20:.1f} MiB, "
        f"{c.kernel_nodes} kernel nodes"
        for c in tick.graphs.values())


def compiled_tick_phase(card, oval, mb):
    """Phase 12 of the docstring."""
    from graphbasedlocaltrajectoryplanner_torch import entry as tentry
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        dist_cases as dc)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        profile_stages)
    t_phase = time.perf_counter()

    # (a) the three mixes: the capture's batch, a batch made after the
    # capture (the static inputs refilled), tick n's outputs after tick n+1
    for mix, lat, skw in (
            ("oval_1opp", oval, dict(n_objects=1)),
            ("oval_3opp_o16", oval, dict(n_objects=3, o_pad=sc.O_PAD)),
            ("unclosed_monteblanco_1opp", mb, dict(n_objects=1))):
        tick = sc.make_batched_tick(lat, device="cuda")
        _check(hasattr(tick, "graphs") and tick.__wrapped__ is not tick,
               f"compiled {mix}: make_batched_tick did not compile the tick")
        scen = sc.random_scenarios(lat, B, seed=0, device="cuda", **skw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_c = tick(scen)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        _same(f"compiled {mix}", out_c, tick.__wrapped__(scen))
        kept = {k: v.clone() for k, v in out_c.items()}
        fresh = sc.random_scenarios(lat, B, seed=12, device="cuda", **skw)
        out_f = tick(fresh)
        _same(f"compiled {mix} batch made after the capture", out_f,
              tick.__wrapped__(fresh))
        _check(not torch.equal(out_f["trajs"], kept["trajs"]),
               f"compiled {mix}: the second batch returned the first's")
        for k, v in kept.items():
            _check(torch.equal(out_c[k], v),
                   f"compiled {mix}: tick n's {k} changed in tick n+1")
        _check(len(tick.graphs) == 1,
               f"compiled {mix}: {len(tick.graphs)} signatures captured")
        print(f"compiled tick {mix} B={B} on {card}: every field "
              f"torch.equal to the eager tick's on the capture's batch and "
              f"on a batch made after the capture; tick n's outputs "
              f"unchanged by tick n+1; first call {first_ms:.1f} ms "
              f"({_capture_cost(tick)})", flush=True)
        del tick

    # (b) a 3-tick sqp warm-start chain, the profiles fed back
    scen1 = sc.random_scenarios(oval, B, seed=0, n_objects=1, device="cuda")
    sqp_kw = profile_stages.sqp_options(oval)
    sqp = sc.make_batched_tick(oval, device="cuda", **sqp_kw)
    over_c, over_e = {}, {}
    for step in range(3):
        out_c = sqp(scen1, **over_c)
        out_e = sqp.__wrapped__(scen1, **over_e)
        _same(f"compiled sqp chain tick {step}", out_c, out_e)
        over_c = dict(sqp_x0=out_c["vx_sqp"])
        over_e = dict(sqp_x0=out_e["vx_sqp"])
    _check(len(sqp.graphs) == 2,
           f"compiled sqp chain: {len(sqp.graphs)} signatures captured")
    print(f"compiled tick oval_1opp sqp B={B} on {card}: a 3-tick warm "
          f"chain (vx_sqp fed back as sqp_x0) torch.equal to the eager "
          f"chain in every field of every tick; cold and warm signature "
          f"({_capture_cost(sqp)})", flush=True)

    # (c) phase 8's options and the zone masks
    p_big = sc.default_p_max(oval) + 64
    zones = dc.zone_case(oval, scen1)
    opts = [("filt_window=5", dict(filt_window=5)),
            ("incl_emergency=False", dict(incl_emergency=False)),
            (f"p_max={p_big}", dict(p_max=p_big)),
            ("until=assembly", dict(until="assembly")),
            ("until=decide", dict(until="decide")),
            (f"sqp p_max={p_big}", dict(sqp_kw, p_max=p_big)),
            ("zone_block shared", dict(zone_block=zones[B - 1])),
            ("zone_block per scenario", dict(zone_block=zones))]
    for label, kw in opts:
        tick = sc.make_batched_tick(oval, device="cuda", **kw)
        _same(f"compiled options {label}", tick(scen1),
              tick.__wrapped__(scen1))
        del tick
    print(f"compiled tick oval_1opp B={B} options on {card}: "
          f"{', '.join(label for label, _ in opts)}: every field torch.equal "
          f"to the eager tick's", flush=True)

    # (d) entry()'s tick, B=8 on the small oval
    lat_s = tentry.small_lattice("cuda")
    fn, (scen_e,) = tentry._entry_on(lat_s, "cuda")
    ref = sc.make_batched_tick(lat_s, device="cuda").__wrapped__(scen_e)
    for call in range(2):
        got = fn(scen_e)
        _same(f"compiled entry tick call {call}",
              dict(zip(("trajs", "valid", "cost"), got)),
              {k: ref[k] for k in ("trajs", "valid", "cost")})
    print(f"compiled entry tick small oval B={tentry.BATCH} on {card}: "
          f"trajs, valid and cost torch.equal to the eager tick's on the "
          f"first call and on a replay", flush=True)

    # (e) the readings: eager and compiled in one process, in turns
    scen_b1 = sc.random_scenarios(oval, 1, seed=1, device="cuda")
    fb = sc.make_batched_tick(oval, device="cuda")
    warm = over_c["sqp_x0"]
    readings = {}
    for label, tick, call in (
            (f"fb B={B}", fb, lambda t: t(scen1)),
            (f"sqp warm B={B}", sqp, lambda t: t(scen1, sqp_x0=warm)),
            ("fb B=1", fb, lambda t: t(scen_b1))):
        call(tick)
        call(tick.__wrapped__)
        windows = [(name, _tick_ms(lambda: call(f), PAIRED_TICKS))
                   for name, f in (("eager", tick.__wrapped__),
                                   ("compiled", tick), ("compiled", tick),
                                   ("eager", tick.__wrapped__))]
        e_ms = (windows[0][1] + windows[3][1]) / 2
        c_ms = (windows[1][1] + windows[2][1]) / 2
        prof_c = profile_device(lambda: call(tick))
        prof_e = profile_device(lambda: call(tick.__wrapped__))
        if prof_c["n"] and label == f"fb B={B}":
            for name, word, least in FLEET_NAMES:
                _check(prof_c["count_of"](word) >= least,
                       f"compiled {label}: the replay ran no {name} "
                       f"kernel: {prof_c['top']}")
            # the whole path assembly is one kernel of the graph
            _check(prof_c["count_of"]("assemble_kernel") == 1,
                   f"compiled {label}: the replay ran "
                   f"{prof_c['count_of']('assemble_kernel')} assembly "
                   f"kernels, not one")
        if prof_c["n"] and label.startswith("sqp"):
            _check(prof_c["count_of"]("admm_vel") >= 1,
                   f"compiled {label}: the replay ran no admm_vel kernel")
        readings[label] = dict(eager_ms=e_ms, compiled_ms=c_ms,
                               kernels=prof_c["n"],
                               busy_ms=prof_c["busy_ms"])
        busy = (f"{prof_c['n']} device kernels a replay ("
                + ", ".join(f"{w} x{prof_c['count_of'](w)}"
                            for w in REPLAY_WORDS)
                + f"), device busy "
                f"{prof_c['busy_ms']:.3f} ms "
                f"({100 * prof_c['busy_ms'] / c_ms:.1f} % of the compiled "
                f"tick); eager {prof_e['n']} kernels, "
                f"{prof_e['busy_ms']:.3f} ms "
                f"({100 * prof_e['busy_ms'] / e_ms:.1f} %)"
                if prof_c["n"] else
                "the profiler saw no device time (not measured)")
        print(f"compiled tick oval {label} on {card}: host ms a tick "
              f"(median of {PAIRED_TICKS} synchronised ticks a window, in "
              f"turns) "
              + ", ".join(f"{n} {ms:.3f}" for n, ms in windows)
              + f"; eager {e_ms:.3f} ms, compiled {c_ms:.3f} ms "
              f"(eager / compiled {e_ms / c_ms:.2f}); {busy}", flush=True)
    print(f"compiled tick signatures on {card}: fb (B={B}, B=1): "
          f"{_capture_cost(fb)}; sqp (cold, warm): {_capture_cost(sqp)}",
          flush=True)
    del fb, sqp
    torch.cuda.empty_cache()
    print(f"compiled tick phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return readings



# phase 13: the compiled facade's drives, each held against the same
# facade's eager calls on the compiled drive's inputs: (label, track, online
# INI, start layer, ticks)
ONLINE_INI = "params/ltpl_config_online.ini"
COMPILED_FACADE_DRIVES = (
    ("oval fb", "oval", ONLINE_INI, 0, FACADE_TICKS_OVAL),
    ("oval sqp", "oval", SQP_INI, 0, SQP_TICKS_OVAL),
    ("unclosed_monteblanco fb", UNCLOSED_CSV, ONLINE_INI,
     FACADE_START_LAYER_UNCLOSED, FACADE_TICKS_UNCLOSED),
    ("unclosed_monteblanco sqp", UNCLOSED_CSV, SQP_INI,
     SQP_START_LAYER_UNCLOSED, SQP_TICKS_UNCLOSED),
)
# the oval drives' tick under the profiler (an opponent ahead, four actions
# and the emergency profile)
PROFILED_TICK = 15


def _facade_pd(store, track, online):
    name = "oval" if track == "oval" else "unclosed_monteblanco"
    return {"globtraj_input_path": (track if track == "oval"
                                    else os.path.join(ROOT, track)),
            "graph_store_path": os.path.join(store, f"{name}.npz"),
            "ltpl_offline_param_path": os.path.join(
                ROOT, "params/ltpl_config_offline.ini"),
            "ltpl_online_param_path": os.path.join(ROOT, online)}


def _records_equal(label, rec_c, rec_e):
    """Two drives over the same inputs: on every tick the action keys, the
    node chains and every trajectory ``np.array_equal``."""
    _check(len(rec_c) == len(rec_e),
           f"{label}: {len(rec_c)} ticks against {len(rec_e)}")
    for tick, (a, b) in enumerate(zip(rec_c, rec_e)):
        _check(list(a["traj_set"]) == list(b["traj_set"]),
               f"{label} tick {tick}: action sets {list(a['traj_set'])} "
               f"against {list(b['traj_set'])}")
        _check(a["nodes"] == b["nodes"], f"{label} tick {tick}: node chains")
        for k, trajs in a["traj_set"].items():
            for ta, tb in zip(trajs, b["traj_set"][k]):
                _check(np.array_equal(ta, tb),
                       f"{label} tick {tick} {k}: trajectories differ")


def _count_calls(handler):
    """Each compiled call of ``handler`` wrapped in a counter of its calls;
    returns the counts by step."""
    calls = dict.fromkeys(handler.steps, 0)
    for name, f in list(handler.steps.items()):
        def counted(*a, _f=f, _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        counted.graphs = f.graphs
        handler.steps[name] = counted
    return calls


def _step_costs(handler):
    """Every captured signature's cost by step: warm-up ms / capture ms and
    the graph pool."""
    return "; ".join(
        f"{name} x{len(f.graphs)}: " + ", ".join(
            f"{c.warmup_ms:.1f}/{c.capture_ms:.1f} ms "
            f"{c.pool_bytes / 2 ** 20:.1f} MiB" for c in f.graphs.values())
        for name, f in handler.steps.items() if f.graphs)


class _TickProfile:
    """``on_tick`` of a drive that profiles tick ``k`` under
    ``torch.profiler`` (from the end of tick k-1 to the end of tick k),
    after tick k-1 as the profiler's warm-up step (without it the tracer
    missed the first kernels of the tick); ``summary`` is
    :func:`_kernel_summary` of tick k."""

    def __init__(self, k):
        self.k, self.prof, self.summary = k, None, None

    def _ready(self, prof):
        self.summary = _kernel_summary(prof)

    def __call__(self, tick):
        from torch.profiler import ProfilerActivity, profile, schedule
        if tick == self.k - 2:
            torch.cuda.synchronize()
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=self._ready)
            self.prof.__enter__()
        elif tick in (self.k - 1, self.k):
            torch.cuda.synchronize()
            self.prof.step()
            if tick == self.k:
                self.prof.__exit__(None, None, None)


def compiled_facade_phase(card, store, wrapper):
    """Phase 13 of the docstring."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    t_phase = time.perf_counter()
    for label, track, online, layer, n in COMPILED_FACADE_DRIVES:
        pd = _facade_pd(store, track, online)
        ltpl_c = GraphLTPL(pd, device="cuda", log_to_file=False)
        ltpl_c.graph_init()
        ltpl_e = GraphLTPL(pd, device="cuda", log_to_file=False)
        ltpl_e.graph_init()
        h = ltpl_c._oth
        _check(all(hasattr(f, "graphs") for f in h.steps.values()),
               f"compiled facade {label}: GraphLTPL did not compile its "
               f"steps")
        calls = _count_calls(h)
        pos, heading = cl.start_pose(h.np_refline, layer)
        objs = zones = None
        if track == "oval":
            objs = cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl)
            zones = cl.left_half_zone(h.np_nodes_in_layer)
        sigs = []
        t0 = time.perf_counter()
        rec_c, captured = _run_counted(wrapper, lambda: cl.drive(
            ltpl_c, n, pos, heading, objs, zones,
            on_tick=lambda t: sigs.append(h.signatures())), eager=False)
        t_c = time.perf_counter() - t0
        path_kernels = FACADE + (("admm_vel",) if "sqp" in label else ())
        _check(all(captured[k] > 0 for k in path_kernels),
               f"compiled facade {label}: a kernel of the path is in no "
               f"captured graph: {captured}")
        t0 = time.perf_counter()
        with cuda_graph.disabled():
            rec_e = cl.drive(ltpl_e, n, pos, heading, zones=zones,
                             replay=rec_c)
        torch.cuda.synchronize()
        t_e = time.perf_counter() - t0
        _records_equal(f"compiled facade {label}", rec_c, rec_e)
        _check(ltpl_e._oth.signatures() == 0,
               f"compiled facade {label}: the eager drive captured")
        half = sigs[n // 2 - 1]
        if label == "oval fb":
            _check(half == sigs[-1], f"compiled facade {label}: the second "
                   f"half captured {sigs[-1] - half} new signatures")
        seen = sorted({k for r in rec_c for k in r["traj_set"]})
        ladder = ("brake_fb" if "fb" in label else "brake_sqp")
        if track != "oval":
            _check(calls[ladder] >= 2 and len(h.steps[ladder].graphs) == 1,
                   f"compiled facade {label}: ladder calls {calls[ladder]} "
                   f"on {len(h.steps[ladder].graphs)} signatures")
        print(f"compiled facade {label} {n} ticks (start layer {layer}) on "
              f"{card}: action keys, node chains and trajectories "
              f"np.array_equal to the eager calls' on every tick, actions "
              f"{seen}; {sigs[-1]} signatures ({half} after tick "
              f"{n // 2 - 1}) for calls "
              f"{ {k: v for k, v in calls.items() if v} }, the kernels "
              f"launched at their captures (warm-up and capture) "
              f"{ {k: v for k, v in captured.items() if v} }; compiled drive "
              f"{t_c:.1f} s, eager replay {t_e:.1f} s", flush=True)
        print(f"compiled facade {label} signatures (warm-up/capture ms, "
              f"graph pool): {_step_costs(h)}", flush=True)
        if track != "oval":
            del ltpl_c, ltpl_e, h
            continue

        # the readings: eager and compiled in turns on the real clock, the
        # compiled calls those captured above
        backend = label.split()[1]
        windows = []
        for mode in ("eager", "compiled", "compiled", "eager"):
            timings, before = [], h.signatures()
            with (cuda_graph.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                cl.drive(ltpl_c, n, pos, heading, objs, zones,
                         fake_clock=False, timings=timings)
            tt = np.asarray(timings[5:]) * 1e3
            windows.append((mode, np.percentile(tt, 50),
                            np.percentile(tt, 99), h.signatures() - before))
        p = {m: (np.mean([w[1] for w in windows if w[0] == m]),
                 np.mean([w[2] for w in windows if w[0] == m]))
             for m in ("eager", "compiled")}
        # one tick of each under the profiler, on the compiled drive's inputs
        profs = {}
        for mode in ("compiled", "eager"):
            tp, timings = _TickProfile(PROFILED_TICK), []
            with (cuda_graph.disabled() if mode == "eager"
                  else contextlib.nullcontext()):
                cl.drive(ltpl_c, PROFILED_TICK + 1, pos, heading,
                         zones=zones, replay=rec_c, on_tick=tp,
                         timings=timings)
            profs[mode] = (tp.summary, timings[PROFILED_TICK] * 1e3)
        print(f"compiled facade latency oval {backend} on {card}: ms a tick "
              f"(calc_paths + calc_vel_profile, ticks 5-{n - 1}, real "
              f"clock, in turns) "
              + ", ".join(f"{m} p50 {a:.2f} p99 {b:.2f}"
                          + (f" ({c} new signatures)" if c else "")
                          for m, a, b, c in windows)
              + f"; eager p50 {p['eager'][0]:.2f} p99 {p['eager'][1]:.2f}, "
              f"compiled p50 {p['compiled'][0]:.2f} p99 "
              f"{p['compiled'][1]:.2f} (eager / compiled p50 "
              f"{p['eager'][0] / p['compiled'][0]:.2f})", flush=True)
        for mode, (prof, tick_ms) in profs.items():
            share = 100 * prof["busy_ms"] / tick_ms
            p50 = p[mode][0]
            busy = (f"{prof['n']} device kernels, device busy "
                    f"{prof['busy_ms']:.3f} ms of the profiled tick's "
                    f"{tick_ms:.2f} ms ({share:.1f} %; the host's share "
                    f"{100 - share:.1f} %) and "
                    f"{100 * prof['busy_ms'] / p50:.1f} % of the unprofiled "
                    f"{mode} p50 {p50:.2f} ms; facade kernels "
                    + ", ".join(f"{w} x{prof['count_of'](w)}"
                                for w in REPLAY_WORDS)
                    + "; top: " + "; ".join(prof["top"])
                    if prof["n"] else
                    "the profiler saw no device time (not measured)")
            print(f"profile facade tick {PROFILED_TICK} oval {backend} "
                  f"{mode} on {card}: {busy}", flush=True)
        del ltpl_c, ltpl_e, h
    torch.cuda.empty_cache()
    print(f"compiled facade phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)

# phase 14: the device-name words of the kernels a replay of a compiled
# sharded tick runs, by kernel
SHARDED_WORDS = dict(hit_slab="hit_slab", window_dp="window_dp",
                     backtrace="walk_kernel",
                     vel_scan_cgg="vel_scan_kernel<true",
                     vel_scan="vel_scan_kernel<false",
                     minplus="minplus_kernel", admm_vel="admm_vel",
                     assemble="assemble_kernel")


def _same_sharded(label, got, ref):
    """A compiled sharded tick's ``(results, stats)`` against the eager
    tick's, each field ``torch.equal``."""
    _same(label, got[0], ref[0])
    _same(f"{label} (stats)", got[1], ref[1])


def _host_collectives(fn):
    """``fn()`` under ``torch.profiler``: the host-side NCCL collective
    calls (c10d's ``nccl:*`` ranges) it made."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("nccl:"))


def compiled_sharded_phase(card, oval, win_args, md):
    """Phase 14 of the docstring.  Returns each kernel's launches in one
    replay of the compiled sharded tick (data-parallel and spatial)."""
    import torch.distributed as dist
    from graphbasedlocaltrajectoryplanner_torch.parallel import (
        distributed as tdist)
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        dist_cases as dc)
    t_phase = time.perf_counter()
    versions = (f"torch {torch.__version__}, NCCL "
                f"{'.'.join(map(str, torch.cuda.nccl.version()))}")

    # (a) NCCL at world 1 in this process: the whole tick one CUDA graph
    tdist.init_distributed(
        coordinator_address=f"localhost:{tdist.free_port()}",
        num_processes=1, process_id=0, backend="nccl", device="cuda")
    scen = sc.random_scenarios(oval, B, seed=dc.SEED_DP, n_objects=1,
                               device="cuda")
    fresh = sc.random_scenarios(oval, B, seed=12, n_objects=1,
                                device="cuda")
    replay_launches = {}
    for label, shape, names, spatial, zb in (
            ("dp", (1,), ("dp",), None, None),
            ("spatial (dp=1, mp=1)", (1, 1), ("dp", "mp"), "mp", None),
            ("dp per-scenario zones", (1,), ("dp",), None,
             dc.zone_case(oval, scen))):
        mesh = tdist.DistMesh(shape, names)
        tick = sc.make_sharded_tick(oval, mesh, spatial_axis=spatial,
                                    zone_block=zb)
        _check(getattr(tick, "form", None) == "graph",
               f"compiled sharded {label}: not one CUDA graph on NCCL")
        eager = tick.__wrapped__
        local = tdist.shard_scenarios(scen, mesh, spatial)
        local_f = tdist.shard_scenarios(fresh, mesh, spatial)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tick(local)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        n_coll = mesh.n_collectives
        _same_sharded(f"compiled sharded {label}", out, eager(local))
        kept = {k: v.clone() for k, v in out[0].items()}
        out_f = tick(local_f)
        _same_sharded(f"compiled sharded {label} batch made after the "
                      "capture", out_f, eager(local_f))
        _check(not torch.equal(out_f[0]["trajs"], kept["trajs"]),
               f"compiled sharded {label}: the second batch returned the "
               "first's")
        for k, v in kept.items():
            _check(torch.equal(out[0][k], v),
                   f"compiled sharded {label}: tick n's {k} changed in "
                   "tick n+1")
        _check(len(tick.graphs) == 1, f"compiled sharded {label}: "
               f"{len(tick.graphs)} signatures captured")
        print(f"compiled sharded tick nccl world 1 {label} oval_1opp B={B} "
              f"on {card} ({versions}): one CUDA graph holding the tick and "
              f"its {n_coll} collectives (counted at its warm-up and "
              f"capture); every field and both statistics torch.equal to "
              f"the eager tick's on the capture's batch and on a batch made "
              f"after the capture; tick n's outputs unchanged by tick n+1; "
              f"first call {first_ms:.1f} ms ({_capture_cost(tick)})",
              flush=True)
        if zb is not None:
            continue
        # eager and compiled in turns, a replay's device kernels, the
        # collectives' host calls and device time
        eager(local)
        windows = [(name, _tick_ms(lambda: f(local), PAIRED_TICKS))
                   for name, f in (("eager", eager), ("compiled", tick),
                                   ("compiled", tick), ("eager", eager))]
        e_ms = (windows[0][1] + windows[3][1]) / 2
        c_ms = (windows[1][1] + windows[2][1]) / 2
        prof = profile_device(lambda: tick(local))
        host_e = _host_collectives(lambda: eager(local))
        host_c = _host_collectives(lambda: tick(local))
        _check(host_c == 0, f"compiled sharded {label}: a replay made "
               f"{host_c} host collective calls")
        share = tdist.collective_share(tick, (local,), c_ms)
        replay_launches[label] = {k: prof["count_of"](w)
                                  for k, w in SHARDED_WORDS.items()}
        copies = prof["count_of"]("Memcpy") + prof["count_of"]("memcpy")
        print(f"compiled sharded tick nccl world 1 {label} on {card}: host "
              f"ms a tick (median of {PAIRED_TICKS} synchronised ticks a "
              f"window, in turns) "
              + ", ".join(f"{n} {t:.3f}" for n, t in windows)
              + f"; eager {e_ms:.3f} ms, compiled {c_ms:.3f} ms (eager / "
              f"compiled {e_ms / c_ms:.2f}); a replay: {prof['n']} device "
              f"kernels and copies, busy {prof['busy_ms']:.3f} ms "
              f"({100 * prof['busy_ms'] / c_ms:.1f} % of the compiled "
              f"tick), kernels {replay_launches[label]}, {copies} device "
              f"copies, NCCL kernels {share['nccl_kernels']} "
              f"({share['nccl_ms']:.4f} ms, {100 * share['share']:.2f} % of "
              f"the tick; NCCL launches none at world 1 for an in-place "
              f"reduction and copies for a gather); host nccl:* calls: "
              f"eager {host_e}, a replay {host_c}; top "
              + "; ".join(prof["top"]), flush=True)
        del tick
    dist.destroy_process_group()

    # (b) four gloo ranks sharing the card, each part's staged compiled
    # tick held against its eager tick on every rank (phase 10's run)
    reports = md["reports"]
    part = {"a": "dp=4 tick oval_1opp",
            "b": "(dp=2, mp=2) tick oval_1opp",
            "c_tick": "spatial mp=4 tick unclosed_monteblanco"}
    for case, what in part.items():
        rs = [r[case] for r in reports]
        for r in rs:
            _check(r["compiled"]["form"] == "staged" and
                   r["compiled"]["equal"], f"compiled {case}: {r}")
        n = (B if case != "c_tick" else dc.SIZES["chip"]["n_spatial"])
        print(f"compiled sharded tick gloo 4 ranks on one card, {what} "
              f"(B={n} in all) on {card}: staged (stages "
              f"{rs[0]['compiled']['signatures']} signatures a rank), every "
              f"field and both statistics torch.equal to the eager tick's "
              f"on every rank at the capture and on a replay; ms a tick a "
              f"rank eager {[round(x['eager_ms'], 2) for x in rs]}, "
              f"compiled {[round(x['ms'], 2) for x in rs]} (max "
              f"{max(x['eager_ms'] for x in rs):.2f} against "
              f"{max(x['ms'] for x in rs):.2f}); collectives "
              f"{[round(100 * x['eager_collective_share'], 2) for x in rs]} "
              f"% of an eager tick, "
              f"{[round(100 * x['collective_share'], 2) for x in rs]} % of a "
              f"compiled one (host clock); graph pools "
              f"{[round(x['compiled']['pool_mib'], 1) for x in rs]} MiB, "
              f"capture {[round(x['compiled']['capture_ms'], 1) for x in rs]}"
              f" ms", flush=True)

    # (c) the dense window, compiled (captured again: phase 3 freed its
    # graph) against eager
    dense_e = pg.plan_window_dense.__wrapped__(*win_args)
    dense_c = pg.plan_window_dense(*win_args)
    for k in ("best", "bp", "vg", "win_layers", "blocked", "w_all"):
        _check(torch.equal(dense_c[k], dense_e[k]),
               f"compiled dense window: {k} differs from the eager call's")
    del dense_c, dense_e
    eager = pg.plan_window_dense.__wrapped__
    windows = [(name, _tick_ms(lambda: f(*win_args), 10))
               for name, f in (("eager", eager),
                               ("compiled", pg.plan_window_dense),
                               ("compiled", pg.plan_window_dense),
                               ("eager", eager))]
    e_ms = (windows[0][1] + windows[3][1]) / 2
    c_ms = (windows[1][1] + windows[2][1]) / 2
    graphs = list(pg.plan_window_dense.compiled[torch.device(
        "cuda", torch.cuda.current_device())].graphs.values())
    print(f"compiled dense window B={B} on {card}: best, bp, vg, win_layers, "
          f"blocked and w_all torch.equal to the eager call's; host ms a "
          f"call (median of 10 a window, in turns) "
          + ", ".join(f"{n} {t:.3f}" for n, t in windows)
          + f"; eager {e_ms:.3f} ms, compiled {c_ms:.3f} ms (eager / "
          f"compiled {e_ms / c_ms:.2f}); {len(graphs)} signature, graph pool "
          f"{sum(c.pool_bytes for c in graphs) / 2 ** 20:.1f} MiB",
          flush=True)
    print(f"compiled sharded phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return replay_launches


# the port's bench in a fresh process (phase 15): its output directory, and
# the seconds it may take
BENCH_OUT = os.path.join(ROOT, "artifacts", "chip_smoke", "bench")
BENCH_TIMEOUT_S = 420


def bench_phase(card, oval):
    """Phase 15 of the docstring.  Returns the bench's details."""
    import shutil
    from graphbasedlocaltrajectoryplanner_torch import bench
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    t_phase = time.perf_counter()

    # (a) one compiled fb replay at B=1024 read at the call and after a
    # warm-up step of the profiler
    scen = sc.random_scenarios(oval, B, seed=0, n_objects=1, device="cuda")
    tick = sc.make_batched_tick(oval, device="cuda")
    tick(scen)
    reads = []
    for form, read in (("at the call", profile_at_call),
                       ("after a warm-up step", profile_device)) * 2:
        p = read(lambda: tick(scen))
        _check(p["n"] > 0, f"profile {form}: no device kernel")
        reads.append((form, p["n"], p["busy_ms"]))
    print(f"profile compiled fb replay B={B} on {card}: "
          + "; ".join(f"{form} {n} device kernels, busy {ms:.3f} ms"
                      for form, n, ms in reads), flush=True)
    del tick
    torch.cuda.empty_cache()

    # (b) the bench, a fresh process after the kernels are built
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "graphbasedlocaltrajectoryplanner_torch.bench",
         "--out", BENCH_OUT], cwd=ROOT, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    t_bench = time.perf_counter() - t0
    with open(os.path.join(BENCH_OUT, "bench.log"), "w") as fh:
        fh.write(r.stdout + r.stderr)
    _check(r.returncode == 0, f"bench: exit {r.returncode}: "
           f"{(r.stdout + r.stderr)[-2000:]}")
    last = json.loads(r.stdout.strip().splitlines()[-1])
    _check(set(last) == {"metric", "value", "unit", "vs_baseline", "device"}
           and last["metric"] == bench.METRIC
           and last["device"]["platform"] == "gpu"
           and last["device"]["power_limit_w"] > 0, f"bench: last line {last}")
    with open(os.path.join(BENCH_OUT, bench.DETAILS)) as fh:
        d = json.load(fh)
    _check(set(d) == set(bench.KEYS),
           f"bench: details keys {sorted(set(d) ^ set(bench.KEYS))}")
    _check(d["kernel_parity_ok"] is True and not d["parity"]["vacuous"],
           f"bench: the parity gate failed: {d['parity']}")
    for name, g in d["parity"]["kernels"].items():
        _check(g["equal"] and g["launches"] > 0, f"bench parity {name}: {g}")
    for name in FLEET:
        _check(d["headline"]["launches"][name] > 0,
               f"bench headline: {name} not launched")
    _check(d["sqp"]["launches"]["admm_vel"] > 0,
           "bench sqp: admm_vel not launched")
    for sec in ["headline", "latency", "multi_opponent", "sqp"] + [
            f"batch_sweep.{b}" for b in d["batch_sweep"]]:
        s = d[sec] if "." not in sec else d["batch_sweep"][sec.split(".")[1]]
        _check(s["signatures"] == 1, f"bench {sec}: {s['signatures']} "
               f"signatures")
    h = d["headline"]
    print(f"bench (fresh process, {t_bench:.1f} s) on {card}: headline "
          f"{d['throughput_replans_per_sec']:.1f} replans/s (B={h['batch']}, "
          f"{h['ticks_per_window']} ticks a window: "
          + ", ".join(f"{dt * 1e3:.3f} ms = {rt:.1f}/s" for dt, rt in zip(
              h["windows_s"], h["window_replans_per_sec"]))
          + f"; first call {h['setup_s']:.3f} s, peak allocated "
          f"{h['peak_mem_bytes'] / 2 ** 20:.1f} MiB, graph pool "
          f"{h['graphs'][0]['pool_bytes'] / 2 ** 20:.1f} MiB)", flush=True)
    print(f"bench latency B=1 ({d['latency']['calls']} calls): p50 "
          f"{d['single_replan_latency_ms_p50']:.3f} ms, p99 "
          f"{d['single_replan_latency_ms_p99']:.3f} ms; device compute "
          f"{d['single_replan_device_compute_ms']:.3f} ms; 3 opponents o16 "
          f"{d['multi_opponent_3veh_o16_replans_per_sec']:.1f} replans/s; "
          f"sqp {d['sqp_backend_replans_per_sec']:.1f} replans/s "
          f"(stages {d['sqp_stages']})", flush=True)
    print("bench sweep: " + "; ".join(
        f"B={b} {s['replans_per_sec']:.1f} replans/s (windows "
        + ", ".join(f"{dt * 1e3:.2f}" for dt in s["windows_s"])
        + f" ms of {s['ticks_per_window']} ticks, pool "
        f"{s['graphs'][0]['pool_bytes'] / 2 ** 20:.0f} MiB)"
        for b, s in d["batch_sweep"].items())
        + f"; window DP {d['window_dp_gb_per_s_at_peak_batch']:.1f} GB/s "
        f"at the peak batch", flush=True)
    print(f"bench stages (device ms by range, B={h['batch']}): "
          f"{d['stages']['trace']['stage_ms']}; traced replays (device ms) "
          f"{d['stages']['cumulative']['stage_ms']}", flush=True)
    print("bench parity kernels (torch.equal to the plain version, "
          "launches): " + ", ".join(
              f"{n} {g['equal']} x{g['launches']}"
              for n, g in d["parity"]["kernels"].items()), flush=True)
    for k in ("end_to_end", "end_to_end_sqp"):
        g = d["parity"][k]
        print(f"bench parity {k}: card tick against the CPU oracle max|d xy| "
              f"{g['max_dxy_m']:.3g} m (bar {g['bar_dxy']}), max|d v| "
              f"{g['max_dv_mps']:.3g} m/s (bar {g['bar_dv']})", flush=True)
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return d


def main():
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_admm, cuda_assemble, cuda_backtrace, cuda_build, cuda_collision,
        cuda_graph, cuda_minplus, cuda_velocity, cuda_window)
    from graphbasedlocaltrajectoryplanner_torch.ops import search as srch
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        admm_variants as av)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        vel_cases as vc)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        vel_scan_variants as vv)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        walk_variants as wv)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        profile_stages)
    mods = dict(cuda_collision=cuda_collision, cuda_window=cuda_window,
                cuda_backtrace=cuda_backtrace, cuda_velocity=cuda_velocity,
                cuda_minplus=cuda_minplus, cuda_admm=cuda_admm,
                cuda_assemble=cuda_assemble)

    def wrapper(path):
        m, f = path.split(".")
        return getattr(mods[m], f)

    # ---- 1. device --------------------------------------------------------
    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = [ln for ln in _sh([cuda_build._nvcc(), "--version"]).splitlines()
            if "release" in ln]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvcc: {nvcc[0] if nvcc else '?'}", flush=True)

    # ---- 2. kernels -------------------------------------------------------
    t0 = time.perf_counter()
    wv_build = wv.start_build(cuda_build)      # alongside the kernels
    av_build = av.start_build(cuda_build)
    built = cuda_build.build_all()
    bt_variant, _ = wv.load_variants(wv_build)
    admm_variant, _ = av.load_variants(av_build)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'} and "
          f"testing_tools/{{walk,admm}}_variants.cu", flush=True)
    for name, (secs, log) in sorted(built.items()):
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"  {name}: nvcc {secs:.1f} s; ptxas: {' | '.join(regs)}")
        if name == "admm_vel":      # each instance by name: warp and block
            for ln in av.ptxas_lines(log):
                print(f"    {ln}")

    # the branch-free division and square root of the velocity scans
    # (csrc/ieee_fast.cuh) against the plain operators, 2^32 operands a case
    t0 = time.perf_counter()
    _, ieee_check = vv.build_variants(cuda_build)
    vv.check_ieee_fast(ieee_check, cuda_build)
    print(f"ieee_fast: held against / and sqrtf in "
          f"{time.perf_counter() - t0:.1f} s (build included)", flush=True)

    # ---- 3. lattices ------------------------------------------------------
    t0 = time.perf_counter()
    oval = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval").to("cuda")
    mb = tl.build_lattice(
        tt.import_globtraj_csv(os.path.join(
            ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv")),
        OfflineConfig(), md5_params="mb_open").to("cuda")
    for nm, lat in (("oval", oval), ("unclosed_monteblanco", mb)):
        print(f"lattice {nm}: L={lat.L} N={lat.N} S={lat.S} H={lat.H_max} "
              f"closed={lat.closed}")
    print(f"lattices built in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4. kernels vs plain at the main path's inputs --------------------
    # record every kernel call of one kernel tick (default oval, 1 opponent)
    scen1 = sc.random_scenarios(oval, B, seed=0, n_objects=1, device="cuda")
    tick_k = sc.make_batched_tick(oval, device="cuda")
    targets = {}
    for name, path, *_ in KERNELS[:len(FLEET)]:
        m, f = path.split(".")
        targets[name] = (mods[m], f)
    # the eager body: a graph replay passes no call through a recorder
    with Recorder(targets) as recorder:
        tick_k.__wrapped__(scen1)
    torch.cuda.synchronize()
    calls = recorder.calls

    plains = {
        "hit_slab": cuda_collision.hit_slab_plain,
        "window_dp": cuda_window.fused_window_dp_plain,
        "backtrace": cuda_backtrace.backtrace_walk_plain,
        "vel_scan_cgg": lambda *a: velops.stacked_vel_scan_cgg_auto(
            *a, kernels=False),
        "vel_scan": velops.stacked_vel_scan,
        "assemble": cuda_assemble.assemble_path_plain,
    }
    stats = {}
    for name, path, src, repl in KERNELS[:len(FLEET)]:
        kern = wrapper(path)
        _check(calls[name], f"{name}: the kernel tick never called it")
        tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   err=0.0, bytes=0, ops=0)
        for a, kw in calls[name]:
            r = held_and_timed(name, "call", kern, plains[name], a, kw,
                               5 if name.startswith("vel") else 20)
            for k in ("ms", "wrapper_ms", "plain_ms", "bytes", "ops"):
                tot[k] += r[k]
            tot["err"] = max(tot["err"], r["err"])
        tot["bound_ms"], tot["bound_by"] = _bound(tot["bytes"], tot["ops"])
        stats[name] = tot
    # the walk alone on a table already on chip: one walk's chain
    chain_ms, _ = wv.walk_chain(_device_ms, cuda_build, bt_variant,
                                *calls["backtrace"][0])
    stats["backtrace"]["chain_floor_ms"] = chain_ms
    print(f"chain backtrace call: one walk on chip {chain_ms:.5f} ms "
          f"(walk_only, slope between 1 and {wv.REPS} walks)", flush=True)

    n_ragged = ragged_vel_scans(cuda_velocity.CHUNK)
    print(f"ragged shapes: vel_scan and vel_scan_cgg bit-equal to the plain "
          f"version on {n_ragged} seeded calls (R in {vc.RAGGED_R}, T in "
          f"{vc.ragged_t(cuda_velocity.CHUNK)})", flush=True)
    n_w, n_h = ragged_window_kernels()
    print(f"ragged shapes: window_dp bit-equal to the plain version on {n_w} "
          f"seeded calls, hit_slab on {n_h} (testing_tools/window_cases)",
          flush=True)
    t0 = time.perf_counter()
    n_w, n_m = ragged_walk_kernels()
    print(f"ragged shapes: backtrace bit-equal to the plain version on {n_w} "
          f"seeded calls, minplus on {n_m} (testing_tools/walk_cases), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    n_a = ragged_assemble((oval, mb))
    print(f"ragged shapes: assemble bit-equal to the plain version on {n_a} "
          f"seeded calls on the oval and unclosed Monteblanco "
          f"(testing_tools/assemble_cases), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. the fleet tick, kernels vs plain, three mixes ------------------
    mixes = [
        ("oval_1opp", oval, dict(n_objects=1)),
        ("oval_3opp_o16", oval, dict(n_objects=3, o_pad=sc.O_PAD)),
        ("unclosed_monteblanco_1opp", mb, dict(n_objects=1)),
    ]
    launches = None
    for mix, lat, skw in mixes:
        scen = sc.random_scenarios(lat, B, seed=0, device="cuda", **skw)
        tick_k = sc.make_batched_tick(lat, device="cuda")
        tick_p = sc.make_batched_tick(lat, device="cuda", kernels=False)
        # the launches counted and the calls recorded on the eager body
        # (a replay runs no Python), its outputs held against plain here
        # and against the compiled tick in phase 12
        for _, path, *_ in KERNELS:
            wrapper(path).launches = 0
        with Recorder({k: targets[k] for k in REDESIGNED}) as mix_rec:
            out_k = tick_k.__wrapped__(scen)
        torch.cuda.synchronize()
        counts = {name: wrapper(path).launches
                  for name, path, *_ in KERNELS[:len(FLEET)]}
        _check(all(c > 0 for c in counts.values()),
               f"{mix}: a kernel was not launched: {counts}")
        if launches is None:
            launches = counts
        out_p = tick_p(scen)
        torch.cuda.synchronize()
        for k in ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel",
                  "em_base"):
            _check(torch.equal(out_k[k], out_p[k]), f"{mix}: {k} differs")
        d = (out_k["trajs"].double() - out_p["trajs"].double()).abs()
        d_pos = float(d[..., 0:3].max())
        d_vx = float(d[..., 5].max())
        _check(d_pos <= 2e-3 and d_vx <= 0.02,
               f"{mix}: trajs deviate by {d_pos} m, {d_vx} m/s")
        tr = out_k["trajs"]
        _check(bool(torch.isfinite(tr).all()), f"{mix}: non-finite trajs")
        _check(tr.shape[:2] == (B, sc.N_OUT), f"{mix}: shape {tr.shape}")
        n_valid_actions = int(out_k["valid"].sum())
        _check(n_valid_actions > 0, f"{mix}: no valid action")
        tick_k(scen)                    # the capture
        ts = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick_k(scen)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        tp = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tick_p(scen)
            torch.cuda.synchronize()
            tp.append(time.perf_counter() - t0)
        t_med, tp_med = float(np.median(ts)), float(np.median(tp))
        if mix != "oval_1opp":          # that mix's calls were timed above
            for name in REDESIGNED:
                for a, kw in mix_rec.calls[name]:
                    held_and_timed(name, f"{mix} call",
                                   getattr(*targets[name]), plains[name],
                                   a, kw, 5)
        print(f"tick {mix} B={B} O={scen.obj_pos.shape[1]} on {card}: "
              f"kernel launches {counts}; equal fields equal; "
              f"max|d pos|={d_pos:.3g} m max|d vx|={d_vx:.3g} m/s; "
              f"valid actions {n_valid_actions}; kernel tick (compiled) "
              f"{t_med * 1e3:.2f} ms = {B / t_med:.1f} replans/s; plain "
              f"tick {tp_med * 1e3:.2f} ms = {B / tp_med:.1f} replans/s",
              flush=True)

    # where the time goes: one eager kernel tick (oval, 1 opponent) under
    # torch.profiler — device kernels launched and their summed time (the
    # compiled tick's profile is phase 12's)
    tick_k = sc.make_batched_tick(oval, device="cuda").__wrapped__
    tick_k(scen1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick_k(scen1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = fb_prof = profile_device(lambda: tick_k(scen1))
    if prof["n"]:
        print(f"profile tick oval_1opp B={B} eager on {card}: {prof['n']} "
              f"device kernels, device busy {prof['busy_ms']:.2f} ms of a "
              f"{wall_ms:.2f} ms unprofiled tick "
              f"({100 * prof['busy_ms'] / wall_ms:.1f} %); top: "
              + "; ".join(prof["top"]))
    else:
        print("profile: the profiler saw no device time (not measured)")

    # single-replan latency through the kernel tick (compiled)
    scen_b1 = sc.random_scenarios(oval, 1, seed=1, device="cuda")
    tick_k = sc.make_batched_tick(oval, device="cuda")
    tick_k(scen_b1)
    lat_s = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick_k(scen_b1)
        torch.cuda.synchronize()
        lat_s.append(time.perf_counter() - t0)
    print(f"single replan (B=1, oval, compiled) on {card}: p50 "
          f"{np.percentile(lat_s, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(lat_s, 99) * 1e3:.2f} ms")

    # ---- 6. the dense-window search through the min-plus kernel ----------
    win_args, start4, shrink4 = dense_window_inputs(oval, scen1)
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
    # counted on the eager body (a replay runs no Python); the compiled
    # dense window below, held against it in phase 14
    with cuda_graph.disabled():
        dense = pg.plan_window_dense(*win_args)
    h_goal4 = dense["h_goal"].long()[:, None].expand(B, 4)
    with Recorder({"backtrace": targets["backtrace"]}) as dense_rec:
        sw = srch.search_window(dense["w_all"], start4, dense["vg"],
                                h_goal4, shrink4)
    torch.cuda.synchronize()
    dense_counts = {name: wrapper(path).launches
                    for name, path, *_ in KERNELS}
    _check(dense_counts["minplus"] > 0 and dense_counts["backtrace"] > 0,
           f"dense window: a kernel was not launched: {dense_counts}")
    scan = pg.plan_window_kernel(*win_args)
    for k in ("best", "bp", "vg"):
        _check(torch.equal(dense[k], scan[k]),
               f"plan_window_dense {k} != plan_window_kernel {k}")
    sw_p = srch.search_window(dense["w_all"], start4, dense["vg"], h_goal4,
                              shrink4, kernels=False)
    for k in ("nodes", "h_eff", "goal_node", "cost", "feasible"):
        _check(torch.equal(sw[k], sw_p[k]), f"search_window {k} differs")
    n_feasible = int(sw["feasible"].sum())
    _check(n_feasible > 0, "search_window: no feasible row")
    for a, kw in dense_rec.calls["backtrace"]:
        held_and_timed("backtrace", "dense window call",
                       cuda_backtrace.backtrace_walk, plains["backtrace"],
                       a, kw, 5)
    w_all = dense["w_all"]
    po = cuda_minplus.minplus_scan_plain(w_all, start4)
    for x in po:
        _spoil(x.shape, x.dtype)
    ko = cuda_minplus.minplus_scan(w_all, start4)
    torch.cuda.synchronize()
    for x, y in zip(ko, po):
        _check(torch.equal(x, y), "minplus: not bit-equal")
    mp_ms = _device_ms(lambda: cuda_minplus.minplus_scan(w_all, start4))
    mp_wrapper_ms = _median_ms(
        lambda: cuda_minplus.minplus_scan(w_all, start4), 30)
    mp_plain_ms = _median_ms(
        lambda: cuda_minplus.minplus_scan_plain(w_all, start4), 20)
    R = w_all.shape[0] * 4
    nb, ops = _cost_minplus(w_all.reshape(R, *w_all.shape[2:]),
                            start4.to(torch.int32), *ko)
    t_b, t_o = nb / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    stats["minplus"] = dict(ms=mp_ms, wrapper_ms=mp_wrapper_ms,
                            plain_ms=mp_plain_ms,
                            bound_ms=max(t_b, t_o), err=0.0,
                            bound_by="bytes" if t_b >= t_o else "operations")
    print(f"kernel minplus call {R} rows [{'x'.join(map(str, w_all.shape))}]"
          f": max|kernel-plain|=0 (best, bp bit-equal) kernel {mp_ms:.4f} ms "
          f"on the device, {mp_wrapper_ms:.4f} ms a wrapper call; plain "
          f"{mp_plain_ms:.4f} ms bound {max(t_b, t_o):.4f} ms "
          f"({stats['minplus']['bound_by']}: {nb} B, {ops} ops)", flush=True)
    print(f"dense window B={B} on {card}: kernel launches "
          f"{ {k: v for k, v in dense_counts.items() if v} }; "
          f"plan_window_dense best/bp/vg equal plan_window_kernel's; "
          f"search_window kernels == plain ({n_feasible} of {R} rows "
          f"feasible)", flush=True)
    # the compiled dense window (one CUDA graph per signature): its first
    # call captures, its graph's pool holds w_all and the window's samples
    t0 = time.perf_counter()
    dense_c = pg.plan_window_dense(*win_args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    _same("compiled dense window", dense_c, dense)
    (dense_call,) = pg.plan_window_dense.compiled[
        torch.device("cuda", torch.cuda.current_device())].graphs.values()
    print(f"compiled dense window B={B} on {card}: every field torch.equal "
          f"to the eager call's; first call {first_ms:.1f} ms (warm-up "
          f"{dense_call.warmup_ms:.1f} ms, capture "
          f"{dense_call.capture_ms:.1f} ms, graph pool "
          f"{dense_call.pool_bytes / 2 ** 20:.1f} MiB; w_all "
          f"{_nbytes(dense['w_all']) / 2 ** 20:.1f} MiB)", flush=True)
    # the pool is freed until phase 14 captures the window again
    del dense_c
    pg.plan_window_dense.compiled.clear()

    # ---- 7. the interactive facade, kernels vs plain on the card ----------
    store = os.path.join(ROOT, "artifacts", "chip_smoke")
    os.makedirs(store, exist_ok=True)
    # the planner's messages go to a file under the store (a facade adds its
    # console handlers only to a logger that has none)
    plog = logging.getLogger("local_trajectory_logger")
    plog.addHandler(logging.FileHandler(os.path.join(store, "planner.log")))
    plog.setLevel(logging.INFO)
    facade_targets = {name: targets[name] for name in FACADE}
    facade_plain = {
        "hit_slab": cuda_collision.hit_slab_plain,
        "window_dp": cuda_window.fused_window_dp_plain,
        "backtrace": cuda_backtrace.backtrace_walk_plain,
        "vel_scan": velops.stacked_vel_scan,
        "assemble": cuda_assemble.assemble_path_plain,
    }
    tracks = [
        ("oval", "oval", FACADE_TICKS_OVAL, 0, (15,)),
        ("unclosed_monteblanco", os.path.join(
            ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv"),
         FACADE_TICKS_UNCLOSED, FACADE_START_LAYER_UNCLOSED, (40, 95)),
    ]
    facade_counts = {}
    facade_ms = {name: 0.0 for name in FACADE}
    facade_wrapper_ms = {name: 0.0 for name in FACADE}
    for tname, track, n_ticks, start_layer, rec_ticks in tracks:
        pd = {"globtraj_input_path": track,
              "graph_store_path": os.path.join(store, f"{tname}.npz"),
              "ltpl_offline_param_path": os.path.join(
                  ROOT, "params/ltpl_config_offline.ini"),
              "ltpl_online_param_path": os.path.join(
                  ROOT, "params/ltpl_config_online.ini"),
              "graph_log_id": tname,
              "log_path": os.path.join(store, "logs")}
        ltpl_k = GraphLTPL(pd, device="cuda")
        ltpl_k.graph_init()
        if tname == "oval":             # replayed from its log in phase 11
            oval_log = (ltpl_k._path_dict["graph_log_data_path"],
                        ltpl_k.lattice)
            oval_archive = (oval_log[0], ltpl_k._path_dict["graph_log_path"])
        ltpl_p = GraphLTPL(pd, device="cuda", kernels=False,
                           log_to_file=False)
        ltpl_p.graph_init()
        h = ltpl_k._oth
        pos, heading = cl.start_pose(h.np_refline, start_layer)
        objs = zones = None
        if tname == "oval":
            objs = cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl)
            zones = cl.left_half_zone(h.np_nodes_in_layer)
        for _, path, *_ in KERNELS:
            wrapper(path).launches = 0
        recorder = Recorder(facade_targets)
        recorder.on = False

        def on_tick(tick, _r=recorder, _ticks=rec_ticks):
            _r.on = (tick + 1) in _ticks
        t0 = time.perf_counter()
        # the facade's compiled calls run eagerly, so that the counters and
        # the recorder see every kernel call (phase 13 holds the compiled
        # calls against these)
        with recorder, cuda_graph.disabled():
            rec_k = cl.drive(ltpl_k, n_ticks, pos, heading, objs, zones,
                             on_tick=on_tick)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = {name: wrapper(path).launches for name, path, *_ in KERNELS}
        _check(all(counts[k] > 0 for k in FACADE),
               f"facade {tname}: a kernel was not launched: {counts}")
        t0 = time.perf_counter()
        rec_p = cl.drive(ltpl_p, n_ticks, pos, heading, zones=zones,
                         replay=rec_k)
        t_p = time.perf_counter() - t0
        d_pos, d_vx, seen = cl.compare(rec_k, rec_p)
        _check(d_pos <= 2e-3 and d_vx <= 0.02,
               f"facade {tname}: trajs deviate by {d_pos} m, {d_vx} m/s")
        for r in rec_k:
            for trajs in r["traj_set"].values():
                for t in trajs:
                    _check(t.ndim == 2 and t.shape[1] == 7
                           and bool(np.isfinite(t).all()),
                           f"facade {tname}: bad trajectory {t.shape}")
        if tname == "oval":
            _check(seen == {"straight", "follow", "left", "right",
                            "emergency"}, f"facade oval: actions {seen}")
            facade_counts = {k: v / n_ticks for k, v in counts.items()}
        per_tick = {k: round(v / n_ticks, 3) for k, v in counts.items()
                    if v}
        print(f"facade {tname} {n_ticks} ticks (start layer {start_layer}) "
              f"on {card}: kernel launches {counts} = per tick {per_tick}; "
              f"action sets and node chains equal on every tick, actions "
              f"{sorted(seen)}; max|d s,x,y|={d_pos:.3g} m max|d vx|="
              f"{d_vx:.3g} m/s; kernel drive {t_k:.1f} s, plain replay "
              f"{t_p:.1f} s", flush=True)

        # every kernel call of the recorded ticks against its plain version
        n_inf = 0
        for name in FACADE:
            kern = getattr(*facade_targets[name])
            _check(recorder.calls[name],
                   f"facade {tname}: no {name} call recorded")
            for a, kw in recorder.calls[name]:
                po = facade_plain[name](*a, **kw)
                po_t = _as_tuple(po)
                for x in po_t:
                    _spoil(x.shape, x.dtype)
                ko = kern(*a, **kw)
                torch.cuda.synchronize()
                ko_t = _as_tuple(ko)
                err = max(float((x.double() - y.double()).abs().max())
                          for x, y in zip(ko_t, po_t))
                if name == "vel_scan":
                    n_inf += int(torch.isinf(a[7]).any(dim=1).sum())
                for x, y in zip(ko_t, po_t):
                    _check(torch.equal(x, y), f"facade {name}: not "
                           f"bit-equal, max |kernel - plain| {err}")
                ms = _device_ms(lambda: kern(*a, **kw))
                wrapper_ms = _median_ms(lambda: kern(*a, **kw), 20)
                if tname == "oval":
                    facade_ms[name] += ms
                    facade_wrapper_ms[name] += wrapper_ms
                stats[name]["err"] = max(stats[name]["err"], err)
                shape = _call_shape(name, a)
                bound = ""
                if name in REDESIGNED:
                    b_ms, by = _bound(*_cost(name, a, kw, ko))
                    bound = f"; bound {b_ms:.5f} ms ({by})"
                if name == "backtrace":
                    chain_ms, _ = wv.walk_chain(_device_ms, cuda_build,
                                                bt_variant, a, kw)
                    bound += f"; one walk on chip {chain_ms:.5f} ms"
                    if tname == "oval":
                        stats[name]["facade_chain_floor_ms"] = chain_ms
                print(f"kernel {name} facade {tname} ticks "
                      f"{list(rec_ticks)} call [{shape}]: max|kernel-plain|="
                      f"{err:.3g} (bit-equal) kernel {ms:.4f} ms on the "
                      f"device, {wrapper_ms:.4f} ms a wrapper call{bound}",
                      flush=True)
        print(f"facade {tname}: velocity rows with a +inf limit checked: "
              f"{n_inf}", flush=True)

    # ---- 8. facade latency on the real clock -------------------------------
    pd_lat = dict(pd, globtraj_input_path="oval",
                  graph_store_path=os.path.join(store, "oval.npz"))
    ltpl_t = GraphLTPL(pd_lat, device="cuda", log_to_file=False)
    ltpl_t.graph_init()
    h = ltpl_t._oth
    pos, heading = cl.start_pose(h.np_refline)
    timings = []
    with cuda_graph.disabled():         # the compiled facade's is phase 13's
        cl.drive(ltpl_t, 100, pos, heading,
                 cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl),
                 cl.left_half_zone(h.np_nodes_in_layer), fake_clock=False,
                 timings=timings)
    tt = np.asarray(timings[5:]) * 1e3
    lat_p50, lat_p99 = np.percentile(tt, 50), np.percentile(tt, 99)
    print(f"facade latency (oval, eager calls, calc_paths + "
          f"calc_vel_profile, ticks 5-99) on {card}: p50 {lat_p50:.2f} ms p99 {lat_p99:.2f} ms max "
          f"{tt.max():.2f} ms (budget 100 ms)", flush=True)
    _check(lat_p99 < 1000.0, f"facade latency p99 {lat_p99} ms")

    # ---- 9. the SQP backend: the ADMM kernel, the fleet tick, the facade --
    from graphbasedlocaltrajectoryplanner_torch.planner import handler
    t_sqp = time.perf_counter()
    n_admm = ragged_admm()
    print(f"ragged shapes: admm_vel bit-equal to the plain version on "
          f"{n_admm} seeded calls (testing_tools/admm_cases)", flush=True)

    sqp_kw = profile_stages.sqp_options(oval)
    tick_k = sc.make_batched_tick(oval, device="cuda", **sqp_kw)
    tick_p = sc.make_batched_tick(oval, device="cuda", kernels=False,
                                  **sqp_kw)
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
    admm_target = {"admm_vel": (cuda_admm, "admm_vel")}
    # counted and recorded on the eager body, as in the mixes
    with Recorder(admm_target) as sqp_rec:
        out_k = tick_k.__wrapped__(scen1)
    torch.cuda.synchronize()
    sqp_fleet_counts = {name: wrapper(path).launches
                        for name, path, *_ in KERNELS}
    _check(all(sqp_fleet_counts[k] > 0 for k in
               ("hit_slab", "window_dp", "backtrace", "vel_scan",
                "admm_vel")),
           f"sqp fleet tick: a kernel was not launched: {sqp_fleet_counts}")
    out_p = tick_p(scen1)
    torch.cuda.synchronize()
    for k in ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel",
              "em_base", "qp_status"):
        _check(torch.equal(out_k[k], out_p[k]), f"sqp fleet tick: {k} differs")
    d = (out_k["trajs"].double() - out_p["trajs"].double()).abs()
    d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
    d_raw = float((out_k["vx_sqp"] - out_p["vx_sqp"]).abs().max())
    _check(d_pos <= 2e-3 and d_vx <= 0.02 and d_raw <= 0.02,
           f"sqp fleet tick: trajs deviate by {d_pos} m, {d_vx} m/s, "
           f"vx_sqp by {d_raw} m/s")
    _check(bool(torch.isfinite(out_k["trajs"]).all())
           and int(out_k["valid"].sum()) > 0, "sqp fleet tick: bad result")
    status = {c: int((out_k["qp_status"] == c).sum()) for c in (0, 2, -3)}
    # the next ticks start warm from this tick's profiles
    warm = out_k["vx_sqp"]
    tick_k(scen1, sqp_x0=warm)          # the capture
    ts = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick_k(scen1, sqp_x0=warm)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    tp = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick_p(scen1, sqp_x0=warm)
        torch.cuda.synchronize()
        tp.append(time.perf_counter() - t0)
    t_med, tp_med = float(np.median(ts)), float(np.median(tp))
    print(f"tick oval_1opp sqp B={B} on {card}: kernel launches "
          f"{ {k: v for k, v in sqp_fleet_counts.items() if v} }; equal "
          f"fields and qp_status equal (statuses {status}); max|d pos|="
          f"{d_pos:.3g} m max|d vx|={d_vx:.3g} m/s max|d vx_sqp|={d_raw:.3g}"
          f" m/s; kernel tick (compiled) {t_med * 1e3:.2f} ms = "
          f"{B / t_med:.1f} "
          f"replans/s; plain tick {tp_med * 1e3:.2f} ms = "
          f"{B / tp_med:.1f} replans/s", flush=True)
    # where the time of a warm sqp tick goes (torch.profiler), the eager
    # body beside the compiled tick's time (the compiled profile is phase
    # 12's)
    prof = profile_device(lambda: tick_k.__wrapped__(scen1, sqp_x0=warm))
    if prof["n"]:
        admm_ms = prof["ms_of"]("admm")
        print(f"profile tick oval_1opp sqp B={B} warm eager on {card}: "
              f"{prof['n']} device kernels, device busy "
              f"{prof['busy_ms']:.2f} ms of a {t_med * 1e3:.2f} ms "
              f"unprofiled compiled tick "
              f"({100 * prof['busy_ms'] / (t_med * 1e3):.1f} %); admm_vel "
              f"{admm_ms:.3f} ms on the device "
              f"({100 * admm_ms / prof['busy_ms']:.1f} % of the busy time, "
              f"{100 * admm_ms / (t_med * 1e3):.1f} % of the tick); top: "
              + "; ".join(prof["top"]), flush=True)
    else:
        print("profile sqp tick: the profiler saw no device time (not "
              "measured)")
    a, kw = sqp_rec.calls["admm_vel"][0]
    # one row's chain of 150 steps: the slope between 150 and 600 steps on
    # the fleet call's first row alone
    admm_chain_ms, one_ms, four_ms = av.chain_floor(_device_ms, a[0], kw)
    print(f"chain admm_vel fleet call row 0: one row's {av.STEPS} steps "
          f"{admm_chain_ms:.5f} ms on {card} (slope between {av.STEPS} and "
          f"{4 * av.STEPS} steps); kernel on 1 row {one_ms:.4f} ms, on 4 "
          f"rows {four_ms:.4f} ms", flush=True)
    stats["admm_vel"] = admm_held_and_timed("fleet call", a[0], kw, 3,
                                            admm_variant, admm_chain_ms)
    stats["admm_vel"]["chain_floor_ms"] = admm_chain_ms
    stats["admm_vel"]["plain_launches"] = plain_admm_launches(a[0], kw)
    print(f"plain admm_vel, one fleet solve on the card: "
          f"{stats['admm_vel']['plain_launches']} device kernels",
          flush=True)

    # the facade under the SQP INI on the oval, kernels against plain
    ltpl_k = GraphLTPL(_sqp_pd(store, "oval", "oval"), device="cuda")
    ltpl_k.graph_init()
    ltpl_p = GraphLTPL(_sqp_pd(store, "oval", "oval"), device="cuda",
                       kernels=False, log_to_file=False)
    ltpl_p.graph_init()
    h = ltpl_k._oth
    pos, heading = cl.start_pose(h.np_refline)
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
    fac_rec = Recorder(admm_target)
    fac_rec.on = False

    def on_tick(tick, _r=fac_rec):
        _r.on = (tick + 1) == 15
    timings = []
    with fac_rec, cuda_graph.disabled():
        rec_k = cl.drive(ltpl_k, SQP_TICKS_OVAL, pos, heading,
                         cl.slow_opponent(h.np_raceline, h.np_normvec,
                                          h.np_s_rl),
                         cl.left_half_zone(h.np_nodes_in_layer),
                         on_tick=on_tick, timings=timings)
    torch.cuda.synchronize()
    sqp_facade_counts = {name: wrapper(path).launches / SQP_TICKS_OVAL
                         for name, path, *_ in KERNELS}
    _check(all(sqp_facade_counts[k] > 0 for k in
               ("hit_slab", "window_dp", "backtrace", "vel_scan",
                "admm_vel")),
           f"sqp facade: a kernel was not launched: {sqp_facade_counts}")
    t0 = time.perf_counter()
    rec_p = cl.drive(ltpl_p, SQP_TICKS_OVAL, pos, heading,
                     zones=cl.left_half_zone(h.np_nodes_in_layer),
                     replay=rec_k)
    t_p = time.perf_counter() - t0
    d_pos, d_vx, seen = cl.compare(rec_k, rec_p)
    _check(d_pos <= 2e-3 and d_vx <= 0.02,
           f"sqp facade oval: trajs deviate by {d_pos} m, {d_vx} m/s")
    _check(seen == {"straight", "follow", "left", "right", "emergency"},
           f"sqp facade oval: actions {seen}")
    _check(set(ltpl_k._oth.sqp_state) == set(ltpl_p._oth.sqp_state),
           "sqp facade oval: warm-start keys differ")
    d_state = max(float(np.abs(v - ltpl_p._oth.sqp_state[k]).max())
                  for k, v in ltpl_k._oth.sqp_state.items())
    tt = np.asarray(timings[5:]) * 1e3
    sqp_p50, sqp_p99 = np.percentile(tt, 50), np.percentile(tt, 99)
    print(f"facade sqp oval {SQP_TICKS_OVAL} ticks on {card}: kernel "
          f"launches per tick "
          f"{ {k: round(v, 3) for k, v in sqp_facade_counts.items() if v} };"
          f" action sets and node chains equal on every tick, actions "
          f"{sorted(seen)}; max|d s,x,y|={d_pos:.3g} m max|d vx|={d_vx:.3g} "
          f"m/s, warm-start store max|d|={d_state:.3g} m/s; latency "
          f"(fake clock, calc_paths + calc_vel_profile, ticks 5-"
          f"{SQP_TICKS_OVAL - 1}) p50 {sqp_p50:.2f} ms p99 {sqp_p99:.2f} ms; "
          f"plain replay {t_p:.1f} s", flush=True)
    a, kw = fac_rec.calls["admm_vel"][0]
    fac = admm_held_and_timed("facade tick 15 call", a[0], kw, 3,
                              admm_variant, admm_chain_ms)
    stats["admm_vel"]["facade_tick_ms"] = fac["ms"]
    stats["admm_vel"]["facade_baseline_ms"] = fac["baseline_ms"]
    stats["admm_vel"]["facade_tick_wrapper_ms"] = fac["wrapper_ms"]
    stats["admm_vel"]["facade_plain_ms"] = fac["plain_ms"]
    stats["admm_vel"]["facade_bound_ms"] = fac["bound_ms"]

    # into the unclosed Monteblanco end: the SQP backup ladder
    pd_u = _sqp_pd(store, "unclosed_monteblanco", os.path.join(
        ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv"))
    ltpl_u = GraphLTPL(pd_u, device="cuda", log_to_file=False)
    ltpl_u.graph_init()
    ladder = []
    real_em = handler.vp.brake_em_sqp_kernel

    def em_counted(*a, **k):
        ladder.append(wrapper("cuda_admm.admm_vel").launches)
        out = real_em(*a, **k)
        ladder[-1] = wrapper("cuda_admm.admm_vel").launches - ladder[-1]
        return out
    handler.vp.brake_em_sqp_kernel = em_counted
    lad_rec = Recorder(admm_target)
    try:
        pos, heading = cl.start_pose(ltpl_u._oth.np_refline,
                                     SQP_START_LAYER_UNCLOSED)
        with lad_rec, cuda_graph.disabled():
            cl.drive(ltpl_u, SQP_TICKS_UNCLOSED, pos, heading)
        torch.cuda.synchronize()
    finally:
        handler.vp.brake_em_sqp_kernel = real_em
    _check(ladder and all(n == 1 for n in ladder),
           f"sqp unclosed: the SQP ladder was not taken ({ladder})")
    lad_calls = [(a, kw) for a, kw in lad_rec.calls["admm_vel"]
                 if a[0]["q"].dim() == 1]
    lad = admm_held_and_timed("ladder call", lad_calls[0][0][0],
                              lad_calls[0][1], 3, admm_variant, admm_chain_ms)
    stats["admm_vel"]["ladder_ms"] = lad["ms"]
    stats["admm_vel"]["ladder_baseline_ms"] = lad["baseline_ms"]
    print(f"facade sqp unclosed_monteblanco {SQP_TICKS_UNCLOSED} ticks "
          f"(start layer {SQP_START_LAYER_UNCLOSED}) on {card}: SQP backup "
          f"ladder {len(ladder)} times, one admm_vel launch each", flush=True)
    print(f"sqp phases: {time.perf_counter() - t_sqp:.1f} s", flush=True)

    # ---- 10. the recorded reference run through the port ------------------
    from parity.replay_torch import replay
    t0 = time.perf_counter()
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
    with cuda_graph.disabled():
        rep, _ = replay(os.path.join(ROOT, REPLAY_FIXTURE), device="cuda")
    replay_counts = {name: wrapper(path).launches
                     for name, path, *_ in KERNELS}
    _check(all(replay_counts[k] > 0 for k in FACADE),
           f"replay: a kernel was not launched: {replay_counts}")
    _check(rep["pairs_compared"] >= rep["ticks"]
           and not rep["actions_missing_in_port"]
           and not rep["actions_extra_in_port"]
           and rep["max_d_pos_m"] < 0.02 and rep["max_d_vel_mps"] < 0.1,
           f"replay: {rep}")
    print(f"replay {rep['fixture']} {rep['ticks']} ticks on {card}: kernel "
          f"launches { {k: v for k, v in replay_counts.items() if v} }; max "
          f"|d pos| {rep['max_d_pos_m']:.3g} m, max |d vel| "
          f"{rep['max_d_vel_mps']:.3g} m/s against the reference (first "
          f"100 m: {rep['max_d_pos_exec_m']:.3g} m, "
          f"{rep['max_d_vel_exec_mps']:.3g} m/s); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 11. fleet-tick options, stage profile, log replay ----------------
    t_opt = time.perf_counter()
    options_phase(oval, scen1, card, wrapper, fb_prof)
    log_replay_phase(*oval_log, card, wrapper)
    print(f"options, stage profile and log replay: "
          f"{time.perf_counter() - t_opt:.1f} s", flush=True)

    # ---- 12. the host side: examples, viewer, visual mode, native, tools --
    host_side_phase(store, card, wrapper, oval, scen1, oval_archive,
                    (dense, sw, start4, h_goal4, shrink4))

    # ---- 13. multi-device: NCCL at world 1, four gloo ranks on the card --
    md = multi_device_phase(card, wrapper, oval, mb)

    # ---- 14. the entry tools: entry(), validate_tracks, the dry run -------
    et = entry_tools_phase(card, wrapper)

    # ---- 15. the compiled tick against its eager body ---------------------
    compiled_tick_phase(card, oval, mb)

    # ---- 16. the compiled facade against its eager calls -------------------
    compiled_facade_phase(card, store, wrapper)

    # ---- 17. the compiled sharded tick and dense window -------------------
    sharded_replay = compiled_sharded_phase(card, oval, win_args, md)

    # ---- 18. the port's bench and its parity gate, a fresh process --------
    bench_d = bench_phase(card, oval)
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all",
          flush=True)

    # ---- 19. summary lines ------------------------------------------------
    rows = []
    for name, path, src, repl in KERNELS:
        s = stats[name]
        main = (dense_counts if name == "minplus" else
                sqp_fleet_counts if name == "admm_vel" else launches)
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=main[name], max_abs_err=s["err"],
                         ms=s["ms"], wrapper_ms=s["wrapper_ms"],
                         plain_ms=s["plain_ms"],
                         bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                         library_ms=None,
                         chain_floor_ms=s.get("chain_floor_ms"),
                         facade_chain_floor_ms=s.get(
                             "facade_chain_floor_ms"),
                         launches_fleet_tick=launches.get(name, 0),
                         launches_facade_tick=facade_counts.get(name, 0.0),
                         launches_dense_window=dense_counts[name],
                         launches_sqp_fleet_tick=sqp_fleet_counts[name],
                         launches_sqp_facade_tick=sqp_facade_counts[name],
                         facade_tick_ms=s.get("facade_tick_ms",
                                              facade_ms.get(name)),
                         facade_tick_wrapper_ms=s.get(
                             "facade_tick_wrapper_ms",
                             facade_wrapper_ms.get(name)),
                         plain_launches_per_solve=s.get("plain_launches"),
                         facade_plain_ms=s.get("facade_plain_ms"),
                         facade_bound_ms=s.get("facade_bound_ms"),
                         ladder_ms=s.get("ladder_ms"),
                         design=s.get("design"),
                         baseline_ms=s.get("baseline_ms"),
                         facade_baseline_ms=s.get("facade_baseline_ms"),
                         ladder_baseline_ms=s.get("ladder_baseline_ms"),
                         bound_nofma_ms=s.get("bound_nofma_ms"),
                         launches_sharded_tick_nccl_world1=md["nccl"][name],
                         launches_compiled_sharded_dp_replay=sharded_replay[
                             "dp"][name],
                         launches_compiled_sharded_spatial_replay=(
                             sharded_replay["spatial (dp=1, mp=1)"][name]),
                         launches_sharded_dp4_rank=md["rank"]["a"][name],
                         launches_sharded_dp2_mp2_rank=md["rank"]["b"][name],
                         launches_spatial_mp4_rank=md["rank"]["c"][name],
                         launches_entry_tick=et["entry"][name],
                         launches_bench_parity=bench_d["parity"]["kernels"][
                             name]["launches"],
                         launches_dryrun_dp4_rank=et["dryrun"]["dp"][name],
                         launches_dryrun_spatial_mp4_rank=et["dryrun"][
                             "spatial"][name],
                         launches_dryrun_dp2_mp2_rank=et["dryrun"][
                             "dp_mp"][name],
                         **({f"spatial_call_{k}": md["spatial"][name][k]
                             for k in ("ms", "wrapper_ms", "plain_ms",
                                       "bound_ms", "bound_by")}
                            if name in md["spatial"] else {})))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
