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
   cases of ``testing_tools/walk_cases``, and the velocity scans'
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
   their plain versions and timed too;
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
   call is held against its plain version;
5. times the facade per tick (``calc_paths`` + ``calc_vel_profile``) on
   the real clock;
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
   cumulative stage times; the log replay (``utils/replay.py``) of the
   data log that the oval facade drive of 4 wrote, with the kernels and
   with the plain versions, equal reports;
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
   ``profile_sqp.qp_micro``.

The facade's lattice cache, logs and messages go to ``artifacts/chip_smoke/``
inside the checkout.

Prints the card and its power limit, per-kernel and per-mix lines, one
``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure is an exception and a
non-zero exit; without a CUDA device it exits non-zero before printing.
"""

from __future__ import annotations

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
    # five run in the fleet tick, the last in the dense-window search)
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
    ("minplus", "cuda_minplus.minplus_scan", CSRC + "minplus.cu",
     TPU + "pallas_minplus.py:90"),
    # no Pallas kernel: the JAX package's ADMM is a lax.scan in XLA
    ("admm_vel", "cuda_admm.admm_vel", CSRC + "admm_vel.cu",
     TPU + "qp.py:211"),
]
FLEET = ("hit_slab", "window_dp", "backtrace", "vel_scan_cgg", "vel_scan")
# timed in every fleet mix and in the facade, beside their bounds
REDESIGNED = ("hit_slab", "window_dp", "backtrace")
# the kernels of the interactive facade's path
FACADE = ("hit_slab", "window_dp", "backtrace", "vel_scan")
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
    po_t = po if isinstance(po, tuple) else (po,)
    for x in po_t:
        _spoil(x.shape, x.dtype)
    ko = kern(*a, **kw)
    torch.cuda.synchronize()
    ko_t = ko if isinstance(ko, tuple) else (ko,)
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
    shape = "x".join(str(d) for d in a[0].shape)
    rows = a[1].shape[0] if name == "backtrace" else a[0].shape[0]
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
    """``fn()`` once under ``torch.profiler``: its device kernels (kernel
    events only: the aten ops that launch them carry the same device time
    again) as ``dict(n, busy_ms, top, ms_of)``, ``top`` the six longest by
    name, ``ms_of(word)`` the device time of the kernels whose name holds
    ``word``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the profiler also draws a device span per gltpl.* range: not a kernel
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and self_dev_us(e) > 0
           and not e.key.startswith("gltpl.")]
    top = sorted(dev, key=self_dev_us, reverse=True)[:6]
    return dict(
        n=sum(e.count for e in dev),
        busy_ms=sum(self_dev_us(e) for e in dev) / 1e3,
        top=[f"{e.key[:48]} x{e.count} {self_dev_us(e) / 1e3:.3f} ms"
             for e in top],
        ms_of=lambda word: sum(self_dev_us(e) for e in dev
                               if word in e.key) / 1e3)


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


def _run_counted(wrapper, fn):
    """``fn()`` with every kernel's launch count set to 0 just before it
    and read just after (synchronised)."""
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
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
         {"hit_slab", "window_dp", "backtrace"}),
        ("until=decide", dict(until="decide"), ("src", "h_eff", "valid"),
         "h_eff", {"hit_slab", "window_dp"}),
    ]
    for label, kw, fields, traj, need in runs:
        tick_k = sc.make_batched_tick(oval, device="cuda", **kw)
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
    tick_k = sc.make_batched_tick(oval, device="cuda", **sqp_kw)
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
    print(f"stage timings tick oval_1opp fb B={B} on {card} (host clock, "
          f"synchronised; median of 3 windows of 10): {st['stage_ms']} ms, "
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
MIN_EXAMPLE_TICKS = 60
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


def main():
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_admm, cuda_backtrace, cuda_build, cuda_collision, cuda_minplus,
        cuda_velocity, cuda_window)
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
                cuda_minplus=cuda_minplus, cuda_admm=cuda_admm)

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
    with Recorder(targets) as recorder:
        tick_k(scen1)
    torch.cuda.synchronize()
    calls = recorder.calls

    plains = {
        "hit_slab": cuda_collision.hit_slab_plain,
        "window_dp": cuda_window.fused_window_dp_plain,
        "backtrace": cuda_backtrace.backtrace_walk_plain,
        "vel_scan_cgg": lambda *a: velops.stacked_vel_scan_cgg_auto(
            *a, kernels=False),
        "vel_scan": velops.stacked_vel_scan,
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
        for _, path, *_ in KERNELS:
            wrapper(path).launches = 0
        with Recorder({k: targets[k] for k in REDESIGNED}) as mix_rec:
            out_k = tick_k(scen)
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
              f"valid actions {n_valid_actions}; kernel tick "
              f"{t_med * 1e3:.2f} ms = {B / t_med:.1f} replans/s; plain "
              f"tick {tp_med * 1e3:.2f} ms = {B / tp_med:.1f} replans/s",
              flush=True)

    # where the time goes: one kernel tick (oval, 1 opponent) under
    # torch.profiler — device kernels launched and their summed time
    tick_k = sc.make_batched_tick(oval, device="cuda")
    tick_k(scen1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tick_k(scen1)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = fb_prof = profile_device(lambda: tick_k(scen1))
    if prof["n"]:
        print(f"profile tick oval_1opp B={B} on {card}: {prof['n']} device "
              f"kernels, device busy {prof['busy_ms']:.2f} ms of a "
              f"{wall_ms:.2f} ms unprofiled tick "
              f"({100 * prof['busy_ms'] / wall_ms:.1f} %); top: "
              + "; ".join(prof["top"]))
    else:
        print("profile: the profiler saw no device time (not measured)")

    # single-replan latency through the kernel tick
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
    print(f"single replan (B=1, oval) on {card}: p50 "
          f"{np.percentile(lat_s, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(lat_s, 99) * 1e3:.2f} ms")

    # ---- 6. the dense-window search through the min-plus kernel ----------
    win_args, start4, shrink4 = dense_window_inputs(oval, scen1)
    for _, path, *_ in KERNELS:
        wrapper(path).launches = 0
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
        with recorder:
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
                po_t = po if isinstance(po, tuple) else (po,)
                for x in po_t:
                    _spoil(x.shape, x.dtype)
                ko = kern(*a, **kw)
                torch.cuda.synchronize()
                ko_t = ko if isinstance(ko, tuple) else (ko,)
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
                shape = "x".join(str(d) for d in a[0].shape)
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
    cl.drive(ltpl_t, 100, pos, heading,
             cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl),
             cl.left_half_zone(h.np_nodes_in_layer), fake_clock=False,
             timings=timings)
    tt = np.asarray(timings[5:]) * 1e3
    lat_p50, lat_p99 = np.percentile(tt, 50), np.percentile(tt, 99)
    print(f"facade latency (oval, calc_paths + calc_vel_profile, ticks "
          f"5-99) on {card}: p50 {lat_p50:.2f} ms p99 {lat_p99:.2f} ms max "
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
    with Recorder(admm_target) as sqp_rec:
        out_k = tick_k(scen1)
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
          f" m/s; kernel tick {t_med * 1e3:.2f} ms = {B / t_med:.1f} "
          f"replans/s; plain tick {tp_med * 1e3:.2f} ms = "
          f"{B / tp_med:.1f} replans/s", flush=True)
    # where the time of a warm sqp tick goes (torch.profiler)
    prof = profile_device(lambda: tick_k(scen1, sqp_x0=warm))
    if prof["n"]:
        admm_ms = prof["ms_of"]("admm")
        print(f"profile tick oval_1opp sqp B={B} warm on {card}: "
              f"{prof['n']} device kernels, device busy "
              f"{prof['busy_ms']:.2f} ms of a {t_med * 1e3:.2f} ms "
              f"unprofiled tick ({100 * prof['busy_ms'] / (t_med * 1e3):.1f}"
              f" %); admm_vel {admm_ms:.3f} ms on the device "
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
    with fac_rec:
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
        with lad_rec:
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
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all",
          flush=True)

    # ---- 13. summary lines ------------------------------------------------
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
                         bound_nofma_ms=s.get("bound_nofma_ms")))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
