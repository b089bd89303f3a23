"""Per-stage timing and attribution of the batched fleet tick (torch) —
counterpart of the JAX package's ``parallel/profiling.py``.

The tick marks its stages with ``torch.profiler.record_function`` ranges,
the JAX package's ``jax.named_scope`` names with two renamed for the
kernels that replace its Pallas calls:

    JAX scope                   port range              stage
    gltpl.object_selection      gltpl.object_selection  window
    gltpl.plan_window           gltpl.plan_window       window
    gltpl.hit_slab_pallas       gltpl.hit_slab          window
    gltpl.plan_window_pallas    gltpl.window_dp         window
    gltpl.const_path_objects    gltpl.const_path_objects window
    gltpl.backtrace             gltpl.backtrace         assembly
    gltpl.assemble              gltpl.assemble          assembly
    gltpl.const_splice          gltpl.const_splice      assembly
    gltpl.velocity              gltpl.velocity          velocity
    gltpl.emergency             gltpl.emergency         velocity
    gltpl.qp_setup              gltpl.qp_setup          qp_setup
    gltpl.qp_factor             gltpl.qp_factor         qp_factor
    gltpl.qp_iters              gltpl.qp_iters          qp_iters

(``parallel/scenario.py``, ``planner/pathgen.plan_window_kernel`` and
``ops/qp.py``).  On the card the ADMM kernel (``csrc/admm_vel.cu``)
factors and iterates in one launch, so ``gltpl.qp_iters`` encloses the
whole solve there and ``gltpl.qp_factor`` is empty; the plain ADMM
(``qp.admm_vel_qp``) fills both.  The ranges stay outside the kernels'
wrappers, so a CUDA-graph capture of a wrapper call sees none of them.

:func:`stage_timings` times the cumulative stages through
``scenario._batched_window`` and the ``until="assembly"`` cutoff of
``scenario.scenario_tick``; :func:`stage_timings_trace` gives every device
kernel of the real tick to the innermost range that launched it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc

SCOPE_TO_STAGE = {
    "gltpl.object_selection": "window",
    "gltpl.plan_window": "window",
    "gltpl.hit_slab": "window",
    "gltpl.window_dp": "window",
    "gltpl.const_path_objects": "window",
    "gltpl.backtrace": "assembly",
    "gltpl.assemble": "assembly",
    "gltpl.const_splice": "assembly",
    "gltpl.velocity": "velocity",
    "gltpl.emergency": "velocity",
    "gltpl.qp_setup": "qp_setup",
    "gltpl.qp_factor": "qp_factor",
    "gltpl.qp_iters": "qp_iters",
}
FB_STAGES = ("window", "assembly", "velocity", "other")
SQP_STAGES = FB_STAGES + ("qp_setup", "qp_factor", "qp_iters")


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _time(fn, *a, iters: int = 10, dev=None):
    """Median over 3 windows of ``iters`` calls of the time of one call,
    each window closed by a device synchronise on the card; returns
    (seconds, last output)."""
    out = fn(*a)
    _sync(dev)
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*a)
        _sync(dev)
        dts.append(time.perf_counter() - t0)
    return float(np.median(dts)) / iters, out


def _setup(lat, scen, device):
    dev = resolve_device(device)
    if lat.device != dev:
        lat = lat.to(dev)
    if scen.start_layer.device != dev:
        scen = scen.to(dev)
    return lat, scen, dev


@torch.no_grad()
def stage_timings(lat, scen, iters: int = 10, p_max: int = None,
                  device=None, kernels: bool = True):
    """Time the three stages of the fleet tick (host clock, synchronised)
    and derive a roofline-style account, as the JAX package's
    ``stage_timings``.

    Stages (cumulative variants; deltas reported):
      1. ``window``   — obstacle selection, slab hit masks, the window DP
                        and the virtual-goal vectors (``_batched_window``);
      2. ``assembly`` — the decision tree, backtrace, C2-refit assembly and
                        const splice (``scenario_tick(until="assembly")`` on
                        the precomputed window);
      3. ``velocity`` — the velocity stage and the emergency profile (the
                        full tick minus stage 2).

    :returns: dict(stage_ms, stage_share, total_ms, roofline).
    """
    lat, scen, dev = _setup(lat, scen, device)
    if p_max is None:
        p_max = sc.default_p_max(lat)
    B = int(scen.start_layer.shape[0])
    zone = torch.zeros((lat.L, lat.N), dtype=torch.bool, device=dev)
    w_last = torch.tensor([0.0, 0.5, 0.8], dtype=torch.float32, device=dev)
    packed = sc.pg.packed_edge_table(lat)

    t_win, (obs, window) = _time(
        lambda: sc._batched_window(lat, scen, zone, w_last, kernels=kernels),
        iters=iters, dev=dev)
    pre = dict(obs=obs, window=window)

    def tick(until):
        return sc.scenario_tick(lat, scen, p_max=p_max, precomputed=pre,
                                until=until, kernels=kernels, packed=packed)

    t_asm, _ = _time(tick, "assembly", iters=iters, dev=dev)
    t_full, _ = _time(tick, None, iters=iters, dev=dev)

    ms = dict(window=t_win * 1e3, assembly=max(t_asm * 1e3, 0.0),
              velocity=max((t_full - t_asm) * 1e3, 0.0))
    total = t_win * 1e3 + t_full * 1e3

    # ---- roofline-style accounting ------------------------------------
    N, H, S = lat.N, lat.H_max, lat.S
    P_full = sc.C_PAD + p_max
    # the window DP reads the (H, N, N) cost slab for 4 slots a scenario
    # (the logical traffic it consumes)
    dp_bytes = B * 4 * H * N * N * 4
    # velocity: 4 stacked recurrence levels over P_full sequential steps
    vel_steps = 4 * P_full
    # assembly: ~(H x N) selects over S-sample edges per slot
    asm_flops = B * 4 * (H * N * S * 2 + p_max * 8)
    roofline = dict(
        batch=B,
        p_full=int(P_full),
        window_logical_gb_per_s=dp_bytes / max(t_win, 1e-9) / 1e9,
        velocity_sequential_steps=int(vel_steps),
        velocity_ns_per_step=(ms["velocity"] * 1e6) / max(vel_steps, 1),
        assembly_gflops_per_s=asm_flops / max(t_asm, 1e-9) / 1e9,
        device=str(dev),
        note=("host clock around synchronised calls; velocity is "
              "latency-bound (4 stacked levels x P_full sequential steps), "
              "the window DP reads the cost slab"),
    )
    shares = {k: v / max(total, 1e-9) for k, v in ms.items()}
    return dict(stage_ms={k: round(v, 3) for k, v in ms.items()},
                stage_share={k: round(v, 3) for k, v in shares.items()},
                total_ms=round(total, 3), roofline=roofline)


def range_cost_us(n: int = 20000) -> float:
    """Host microseconds of one empty ``gltpl.*`` range (``record_function``
    enter and exit) when no profiler listens, the mean over ``n``: what
    each range adds to a tick."""
    from torch.profiler import record_function
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("gltpl.cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def _is_range(e) -> bool:
    return e.name.startswith("gltpl.")


def _is_annotation(e) -> bool:
    """A range, or the profiler's own step marker (``ProfilerStep#n``,
    named ``ProfilerStep*`` in its events): on the device these are spans
    drawn around the kernels launched inside them, not kernels."""
    return _is_range(e) or e.name.startswith("ProfilerStep")


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def device_kernels(events):
    """The device kernels of a trace (not the spans drawn for annotations)."""
    return [e for e in events if _is_device(e) and not _is_annotation(e)]


def _launch_calls(events) -> dict:
    """Correlation id -> the CPU runtime call that launched the kernel."""
    launch_of = {}
    for e in events:
        if not _is_device(e) and e.name.startswith("cu"):
            launch_of.setdefault(e.id, e)
    return launch_of


def _owner(p) -> str:
    """The innermost ``gltpl.*`` range around CPU event ``p`` (a kernel's
    launch call, or a host operator), ``other`` if none or ``p`` is None."""
    while p is not None:
        if _is_range(p):
            return p.name
        p = p.cpu_parent
    return "other"


def attribute(events, iters: int, wall_ms: float = None):
    """Device time of a profiled run by ``gltpl.*`` range.

    Each device kernel goes to the innermost range that launched it: the
    kernel's runtime launch call (the CPU event with the kernel's
    correlation id) and then its ``cpu_parent`` chain in the profiler's
    event tree.  Launches are asynchronous, so the kernel itself may run
    after its range has closed on the host; the launch call may not.
    Kernels launched outside every range go to ``other``.  The device
    spans that the profiler draws for the ranges themselves and for its
    steps (named after them) are not kernels and are skipped.

    :param wall_ms: the host time of one run; ``other``'s host_ms is then
        what the outermost ranges leave of it.
    :returns: (stage_ms, scopes, unmatched) per run of ``iters``:
        ``scopes[name]`` = dict(device_ms, host_ms, launches) for every
        range seen (host_ms the range's CPU duration, nested ranges
        included) and ``other``; ``unmatched`` the kernels whose launch
        call the trace does not hold (counted in ``other``).
    """
    launch_of = _launch_calls(events)
    scopes = {}

    def scope(name):
        return scopes.setdefault(name, dict(device_ms=0.0, host_ms=0.0,
                                            launches=0))
    outer_ms = 0.0
    for e in events:
        if _is_range(e) and not _is_device(e):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            scope(e.name)["host_ms"] += ms
            p = e.cpu_parent
            while p is not None and not _is_range(p):
                p = p.cpu_parent
            outer_ms += ms if p is None else 0.0
    unmatched = 0
    for e in device_kernels(events):
        p = launch_of.get(e.id)
        unmatched += p is None
        s = scope(_owner(p))
        s["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        s["launches"] += 1
    stage_ms = {}
    for name, s in scopes.items():
        st = SCOPE_TO_STAGE.get(name, "other")
        stage_ms[st] = stage_ms.get(st, 0.0) + s["device_ms"] / iters
        for k in ("device_ms", "host_ms"):
            s[k] /= iters
        s["launches"] /= iters
    if wall_ms is not None:
        scope("other")["host_ms"] = wall_ms - outer_ms / iters
    return stage_ms, scopes, unmatched / iters


def profiled_ticks(tick, scen, iters: int, dev: torch.device,
                   warm_sqp: bool = False, unprofiled: int = 0):
    """Run the fleet tick ``tick`` on ``scen`` under ``torch.profiler``: one
    tick under the profiler's schedule before the ``iters`` it records (a
    session loses its first events), each tick ended by a device
    synchronise; device activity is traced on the card only.  ``unprofiled``
    ticks run first (2 more as warm-up); with ``warm_sqp`` every tick starts
    from the previous tick's SQP profiles.

    :returns: (the finished profiler, whose ``events()`` are the recorded
        ticks', the mean host ms of a recorded tick, the host ms of each
        unprofiled tick).
    """
    from torch.profiler import ProfilerActivity, profile

    over = {}

    def timed_tick():
        t0 = time.perf_counter()
        out = tick(scen, **over)
        _sync(dev)
        if warm_sqp:
            over["sqp_x0"] = out["vx_sqp"]
        return (time.perf_counter() - t0) * 1e3

    plain = [timed_tick() for _ in range(unprofiled + 2)][2:] \
        if unprofiled else []
    sched = torch.profiler.schedule(wait=0, warmup=1, active=iters,
                                    repeat=1)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    walls = []
    with profile(activities=activities, schedule=sched) as prof:
        for _ in range(iters + 1):
            walls.append(timed_tick())
            prof.step()
    return prof, float(np.mean(walls[1:])), plain


def top_in_range(events, iters: int, scope: str, top: int = 10):
    """The ``top`` most expensive device kernels that range ``scope``
    launched (each kernel to the innermost range around its launch call, as
    :func:`attribute`), by name, as dict(name, ms, launches) per run of
    ``iters``; empty for a trace without device activity (the CPU)."""
    agg = {}
    launch_of = _launch_calls(events)
    for e in device_kernels(events):
        if _owner(launch_of.get(e.id)) == scope:
            a = agg.setdefault(e.name, [0.0, 0])
            a[0] += (e.time_range.end - e.time_range.start) / 1e3
            a[1] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(name=name, ms=round(ms / iters, 4),
                 launches=round(n / iters, 2)) for name, (ms, n) in rows]


@torch.no_grad()
def stage_timings_trace(lat, scen, iters: int = 3, vp_backend: str = "fb",
                        device=None, **kw):
    """Per-stage attribution of the real fleet tick's device time from a
    ``torch.profiler`` trace (CPU and CUDA activities), as the JAX
    package's ``stage_timings_trace`` (and ``profile_sqp``'s attribution
    under ``vp_backend="sqp"``, which warm-starts every traced tick from
    the profiles of the tick before, as a running fleet does).

    One tick runs under the profiler before the ``iters`` ticks it
    records (its first events would be lost to the profiler's start), and
    every tick ends in a device synchronise.

    :param kw: further options of ``make_batched_tick`` (e.g. ``sqp_m``).
    :returns: dict(stage_ms, stage_share, total_ms, scopes, launches,
        unmatched_launches, tick_ms, profiled_tick_ms, method), every
        figure per tick (see :func:`attribute`; ``other``'s host_ms is the
        host time outside every range); ``tick_ms`` is the median host
        time of 10 unprofiled ticks, ``profiled_tick_ms`` the mean of the
        recorded ones.
        None on the CPU, where the profiler traces no device kernel, and
        when it sees none.
    """
    lat, scen, dev = _setup(lat, scen, device)
    if dev.type != "cuda":
        return None
    tick = sc.make_batched_tick(lat, device=dev, vp_backend=vp_backend,
                                **kw)
    prof, wall_ms, plain = profiled_ticks(tick, scen, iters, dev,
                                          warm_sqp=vp_backend == "sqp",
                                          unprofiled=10)
    stage_ms, scopes, unmatched = attribute(prof.events(), iters, wall_ms)
    total = sum(stage_ms.values())
    if total <= 0:
        return None
    for st in (SQP_STAGES if vp_backend == "sqp" else FB_STAGES):
        stage_ms.setdefault(st, 0.0)
    return dict(
        stage_ms={k: round(v, 4) for k, v in stage_ms.items()},
        stage_share={k: round(v / total, 4) for k, v in stage_ms.items()},
        total_ms=round(total, 4),
        scopes={k: {m: round(v, 4) for m, v in s.items()}
                for k, s in sorted(scopes.items())},
        launches=round(sum(s["launches"] for s in scopes.values()), 2),
        unmatched_launches=round(unmatched, 2),
        tick_ms=round(float(np.median(plain)), 3),
        profiled_tick_ms=round(wall_ms, 3),
        method="torch.profiler: device kernels by launching gltpl range")
