"""Readings from the program's own spans and counters on its compiled-call
path (``ops/cuda_graph``: ``tracing()``, ``tick.report()``, the
``gltpl.call.*`` host spans and the graph's node counters), for the
per-layer metrics ``fleet.graph_*``, ``fleet.replay_host_ms`` and
``fleet.call_idle_pct``.

The readers get only the trace run's context, which the harness builds
before it frees the cell's tick.  So, once per run, after the check,
:func:`readings` sets the cell up again from the run's own arguments
(``--workload``, ``--seed``: the same configuration, traffic and batches),
captures the untraced signature (its kernel nodes) and, with the
program's tracing on, the traced one, and runs two passes on it.  They
end within about two seconds of that capture: after a capture the card
runs every graph about 0.35 us a kernel node slower for 3-24 s (PERF.md
§7.3), so the passes read that state, the one in which the timed window
begins, and do not straddle the change:

(a) the stage pass: ``trace_ticks`` compiled ticks, each followed by a
    synchronise and ``tick.report()``; a stage is the outermost ranges
    that ``benchmark/trace.SCOPE_TO_STAGE`` puts in it, ``other`` the
    graph's device time outside every range; medians over the ticks;
(b) the host-span pass: the same window of ``trace_ticks`` compiled ticks
    as the trace run's, under ``torch.profiler``, no synchronise per
    tick: the host ms of ``gltpl.call.replay`` a tick, and the share of
    the window in which no device operation runs while the host is inside
    a ``gltpl.call.*`` span.

A program without ``cuda_graph.tracing`` (one older than these spans)
gives no reading, and nothing is set up.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

from benchmark import trace

KEY = "program_trace"
CALL = "gltpl.call."
STAGES = ("window", "assembly", "velocity")


def available() -> bool:
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    return hasattr(cuda_graph, "tracing")


def stage_ms(rep: dict) -> dict:
    """One traced replay's report by stage: each stage the device ms of
    the outermost ranges that ``SCOPE_TO_STAGE`` puts in it, ``other``
    the report's ``other_ms`` and ``graph`` its ``graph_ms``."""
    out = dict.fromkeys(STAGES, 0.0)
    for name, r in rep["ranges"].items():
        st = trace.SCOPE_TO_STAGE.get(name)
        if r["parent"] is None and st is not None:
            out[st] += r["ms"]
    out["other"] = rep["other_ms"]
    out["graph"] = rep["graph_ms"]
    return out


def stage_medians(reports: list) -> dict:
    """Median of each of :func:`stage_ms`' numbers over ``reports``."""
    rows = [stage_ms(r) for r in reports]
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def _clip(merged, lo, hi):
    """The parts of sorted disjoint intervals ``merged`` inside
    ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in merged
            if min(b, hi) > max(a, lo)]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _gaps(merged, lo, hi):
    """The complement of sorted disjoint ``merged`` in ``[lo, hi]``."""
    out, cur = [], lo
    for a, b in _clip(merged, lo, hi):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def _intersect(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def call_reading(events) -> dict:
    """Pass (b)'s numbers from a trace holding ``bench.window`` spans:
    the window's seconds, its idle share (%) split into the part in which
    the host is inside a ``gltpl.call.*`` span and the rest, and the
    median host ms of ``gltpl.call.replay`` spans in the window."""
    wins = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == trace.WINDOW and not trace._is_device(e))
    if not wins:
        raise RuntimeError("the trace holds no bench.window span")
    busy = trace._union((e.time_range.start, e.time_range.end)
                        for e in trace.device_ops(events))
    host = [e for e in events
            if e.name.startswith(CALL) and not trace._is_device(e)]
    calls = trace._union((e.time_range.start, e.time_range.end)
                         for e in host)
    window = idle = call_idle = 0.0
    replay = []
    for w0, w1 in wins:
        gaps = _gaps(busy, w0, w1)
        window += w1 - w0
        idle += _length(gaps)
        call_idle += _length(_intersect(gaps, _clip(calls, w0, w1)))
        replay += [(e.time_range.end - e.time_range.start) / 1e3
                   for e in host if e.name == CALL + "replay"
                   and w0 <= e.time_range.start and e.time_range.end <= w1]
    return dict(window_s=window / 1e6, idle_pct=100.0 * idle / window,
                call_idle_pct=100.0 * call_idle / window,
                other_idle_pct=100.0 * (idle - call_idle) / window,
                replay_host_ms=(statistics.median(replay) if replay
                                else None),
                replays=len(replay))


def _run_args():
    """The run's ``--workload`` and ``--seed`` from its command line, or
    None outside a run of ``benchmark.run``."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    try:
        args, _ = ap.parse_known_args(sys.argv[1:])
    except SystemExit:
        return None
    if args.workload is None or args.seed is None:
        return None
    return args


def _traced_report(tick) -> dict:
    return [g for g in tick.report()["graphs"] if g["traced"]][-1]


def measure(workload: str, seed: int) -> dict:
    """Both passes on the cell ``workload`` set up from ``seed`` (see the
    module docstring); prints what it read on standard error."""
    import torch

    from benchmark import core, fleet
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    man = core.manifest()
    cell = core.cell(man, workload)
    cfg = core.config(man, cell["config"])
    mix = core.traffic(cell["traffic"])
    dev = torch.device("cuda")
    f = fleet.setup(cfg, mix, seed, dev)
    tick, batches, iters = f.tick, f.batches, mix["trace_ticks"]
    fleet.warm(tick, batches, dev)
    nodes = tick.report()["graphs"][0]
    with cuda_graph.tracing():
        fleet.warm(tick, batches, dev)
        t_cap = time.perf_counter()
        reports = []
        for i in range(iters):
            tick(batches[i % len(batches)])
            trace.sync()
            reports.append(_traced_report(tick))
        on_ms = fleet.device_ms(tick, batches)
        for b in batches[:2]:
            tick(b)
        trace.sync()
        with trace.traced() as prof:
            with trace.window_span():
                for i in range(iters):
                    tick(batches[i % len(batches)])
                trace.sync()
        passes_s = time.perf_counter() - t_cap
    ev = prof.events()
    trace.require_device_time(ev)
    stages = stage_medians(reports)
    calls = call_reading(ev)
    off_ms = fleet.device_ms(tick, batches)
    counts = tick.report()
    last = reports[-1]["ranges"]
    print(f"program trace: untraced graph nodes {nodes['nodes']}, capture "
          f"{nodes['capture_ms']:.1f} ms, pool {nodes['pool_bytes']}; "
          f"traced graph nodes {reports[-1]['nodes']}; captures "
          f"{counts['captures']}, replays {counts['replays']}, eager calls "
          f"{counts['eager_calls']}; device ms a tick (quartiles) traced "
          f"{on_ms}, then untraced {off_ms}; both passes ended {passes_s:.2f} "
          "s after the traced capture's warm-up", file=sys.stderr)
    print("program trace: stage pass medians (device ms) " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + "; sum of stages "
        f"and other {sum(stages[k] for k in STAGES + ('other',)):.4f}; "
        "last replay's ranges " + ", ".join(
            f"{k} {r['ms']:.4f} x{r['count']} in {r['parent']}"
            for k, r in last.items()), file=sys.stderr)
    print(f"program trace: host-span pass idle {calls['idle_pct']:.3f} % "
          f"= in gltpl.call.* spans {calls['call_idle_pct']:.3f} % + "
          f"outside {calls['other_idle_pct']:.3f} %; replay host ms "
          f"(median of {calls['replays']}) {calls['replay_host_ms']}",
          file=sys.stderr, flush=True)
    del f, tick, batches, prof, ev
    return dict(stages=stages, kernel_nodes=nodes["kernel_nodes"], **calls)


def readings(ctx) -> dict | None:
    """The passes' numbers for the trace run ``ctx``, measured at the
    first call and kept in ``ctx``; None where there is nothing to read
    (not a fleet run, not a run of ``benchmark.run``, a program without
    tracing)."""
    if not isinstance(ctx, dict) or ctx.get("kind") != "fleet":
        return None
    if KEY not in ctx:
        args = _run_args()
        ctx[KEY] = (measure(args.workload, args.seed)
                    if args is not None and available() else None)
    return ctx[KEY]


def stage(ctx, name: str):
    r = readings(ctx)
    return None if r is None else r["stages"][name]


def value(ctx, name: str):
    r = readings(ctx)
    return None if r is None else r[name]
