"""Device ms of named ranges at any depth of the program's traced compiled
tick (``ops/cuda_graph``: ``tracing()``, ``tick.report()``), for the
per-layer metrics that read spans nested in a stage (``sqp.graph_qp_ms``,
``sqp.graph_seam_ms``).

``benchmark/program_trace.py`` keeps a replay's outermost ranges only
(its stages).  This module makes the same stage pass and keeps every
range: once per run, at the first call of one of its readers, it sets
the cell up again from the run's own ``--workload`` and ``--seed`` (the
same configuration, traffic and batches), warms the untraced signature
and, with the program's tracing on, captures the traced one, then runs
``trace_ticks`` compiled ticks, each followed by a synchronise and
``tick.report()``.  A range's reading in one tick is its inclusive ms
summed over its occurrences; a metric sums its ranges and takes the
median over the ticks.  A range that the program does not open gives no
reading (None, never 0), so a program older than its spans reads nothing
for that metric.  The pass prints what it cost (set-up and ticks) on
standard error.
"""

from __future__ import annotations

import statistics
import sys
import time

from benchmark import program_trace, trace

KEY = "range_trace"


def measure(workload: str, seed: int) -> dict:
    """The pass on the cell ``workload`` set up from ``seed``: each traced
    tick's ``{range name: ms}``."""
    import torch

    from benchmark import core, fleet
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    t0 = time.perf_counter()
    man = core.manifest()
    cell = core.cell(man, workload)
    cfg = core.config(man, cell["config"])
    mix = core.traffic(cell["traffic"])
    dev = torch.device("cuda")
    f = fleet.setup(cfg, mix, seed, dev)
    tick, batches = f.tick, f.batches
    fleet.warm(tick, batches, dev)
    t_setup = time.perf_counter() - t0
    ticks = []
    with cuda_graph.tracing():
        fleet.warm(tick, batches, dev)
        for i in range(mix["trace_ticks"]):
            tick(batches[i % len(batches)])
            trace.sync()
            rep = program_trace._traced_report(tick)
            ticks.append({k: r["ms"] for k, r in rep["ranges"].items()})
    secs = time.perf_counter() - t0
    med = {k: statistics.median(t.get(k, 0.0) for t in ticks)
           for k in sorted(set().union(*ticks))}
    print(f"range trace: set-up {t_setup:.2f} s, the pass in all {secs:.2f} "
          f"s ({len(ticks)} traced ticks); medians (device ms) "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
          file=sys.stderr, flush=True)
    del f, tick, batches
    return dict(ticks=ticks, seconds=secs)


def readings(ctx) -> dict | None:
    """The pass's ticks for the trace run ``ctx``, measured at the first
    call and kept in ``ctx``; None where there is nothing to read (not a
    fleet run, not a run of ``benchmark.run``, a program without
    tracing)."""
    if not isinstance(ctx, dict) or ctx.get("kind") != "fleet":
        return None
    if KEY not in ctx:
        args = program_trace._run_args()
        ctx[KEY] = (measure(args.workload, args.seed)
                    if args is not None and program_trace.available()
                    else None)
    return ctx[KEY]


def ranges_ms(ctx, names) -> float | None:
    """Median over the pass's ticks of the summed ms of ranges ``names``;
    None where a tick lacks one of them."""
    r = readings(ctx)
    if r is None or not r["ticks"]:
        return None
    if any(k not in t for t in r["ticks"] for k in names):
        return None
    return statistics.median(sum(t[k] for k in names) for t in r["ticks"])
