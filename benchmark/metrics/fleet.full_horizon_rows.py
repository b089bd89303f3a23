"""Rows a compiled fleet tick assembles at the full horizon (a chain of
``H_max`` segments, ``n_seg == H``): the program's counter
``full_horizon_rows``, which its assembly keeps under
``cuda_graph.tracing()`` and the traced graph's ``report()`` gives summed
over its replays.

Like ``benchmark/program_trace.py`` it sets the cell up again from the
run's ``--workload`` and ``--seed``, then runs ``trace_ticks`` traced
ticks, each followed by a synchronise and a report; the reading is the
median over those ticks of each tick's count (the difference of two
reports' totals).  None where there is nothing to read: not a fleet run,
not a run of ``benchmark.run``, or a program without the counter (never
0 for a program that does not count).
"""

import statistics
import sys

from benchmark import program_trace, trace

KEY = "full_horizon_rows"


def available() -> bool:
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    return hasattr(cuda_graph, "count")


def measure(workload: str, seed: int):
    """Each traced tick's count on the cell ``workload`` set up from
    ``seed``, their median (None where the report has no such counter)."""
    import torch

    from benchmark import core, fleet
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    man = core.manifest()
    cell = core.cell(man, workload)
    mix = core.traffic(cell["traffic"])
    dev = torch.device("cuda")
    f = fleet.setup(core.config(man, cell["config"]), mix, seed, dev)
    ticks = []
    with cuda_graph.tracing():
        fleet.warm(f.tick, f.batches, dev)
        last = program_trace._traced_report(f.tick).get(KEY)
        for i in range(mix["trace_ticks"] if last is not None else 0):
            f.tick(f.batches[i % len(f.batches)])
            trace.sync()
            total = program_trace._traced_report(f.tick)[KEY]
            ticks.append(total - last)
            last = total
    print(f"full-horizon rows a tick over {len(ticks)} traced ticks: "
          f"{ticks}", file=sys.stderr, flush=True)
    return statistics.median(ticks) if ticks else None


def read(ctx):
    if not isinstance(ctx, dict) or ctx.get("kind") != "fleet":
        return None
    if KEY not in ctx:
        args = program_trace._run_args()
        ctx[KEY] = (measure(args.workload, args.seed)
                    if args is not None and available() else None)
    return ctx[KEY]
