"""Devtool: the assembly stage of the fb fleet tick split by range — the
port's counterpart of the root ``profile_assembly.py``.

    python -m \\
      graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_assembly \\
        [--batch 1024] [--iters 3] [--cpu] [--track oval|CSV] [--out artifacts]

Runs the tick cut after its assembly stage (``until="assembly"``: the
window, the decision tree, the walk, the C2-refit assembly and the const
splice) under ``torch.profiler`` (``parallel/profiling.profiled_ticks``)
and splits it by range (``parallel/profiling.attribute``): each device
kernel to the innermost ``gltpl.*`` range that launched it.  Reports the
device ms, host ms and launches a tick of ``gltpl.backtrace``,
``gltpl.assemble`` and ``gltpl.const_splice``, their sum (the assembly
stage), the rest of the cut tick, and the 10 most expensive device kernels
of ``gltpl.assemble`` by name with their launches (none on the CPU, where
no device is traced).  The split is per range and per launch, so it runs
the eager body of the cut tick (``tick.__wrapped__`` on the card, where the
tick is a CUDA graph whose replay shows neither).
Writes ``<out>/ASSEMBLY_PROFILE_torch.json``.  Runs on the card unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

from graphbasedlocaltrajectoryplanner_torch.testing_tools.profile_tick import (
    ROOT, setup)

ASSEMBLY = ("gltpl.backtrace", "gltpl.assemble", "gltpl.const_splice")


def split(lat, scen, dev, iters: int = 3) -> dict:
    """The assembly split of the ``until="assembly"`` tick (see the module
    docstring), figures per tick."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    tick = cuda_graph.eager(sc.make_batched_tick(lat, device=dev,
                                                 until="assembly"))
    tick(scen)
    prof, wall_ms, _ = profiling.profiled_ticks(tick, scen, iters, dev)
    events = prof.events()
    _, scopes, unmatched = profiling.attribute(events, iters, wall_ms)
    zero = dict(device_ms=0.0, host_ms=0.0, launches=0.0)

    def total(names):
        return {k: round(sum(scopes.get(n, zero)[k] for n in names), 4)
                for k in zero}
    rest = [n for n in scopes if n not in ASSEMBLY]
    asm = total(ASSEMBLY)
    # nested ranges hold their host time twice: the rest's host time is
    # what the (outermost) assembly ranges leave of the tick's
    rest_total = dict(total(rest),
                      host_ms=round(wall_ms - asm["host_ms"], 4))
    return dict(
        scopes={n: total([n]) for n in ASSEMBLY},
        assembly=asm,
        rest=rest_total,
        rest_ranges=sorted(rest),
        tick_ms=round(wall_ms, 3),
        unmatched_launches=round(unmatched, 2),
        assemble_top=profiling.top_in_range(events, iters, "gltpl.assemble"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--track", default="oval",
                    help="'oval' or a 12-column LTPL track CSV")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)

    lat, scen, dev, info = setup(args.track, args.batch, args.cpu)
    rep = dict(device=info, track=args.track, batch=args.batch,
               iters=args.iters, **split(lat, scen, dev, args.iters))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "ASSEMBLY_PROFILE_torch.json"),
              "w") as fh:
        json.dump(rep, fh, indent=1)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
