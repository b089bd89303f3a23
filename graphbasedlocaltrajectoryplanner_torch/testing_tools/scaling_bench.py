"""Scaling bench of the sharded fleet tick: replans/s over N ranks.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.scaling_bench \\
        [--ranks 4] [--backend nccl|gloo] [--cpu] [--batch-per-rank 8] \\
        [--iters 2] [--out artifacts/SCALING_TORCH.json]

The port's counterpart of the root ``scaling_bench.py --multihost``: starts
``--ranks`` fresh interpreters (``distributed.launch_ranks``), each runs
``distributed.run_multihost_selftest`` (the quick oval lattice,
``make_sharded_tick`` over ``make_dist_mesh``, ``--batch-per-rank``
scenarios a rank; on the card the compiled tick, one CUDA graph per
signature holding its collectives under NCCL and captured stages with the
collectives between them under gloo, ``tick_form`` in the line), checks
that every rank agrees on the fleet statistics (they come out of
collectives), prints one JSON line and writes it to ``--out``.  The
default backend is NCCL on the cards (one rank a card) and gloo with
``--cpu``; ``--backend gloo`` on the card lets several ranks share one
card.

On one card, or on one CPU, the ranks share one device: the numbers then
measure the machinery (process groups, collectives, the ranks' contention
for the device), not scaling.
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _rank(args):
    import torch
    from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
    if args.cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
    distributed.init_distributed(backend=args.backend,
                                 device="cpu" if args.cpu else None)
    rep = distributed.run_multihost_selftest(
        batch_per_device=args.batch_per_rank, iters=args.iters)
    import torch.distributed as dist
    rep["backend"] = dist.get_backend()
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(rep))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch-per-rank", type=int, default=8)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts",
                                                  "SCALING_TORCH.json"))
    ap.add_argument("--rank-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return _rank(args)
    from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
    argv_w = ["-m", "graphbasedlocaltrajectoryplanner_torch.testing_tools."
              "scaling_bench", "--rank-worker", "--ranks", str(args.ranks),
              "--batch-per-rank", str(args.batch_per_rank),
              "--iters", str(args.iters)]
    if args.cpu:
        argv_w.append("--cpu")
    if args.backend:
        argv_w += ["--backend", args.backend]
    outs = distributed.launch_ranks(argv_w, args.ranks, args.timeout,
                                    cwd=ROOT)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for key in ("fleet_actions", "fleet_min_cost", "batch"):
        if len({r[key] for r in reports}) != 1:
            raise SystemExit(f"ranks disagree on {key}: "
                             f"{[r[key] for r in reports]}")
    r0 = reports[0]
    devices = [r["device"] for r in reports]
    shared = len(set(devices)) < len(devices)
    line = dict(
        metric="sharded_tick_replans_per_sec", ranks=args.ranks,
        backend=r0["backend"], devices=devices, batch=r0["batch"],
        replans_per_sec=sum(r["replans_per_sec"] for r in reports)
        / len(reports),
        tick_ms=max(r["tick_ms"] for r in reports),
        collective_share=max(r["collective_share"] for r in reports),
        collective_share_how=r0["collective_share_how"],
        tick_form=r0["tick_form"],
        fleet_actions=r0["fleet_actions"],
        fleet_min_cost=r0["fleet_min_cost"], ranks_agree=True,
        note=("ranks share a device: this measures the machinery, not "
              "scaling" if shared else "one device a rank"),
        reports=reports)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(line, fh, indent=1)
    print(json.dumps({k: v for k, v in line.items() if k != "reports"}))


if __name__ == "__main__":
    main()
