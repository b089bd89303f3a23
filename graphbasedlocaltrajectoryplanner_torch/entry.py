"""Entry points of the port: one fleet-tick step and a multi-device dry run
— the counterpart of the JAX package's ``__graft_entry__.py``.

    python -m graphbasedlocaltrajectoryplanner_torch.entry [--cpu]
    python -m graphbasedlocaltrajectoryplanner_torch.entry --dryrun N \\
        [--backend gloo|nccl] [--cpu]

:func:`entry` returns the batched fleet tick on a small oval lattice and
its example scenarios (B=8); :func:`dryrun_multidevice` runs the sharded
tick, the layer-sharded window DP and the composed ``(dp, mp)`` tick in
``n`` rank processes (``parallel.distributed.launch_ranks``).  Both run on
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models.lattice import (
    build_lattice)
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    make_oval_track)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.utils.config import (
    OfflineConfig)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
W_LAST_FACTORS = (0.0, 0.5, 0.8)
# seconds the dry run's ranks may take (each builds its lattice and runs
# three ticks; a rank still running then is killed and the run fails)
DRYRUN_TIMEOUT_S = 600.0


def small_lattice(device=None):
    """The small synthetic closed-track lattice (no file dependencies; L=45,
    N=24, H=20), built by the port's builder on ``device``."""
    dev = resolve_device(device)
    return build_lattice(make_oval_track(n=200, r=50.0, straight=150.0),
                         OfflineConfig(min_plan_horizon=200.0),
                         md5_params="graft").to(dev)


def _entry_on(lat, device=None, kernels: bool = True):
    """:func:`entry` around the lattice ``lat``; ``kernels=False`` builds
    the tick on the plain versions."""
    dev = resolve_device(device)
    lat = lat.to(dev)
    scen = sc.random_scenarios(lat, batch=BATCH, seed=0, n_objects=1,
                               device=dev)
    tick = sc.make_batched_tick(lat, kernels, device=dev)

    def fn(scen_batch):
        out = tick(scen_batch)
        return out["trajs"], out["valid"], out["cost"]

    return fn, (scen,)


def entry(device=None):
    """One forward step of the flagship path: a batched full action-set
    replan (slab hits, masked 4-slot window DP, backtrace, C2-refit
    assembly, velocity profiles) over a batch of 8 scenarios.

    :returns: ``(fn, example_args)``; ``fn(*example_args)`` returns
        ``(trajs, valid, cost)``.
    """
    return _entry_on(small_lattice(device), device)


def _goal_cost(tabs, kernels: bool) -> float:
    """The goal-layer cost of the best feasible slot of scenario 0's window
    DP tables, virtual-goal term included."""
    return min(float(pg.backtrace_slot(
        tabs["best"][:, s], tabs["bp"][:, s], tabs["vg"][:, s],
        tabs["h_goal"], kernels=kernels)[1][0]) for s in range(4))


def _dryrun_rank(n: int, backend=None, cpu: bool = False) -> dict:
    """One rank of :func:`dryrun_multidevice`: its three parts made by
    ``testing_tools.dist_cases`` (on the card each held against its plain
    run on the same inputs, and the two ticks compiled by
    ``make_sharded_tick`` held against their eager ticks), what the JAX
    dry run asserts checked, and its numbers with each part's report (its
    kernels' launches, counted on the eager ticks)."""
    import torch.distributed as dist
    from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        dist_cases as dc)

    if cpu:
        torch.set_num_threads(2)
    rank, world = distributed.init_distributed(
        backend=backend, device="cpu" if cpu else None)
    if world != n:
        raise RuntimeError(f"dry run for {n} ranks started in {world}")
    dev = distributed.local_device()
    lat = small_lattice(dev)
    rep = dict(rank=rank, backend=dist.get_backend(), device=str(dev))

    # the sharded tick, scenarios data-parallel over dp
    batch = max(n, 2 * n)
    rep["dp"] = dc.tick_case("dp", distributed.DistMesh((n,), ("dp",)), lat,
                             batch, 0, None, dev)
    assert rep["dp"]["batch"] == batch
    assert math.isfinite(rep["dp"]["stats"]["fleet_min_cost"])
    rep["fleet_min_cost"] = rep["dp"]["stats"]["fleet_min_cost"]
    rep["actions"] = int(rep["dp"]["stats"]["fleet_actions"])

    # the window DP of scenario 0 with its steps sharded over mp
    scen = sc.random_scenarios(lat, batch=batch, seed=0, n_objects=1,
                               device=dev)
    one = sc.Scenario(**{f.name: getattr(scen, f.name)[:1]
                         for f in dataclasses.fields(sc.Scenario)})
    tabs, rep["spatial"] = dc.spatial_run(
        "spatial", distributed.DistMesh((n,), ("mp",)), lat,
        dc.window_args(lat, one, W_LAST_FACTORS), dev)
    assert tabs["best"].shape[1] == 4
    rep["spatial_dp_goal_cost"] = _goal_cost(tabs, kernels=True)
    if dev.type == "cuda" and _goal_cost(tabs, kernels=False) != \
            rep["spatial_dp_goal_cost"]:
        raise AssertionError("spatial: goal cost differs kernels vs plain")
    assert rep["spatial_dp_goal_cost"] < 1e29, \
        "spatial DP found no feasible goal"

    # the composed (dp, mp) mesh: scenarios over dp, each window DP over mp
    rep["dp_mp_composed_min_cost"] = None
    if n >= 4 and n % 2 == 0:
        rep["dp_mp"] = dc.tick_case(
            "dp_mp", distributed.DistMesh((n // 2, 2), ("dp", "mp")), lat,
            n, 1, "mp", dev)
        assert rep["dp_mp"]["batch"] == n
        assert math.isfinite(rep["dp_mp"]["stats"]["fleet_min_cost"])
        rep["dp_mp_composed_min_cost"] = \
            rep["dp_mp"]["stats"]["fleet_min_cost"]
    dist.barrier()
    dist.destroy_process_group()
    return rep


KEYS = ("fleet_min_cost", "actions", "spatial_dp_goal_cost",
        "dp_mp_composed_min_cost")


def dryrun_multidevice(n: int, backend: str = None, *, device=None) -> dict:
    """The sharded planning step on ``n`` ranks, each a fresh process:
    the ``dp=n`` sharded tick over ``max(n, 2n)`` scenarios, the window DP
    of scenario 0 sharded over an ``mp=n`` axis, and for even ``n >= 4``
    the composed ``(dp=n/2, mp=2)`` tick over ``n`` scenarios.  A rank's
    failure raises with its standard error.

    :param backend: default NCCL when every rank has a card of its own,
        else gloo (the CPU, or ranks sharing a card).
    :param device: ``"cpu"`` runs the ranks on the CPU; default the card.
    :returns: dict(fleet_min_cost, actions, spatial_dp_goal_cost,
        dp_mp_composed_min_cost (None for odd ``n`` or ``n < 4``),
        reports (each rank's, with a report a part: ``dp``, ``spatial``
        and ``dp_mp``, each with its kernels' launches)); the four
        numbers are printed in one line.
    """
    from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
    cpu = resolve_device(device).type == "cpu"
    if backend is None:
        backend = "nccl" if not cpu and torch.cuda.device_count() >= n \
            else "gloo"
    argv = ["-m", "graphbasedlocaltrajectoryplanner_torch.entry",
            "--rank-of", str(n), "--backend", backend] + \
        (["--cpu"] if cpu else [])
    outs = distributed.launch_ranks(argv, n, DRYRUN_TIMEOUT_S, cwd=ROOT)
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for r in reports[1:]:
        if any(r[k] != reports[0][k] for k in KEYS):
            raise AssertionError(f"ranks disagree: {reports[0]} vs {r}")
    out = {k: reports[0][k] for k in KEYS}
    composed = out["dp_mp_composed_min_cost"]
    print(f"dryrun_multidevice({n}) on {backend}: ok — fleet_min_cost="
          f"{out['fleet_min_cost']:.2f}, actions={out['actions']}, "
          f"spatial_dp_goal_cost={out['spatial_dp_goal_cost']:.2f}"
          + (f", dp_mp_composed_min_cost={composed:.2f}"
             if composed is not None else ""), flush=True)
    return dict(out, reports=reports)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="the multi-device dry run on N ranks")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--rank-of", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.rank_of is not None:
        print(json.dumps(_dryrun_rank(args.rank_of, args.backend, args.cpu)))
    elif args.dryrun is not None:
        dryrun_multidevice(args.dryrun, args.backend, device=device)
    else:
        fn, ex = entry(device)
        trajs, valid, cost = fn(*ex)
        print(f"entry: trajs {tuple(trajs.shape)} on {trajs.device}, "
              f"{int(valid.sum())} valid actions, min cost "
              f"{float(torch.where(valid, cost, math.inf).min()):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
