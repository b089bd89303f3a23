"""Log replay and validation (torch) — counterpart of the JAX package's
``utils/replay.py``, the reference viewer's RECALC_VALIDATION
(visualize_graph_log.py:60, 209-234): re-run the online search from a
logged lap and diff its node chains against the logged ones.

A lap driven by the planner is logged to ``*_data.csv``;
:func:`replay_validate` re-runs the path search of every tick against the
archived lattice and reports
  * edge consistency — every logged consecutive node pair is a valid edge,
  * optimality — on object-free ticks the recomputed window-DP optimum
    matches the logged straight chain (modulo the warm-start hold that the
    ``w_last_edges`` discount explains).

A re-planned tick runs the window DP and the walk at batch 1 through
``pathgen.plan_window_kernel`` and ``pathgen.backtrace_slot``: on the card
``csrc/window_dp.cu``, ``csrc/hit_slab.cu`` and ``csrc/backtrace.cu``,
their plain versions with ``kernels=False`` or on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.models.lattice import Lattice
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.utils.logging import (
    read_data_log)


@dataclasses.dataclass
class ReplayReport:
    ticks: int = 0
    actions_checked: int = 0
    edge_violations: int = 0
    node_mismatches: int = 0        # informational: held-path divergences
    node_mismatch_failures: int = 0  # mismatches w_last discounting cannot
    #                                  explain by cost accounting -> gate
    details: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.edge_violations == 0 \
            and self.node_mismatch_failures == 0


def replay_validate(data_csv: str, lat: Lattice,
                    check_optimality: bool = True,
                    w_last_edges=(0.0, 0.5, 0.8),
                    cost_tol: float = 1e-3, device=None,
                    kernels: bool = True) -> ReplayReport:
    """Validate a logged lap on ``lat`` (moved to ``device``, default the
    card).  A recomputed-optimum mismatch fails the run unless the
    ``w_last_edges`` discount accounts for it: the logged chain's
    undiscounted cost may exceed the fresh optimum by at most the discount
    on its first ``len(w_last_edges)`` edges,

        cost(logged) - cost(optimal) <= sum_i w_edge_i * (1 - fac_i) + tol;

    beyond that it counts as ``node_mismatch_failures`` (``ok`` turns
    False)."""
    from graphbasedlocaltrajectoryplanner_torch import resolve_device
    dev = resolve_device(device)
    if lat.device != dev:
        lat = lat.to(dev)
    rep = ReplayReport()
    for row in read_data_log(data_csv):
        rep.ticks += 1
        validate_row(lat, row, rep, check_optimality=check_optimality,
                     w_last_edges=w_last_edges, cost_tol=cost_tol,
                     kernels=kernels)
    return rep


def validate_row(lat: Lattice, row: dict, rep: ReplayReport = None,
                 check_optimality: bool = True,
                 w_last_edges=(0.0, 0.5, 0.8),
                 cost_tol: float = 1e-3,
                 kernels: bool = True) -> ReplayReport:
    """Validate one logged tick on ``lat`` (on its device), accumulating
    into ``rep`` when given, else into a fresh single-tick report."""
    if rep is None:
        rep = ReplayReport(ticks=1)
    ev = lat.edge_valid.cpu().numpy()
    L = lat.L
    nodes_list = row.get("nodes_list") or {}
    start_node = row.get("start_node")
    obj_veh_raw = row.get("obj_veh") or []

    for action, chains in nodes_list.items():
        for chain in chains:
            # drop virtual/None prefix entries (initial pose spline)
            chain = [c for c in chain if c[0] is not None]
            if len(chain) < 2:
                continue
            rep.actions_checked += 1
            # 1) edge consistency in the archived lattice
            bad = 0
            for a, b in zip(chain[:-1], chain[1:]):
                la, na = int(a[0]), int(a[1])
                lb, nb = int(b[0]), int(b[1])
                if (la + 1) % L != lb or not ev[la, na, nb]:
                    bad += 1
            if bad:
                rep.edge_violations += bad
                rep.details.append(
                    dict(tick=rep.ticks, action=action,
                         kind="invalid_edge", count=bad))

    # 2) optimality re-check for the straight action on object-free ticks
    if not (check_optimality and start_node is not None
            and not obj_veh_raw and nodes_list.get("straight")):
        return rep
    chain = [c for c in nodes_list["straight"][0] if c[0] is not None]
    if len(chain) < 3:
        return rep
    # the search started at start_node: compare the suffix
    try:
        k = chain.index([int(start_node[0]), int(start_node[1])])
    except ValueError:
        return rep
    suffix = chain[k:]
    h_eff = len(suffix) - 1
    if h_eff < 1 or h_eff > lat.H_max:
        return rep
    dev = lat.device

    def ints(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    out = pg.plan_window_kernel(
        lat, ints(start_node[0]), ints(start_node[1]),
        torch.zeros((L, lat.N), dtype=torch.bool, device=dev),
        torch.zeros((1, 4, 2), dtype=torch.float32, device=dev),
        torch.zeros((1, 4), dtype=torch.float32, device=dev),
        torch.zeros((1, 4), dtype=torch.bool, device=dev), ints(0), ints(0),
        torch.zeros((1,), dtype=torch.bool, device=dev),
        torch.full((1, 2), -1, dtype=torch.int32, device=dev),
        torch.ones((1,), dtype=torch.float32, device=dev), kernels=kernels)
    nodes, cost_opt = pg.backtrace_slot(
        out["best"], out["bp"], out["vg"], ints(h_eff), kernels=kernels,
        slot=ints(pg.SLOT_STRAIGHT),
        slot_range=(pg.SLOT_STRAIGHT, pg.SLOT_STRAIGHT))
    nodes = nodes[0, :h_eff + 1].cpu().numpy()
    logged = np.array([c[1] for c in suffix])
    mism = int(np.sum(nodes != logged))
    if mism:
        rep.node_mismatches += mism
        # cost accounting: is the divergence explainable as a
        # w_last_edges warm-start hold?
        vg = out["vg"][0, pg.SLOT_STRAIGHT].cpu().numpy()
        w_np = lat.w.cpu().numpy()
        layers = [(int(start_node[0]) + i) % L for i in range(h_eff + 1)]
        edge_w = [float(w_np[layers[i], int(suffix[i][1]),
                             int(suffix[i + 1][1])]) for i in range(h_eff)]
        cost_logged = float(np.sum(edge_w)) \
            + float(vg[h_eff, int(suffix[-1][1])])
        explained = sum(edge_w[i] * (1.0 - w_last_edges[i])
                        for i in range(min(len(w_last_edges), h_eff)))
        excess = cost_logged - float(cost_opt[0])
        hard = excess > explained + cost_tol
        if hard:
            rep.node_mismatch_failures += 1
        rep.details.append(dict(
            tick=rep.ticks, action="straight", kind="node_mismatch",
            count=mism, excess_cost=excess, w_last_explainable=explained,
            gate_failure=hard))
    return rep
