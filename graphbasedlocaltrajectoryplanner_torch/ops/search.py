"""Layer-wise min-plus DP search (torch) — counterpart of the JAX package's
``ops/search.py``.

Every lattice edge goes from layer l to layer l+1 (mod L), so the optimal
path from a start node to every node of every window layer is one sweep of

    best[h+1, m] = min_n best[h, n] + W[h, n, m]

with argmin backpointers (ties to the lowest n).  Infeasibility is a large
finite cost (``INF``) so arithmetic stays NaN-free.  On the card the sweep
is the kernel of ``ops/cuda_minplus.py`` and the walk that of
``ops/cuda_backtrace.py`` (:func:`search_window`).
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph

INF = 1e30
# costs at or above this threshold mean "unreachable"
FEAS_THRESH = 1e29


def minplus_scan(w_window: torch.Tensor, start_node):
    """Min-plus DP from ``start_node`` over a materialized window.

    :param w_window:   (..., H, N, N) edge costs (>= INF if absent).
    :param start_node: (...,) int start node in window-layer 0.
    :returns: (best (..., H+1, N), bp (..., H+1, N) int32, bp[..., 0, :] = -1).
    """
    *lead, H, N, _ = w_window.shape
    dev = w_window.device
    start = cuda_graph.as_tensor(start_node, device=dev).long().reshape(lead)
    best = torch.full(tuple(lead) + (N,), INF, dtype=w_window.dtype,
                      device=dev)
    best.scatter_(-1, start[..., None], 0.0)
    bests = [best]
    bps = [torch.full(tuple(lead) + (N,), -1, dtype=torch.int32, device=dev)]
    for h in range(H):
        tot = best[..., :, None] + w_window[..., h, :, :]
        best = torch.clamp(torch.amin(tot, dim=-2), max=INF)
        bests.append(best)
        bps.append(torch.argmin(tot, dim=-2).to(torch.int32))
    return torch.stack(bests, dim=-2), torch.stack(bps, dim=-2)


def backtrace(bp: torch.Tensor, h_eff, goal_node):
    """Node chains from backpointers, one per row.

    :param bp:        (R, H+1, N) backpointers.
    :param h_eff:     (R,) effective horizon per row.
    :param goal_node: (R,) node index at window-layer ``h_eff``.
    :returns: nodes (R, H+1) int32 — node per window layer for h <= h_eff,
              -1 beyond.
    """
    R, Hp1, N = bp.shape
    dev = bp.device
    h_eff = cuda_graph.as_tensor(h_eff, device=dev).long()
    goal = cuda_graph.as_tensor(goal_node, device=dev).long()
    rows = torch.arange(R, device=dev)
    carry = goal
    out = [None] * Hp1
    for h in range(Hp1 - 1, -1, -1):
        walked = bp[rows, min(h + 1, Hp1 - 1), carry.clamp(min=0)].long()
        node = torch.where(h > h_eff, torch.full_like(goal, -1),
                           torch.where(h == h_eff, goal, walked))
        carry = torch.where(h <= h_eff, node, carry)
        out[h] = node
    return torch.stack(out, dim=1).to(torch.int32)


def select_goal(best: torch.Tensor, vg_cost: torch.Tensor, h_goal,
                shrink_horizon):
    """Goal layer and node per row, with the optional horizon shrink.

    :param best: (..., H+1, N) DP frontiers; ``vg_cost`` the same shape
        (>= INF for invalid nodes).
    :param h_goal: (...,) requested horizon (1..H).
    :param shrink_horizon: (...,) bool — fall back to the largest feasible
        h <= h_goal (straight/follow) or take h_goal only (left/right).
    :returns: (h_eff, goal_node, cost, feasible), each (...,); ``h_eff`` is
        0 and ``feasible`` False where no horizon works.
    """
    *lead, Hp1, N = best.shape
    dev = best.device
    goal_tot = best + vg_cost
    layer_min = torch.amin(goal_tot, dim=-1)                     # (..., H+1)
    hs = torch.arange(Hp1, device=dev)
    h_goal = cuda_graph.as_tensor(h_goal, device=dev).long().expand(lead)
    shrink = cuda_graph.as_tensor(shrink_horizon, device=dev).expand(lead)
    feas = (layer_min < FEAS_THRESH) & (hs >= 1) & (hs <= h_goal[..., None])
    h_shrunk = torch.amax(torch.where(feas, hs, 0), dim=-1)
    at_goal = torch.gather(feas, -1, h_goal.clamp(0, Hp1 - 1)[..., None])
    h_exact = torch.where(at_goal[..., 0], h_goal, 0)
    h_eff = torch.where(shrink, h_shrunk, h_exact)
    row = torch.gather(goal_tot, -2,
                       h_eff[..., None, None].expand(*lead, 1, N))[..., 0, :]
    goal_node = torch.argmin(row, dim=-1)
    cost = torch.gather(row, -1, goal_node[..., None])[..., 0]
    return (h_eff.to(torch.int32), goal_node.to(torch.int32), cost,
            h_eff >= 1)


def search_window(w_window, start_node, vg_cost, h_goal, shrink_horizon,
                  kernels: bool = True):
    """DP, goal selection and backtrace per row over materialized windows
    ``w_window`` (..., H, N, N).  With ``kernels`` the sweep and the walk go
    through the CUDA kernels' wrappers (their plain versions on CPU
    tensors); ``kernels=False`` takes the plain versions on any device.

    :returns: dict(nodes (..., H+1) int32, h_eff, goal_node, cost,
        feasible), the start node at h = 0 of feasible rows, -1 otherwise.
    """
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_backtrace, cuda_minplus)
    scan = (cuda_minplus.minplus_scan if kernels
            else cuda_minplus.minplus_scan_plain)
    walk = (cuda_backtrace.backtrace_walk if kernels
            else cuda_backtrace.backtrace_walk_plain)
    *lead, H, N, _ = w_window.shape
    dev = w_window.device
    start = cuda_graph.as_tensor(start_node, device=dev).long().expand(lead)
    best, bp = scan(w_window, start)
    h_eff, goal_node, cost, feasible = select_goal(best, vg_cost, h_goal,
                                                   shrink_horizon)
    nodes = walk(bp.reshape(-1, H + 1, N), goal_node.reshape(-1),
                 h_eff.reshape(-1)).reshape(*lead, H + 1)
    nodes[..., 0] = torch.where(feasible, start, -1).to(nodes.dtype)
    return dict(nodes=nodes, h_eff=h_eff, goal_node=goal_node, cost=cost,
                feasible=feasible)


def dijkstra_window_np(w_window, start_node, vg_cost, h_goal):
    """Plain-Python Dijkstra over one layered window graph ``w_window``
    (H, N, N) with the virtual goal node at layer ``h_goal`` — the golden
    of :func:`search_window` (igraph ``get_shortest_paths`` with the
    virtual-goal construction).  Returns (nodes list, cost), or (None,
    None) when no goal is reachable."""
    import heapq

    import numpy as np

    H, N, _ = w_window.shape
    INF_ = float(np.inf)
    dist = {(0, start_node): 0.0}
    prev = {}
    pq = [(0.0, (0, start_node))]
    while pq:
        d, (h, n) = heapq.heappop(pq)
        if d > dist.get((h, n), INF_):
            continue
        if h < h_goal:
            for m in range(N):
                w = float(w_window[h, n, m])
                if w >= FEAS_THRESH:
                    continue
                nd = d + w
                if nd < dist.get((h + 1, m), INF_):
                    dist[(h + 1, m)] = nd
                    prev[(h + 1, m)] = n
                    heapq.heappush(pq, (nd, (h + 1, m)))
    best_n, best_c = -1, INF_
    for n in range(N):
        c = dist.get((h_goal, n), INF_) + float(vg_cost[h_goal, n])
        if c < best_c:
            best_c, best_n = c, n
    if best_n < 0 or best_c >= FEAS_THRESH:
        return None, None
    nodes = [best_n]
    for h in range(h_goal, 0, -1):
        nodes.append(prev[(h, nodes[-1])])
    return list(reversed(nodes)), best_c
