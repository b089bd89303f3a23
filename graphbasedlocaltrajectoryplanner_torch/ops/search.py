"""Layer-wise min-plus DP search (torch) — counterpart of the JAX package's
``ops/search.py``.

Every lattice edge goes from layer l to layer l+1 (mod L), so the optimal
path from a start node to every node of every window layer is one sweep of

    best[h+1, m] = min_n best[h, n] + W[h, n, m]

with argmin backpointers (ties to the lowest n).  Infeasibility is a large
finite cost (``INF``) so arithmetic stays NaN-free.
"""

from __future__ import annotations

import torch

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
    start = torch.as_tensor(start_node, device=dev).long().reshape(lead)
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
    h_eff = torch.as_tensor(h_eff, device=dev).long()
    goal = torch.as_tensor(goal_node, device=dev).long()
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
