"""Batched min-plus DP over a materialized window: the CUDA kernel
``csrc/minplus.cu`` and its plain PyTorch version (counterpart of the JAX
package's ``ops/pallas_minplus.py``).

``w`` (..., H, N, N) float32 edge costs (>= INF where absent), ``start``
(...,) start nodes -> ``best`` (..., H+1, N) float32 and ``bp``
(..., H+1, N) int32, row h = 0 one-hot at the start node with
backpointers -1; the leading dimensions are flattened into kernel rows.
"""

from __future__ import annotations

import math

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch


def minplus_scan_plain(w_window, start_node):
    """Plain version: ``ops.search.minplus_scan``."""
    return srch.minplus_scan(w_window, start_node)


def minplus_scan(w_window, start_node):
    """Min-plus DP per row: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if w_window.device.type == "cpu":
        return minplus_scan_plain(w_window, start_node)
    *lead, H, N, _ = w_window.shape
    R = math.prod(lead)
    w = w_window.reshape(R, H, N, N).contiguous()
    start = torch.as_tensor(start_node, device=w.device).to(
        torch.int32).reshape(R).contiguous()
    cb.require(w, torch.float32, (R, H, N, N), "w_window")
    cb.require(start, torch.int32, (R,), "start_node")
    best = torch.empty((R, H + 1, N), dtype=torch.float32, device=w.device)
    bp = torch.empty((R, H + 1, N), dtype=torch.int32, device=w.device)
    rc = cb.load("minplus")(cb.ptr(w), cb.ptr(start), cb.ptr(best),
                            cb.ptr(bp), R, H, N, cb.stream())
    cb.check(rc, "minplus")
    minplus_scan.launches += 1
    return (best.reshape(*lead, H + 1, N), bp.reshape(*lead, H + 1, N))


minplus_scan.launches = 0
