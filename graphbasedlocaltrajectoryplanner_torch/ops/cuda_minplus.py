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
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch


def minplus_scan_plain(w_window, start_node):
    """Plain version: ``ops.search.minplus_scan``."""
    return srch.minplus_scan(w_window, start_node)


def start_arg(start, lead):
    """``(tensor, ks)``: the start nodes as the kernel reads them, one entry
    per ``ks`` consecutive rows.  A start broadcast over the trailing
    leading dimensions (``s[:, None].expand(B, 4)``) is read where it lies,
    without a copy; the rest of it must be contiguous or is made so."""
    R = math.prod(lead)
    start = start.reshape(lead) if start.numel() == R else start.expand(lead)
    ks = 1
    while start.dim() and start.shape[-1] and start.stride(-1) == 0:
        ks *= start.shape[-1]
        start = start[..., 0]
    return start.reshape(-1), ks


def kernel_args(w_window, start_node):
    """``(c_args, best, bp, keep)``: the checked arguments of the kernel's
    C entry point (all but the stream), the two outputs it fills (shaped as
    the kernel's rows), and the inputs that must live until the launch is
    enqueued."""
    *lead, H, N, _ = w_window.shape
    R = math.prod(lead)
    w = w_window.reshape(R, H, N, N).contiguous()
    cb.require(w, torch.float32, (R, H, N, N), "w_window")
    start, ks = start_arg(cuda_graph.as_tensor(start_node, device=w.device),
                          lead)
    start, wide = cb.index_tensor(start, (R // ks,), "start_node")
    best = torch.empty((R, H + 1, N), dtype=torch.float32, device=w.device)
    bp = torch.empty((R, H + 1, N), dtype=torch.int32, device=w.device)
    c_args = (cb.ptr(w), cb.ptr(start), cb.ptr(best), cb.ptr(bp), R, H, N,
              ks, wide)
    return c_args, best, bp, (w, start)


def minplus_scan(w_window, start_node):
    """Min-plus DP per row: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  ``start_node`` goes to the kernel as it is,
    int32 or int64."""
    if w_window.device.type == "cpu":
        return minplus_scan_plain(w_window, start_node)
    *lead, H, N, _ = w_window.shape
    c_args, best, bp, _keep = kernel_args(w_window, start_node)
    cb.check(cb.load("minplus")(*c_args, cb.stream()), "minplus")
    minplus_scan.launches += 1
    return (best.reshape(*lead, H + 1, N), bp.reshape(*lead, H + 1, N))


minplus_scan.launches = 0
