"""Batched backpointer walk: the CUDA kernel ``csrc/backtrace.cu`` and its
plain PyTorch version (counterpart of the JAX package's
``ops/pallas_backtrace.py``)."""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch


def backtrace_walk_plain(bp, goal_node, h_eff):
    """Plain version: ``ops.search.backtrace`` over rows; ``bp``
    (R, H+1, N), ``goal_node``/``h_eff`` (R,) -> nodes (R, H+1) int32."""
    return srch.backtrace(bp, h_eff, goal_node)


def backtrace_walk(bp, goal_node, h_eff):
    """Node chains per row: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if bp.device.type == "cpu":
        return backtrace_walk_plain(bp, goal_node, h_eff)
    R, Hp1, N = bp.shape
    bp = bp.to(torch.int32).contiguous()
    goal = goal_node.to(torch.int32).contiguous()
    heff = h_eff.to(torch.int32).contiguous()
    cb.require(bp, torch.int32, (R, Hp1, N), "bp")
    cb.require(goal, torch.int32, (R,), "goal_node")
    cb.require(heff, torch.int32, (R,), "h_eff")
    nodes = torch.empty((R, Hp1), dtype=torch.int32, device=bp.device)
    rc = cb.load("backtrace")(cb.ptr(bp), cb.ptr(goal), cb.ptr(heff),
                              cb.ptr(nodes), R, Hp1, N, cb.stream())
    cb.check(rc, "backtrace")
    backtrace_walk.launches += 1
    return nodes


backtrace_walk.launches = 0
