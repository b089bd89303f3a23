"""Batched backpointer walk: the CUDA kernel ``csrc/backtrace.cu`` and its
plain PyTorch version (counterpart of the JAX package's
``ops/pallas_backtrace.py``).

``bp`` (R, H+1, N) int32 backpointers, ``goal_node``/``h_eff`` (R,) ->
nodes (R, H+1) int32.  With ``slot`` (R,), ``bp`` is the unselected
(R0, S, H+1, N) table of the window DP and row r walks
``bp[r // k, slot[r]]`` with k = R / R0: the caller copies no slot's table
out first.  A slot out of range raises on the host before any launch; a
caller that knows bounds of its slots passes them as ``slot_range`` and
spares the wrapper a read of the slots (a wait for the device).
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch


def slot_layout(bp, R: int, slot, slot_range=None):
    """``(k, S)`` of a walk over ``R`` rows: rows a table row and slots a
    table row (1, 1 without ``slot``).  Raises on a malformed table or an
    out-of-range slot.  The slots' bounds are ``slot_range`` ``(lo, hi)``
    where the caller gives them, else read from the slots (their minimum
    and maximum; inside a CUDA-graph capture no value can be read, so
    there ``slot_range`` is required)."""
    if slot is None:
        if bp.dim() != 3 or bp.shape[0] != R:
            raise ValueError(f"bp: expected ({R}, H+1, N), got "
                             f"{tuple(bp.shape)}")
        return 1, 1
    if bp.dim() != 4 or bp.shape[0] == 0 or R % bp.shape[0]:
        raise ValueError(f"bp: expected (R0, S, H+1, N) with R0 dividing "
                         f"{R}, got {tuple(bp.shape)}")
    if tuple(slot.shape) != (R,):
        raise ValueError(f"slot: expected shape ({R},), got "
                         f"{tuple(slot.shape)}")
    S = bp.shape[1]
    if R and slot_range is None:
        if slot.is_cuda and torch.cuda.is_current_stream_capturing():
            raise ValueError("slot: its values cannot be read inside a "
                             "CUDA-graph capture; pass slot_range")
        slot_range = torch.stack(torch.aminmax(slot)).tolist()
    if R:
        lo, hi = slot_range
        if lo < 0 or hi >= S:
            raise ValueError(f"slot: values in [{lo}, {hi}], expected "
                             f"0 .. {S - 1}")
    return R // bp.shape[0], S


def backtrace_walk_plain(bp, goal_node, h_eff, slot=None, slot_range=None):
    """Plain version: the rows' tables selected first (``slot``), then
    ``ops.search.backtrace`` over rows."""
    R = goal_node.shape[0]
    k, _ = slot_layout(bp, R, slot, slot_range)
    if slot is not None:
        rows = torch.arange(R, device=bp.device) // k
        bp = bp[rows, slot.long()]
    return srch.backtrace(bp, h_eff, goal_node)


def kernel_args(bp, goal_node, h_eff, slot=None, slot_range=None):
    """``(c_args, nodes, keep)``: the checked arguments of the kernel's C
    entry point (all but the stream), the output it fills, and the inputs
    that must live until the launch is enqueued."""
    R = goal_node.shape[0]
    k, S = slot_layout(bp, R, slot, slot_range)
    Hp1, N = bp.shape[-2:]
    bp = bp.contiguous()
    cb.require(bp, torch.int32, tuple(bp.shape), "bp")
    goal, w_goal = cb.index_tensor(goal_node, (R,), "goal_node")
    heff, w_heff = cb.index_tensor(h_eff, (R,), "h_eff")
    wide = w_goal | w_heff << 1
    slot_ptr = None
    if slot is not None:
        slot, w_slot = cb.index_tensor(slot, (R,), "slot")
        wide |= w_slot << 2
        slot_ptr = cb.ptr(slot)
    nodes = torch.empty((R, Hp1), dtype=torch.int32, device=bp.device)
    c_args = (cb.ptr(bp), cb.ptr(goal), cb.ptr(heff), slot_ptr,
              cb.ptr(nodes), R, Hp1, N, S, k, wide)
    return c_args, nodes, (bp, goal, heff, slot)


def backtrace_walk(bp, goal_node, h_eff, slot=None, slot_range=None):
    """Node chains per row: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  ``goal_node``, ``h_eff`` and ``slot`` go to
    the kernel as they are, int32 or int64."""
    if bp.device.type == "cpu":
        return backtrace_walk_plain(bp, goal_node, h_eff, slot, slot_range)
    c_args, nodes, _keep = kernel_args(bp, goal_node, h_eff, slot,
                                       slot_range)
    cb.check(cb.load("backtrace")(*c_args, cb.stream()), "backtrace")
    backtrace_walk.launches += 1
    return nodes


backtrace_walk.launches = 0
