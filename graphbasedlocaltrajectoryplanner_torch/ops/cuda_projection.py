"""Arc-length projections of the fleet tick: the CUDA kernel
``csrc/projection.cu`` and its plain PyTorch version.  No Pallas
counterpart: the JAX package leaves ``get_s_coord`` to XLA.

:func:`get_s_coords` projects several sets of positions onto one polyline
in one launch, each set as ``ops/projection.get_s_coord`` projects it, bit
for bit (``s`` and both indices).  The polyline is 2-D, ``(n, 2)`` with
``s_array`` ``(n,)``, shared by every position of every set (the
raceline), or 3-D, ``(R, n, 2)`` with ``s_array`` ``(R, n)``, one a row
with one ``(R, 2)`` position of each set a row (the follow slot's spliced
path).  The kernel reads every argument through its strides: a polyline
that is two columns of a wider table (``glob_rl[:, 1:3]``, a path's
``[..., 0:2]``) and positions of any leading shape are passed as they are.

The plain version, :func:`get_s_coords_plain`, calls ``get_s_coord`` once a
set; on CPU tensors :func:`get_s_coords` is the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import projection as proj

# query sets a launch (csrc/projection.cu, MAX_SETS)
MAX_SETS = 3


def get_s_coords_plain(ref_line, positions, s_array, closed: bool = False):
    """Plain version (the specification of the kernel): ``get_s_coord``
    of each position set, ``((s, (idx_a, idx_b)), ...)``."""
    return tuple(proj.get_s_coord(ref_line, p, s_array, closed=closed)
                 for p in positions)


class ProjArgs(ctypes.Structure):
    """``proj::Args`` of ``csrc/projection.cu``, field for field."""
    _fields_ = [("line", ctypes.c_void_p), ("s", ctypes.c_void_p)] + [
        (name, ctypes.c_void_p * MAX_SETS)
        for name in ("pos", "s_out", "idx_a", "idx_b")] + [
        (name, ctypes.c_longlong)
        for name in ("line_sr", "line_si", "line_sc", "s_sr", "s_si")] + [
        (name, ctypes.c_longlong * MAX_SETS)
        for name in ("pos_sq", "pos_sc", "count")] + [
        ("items", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("n", "closed", "sets")]


def _float32(t, what):
    cb.require_card(t, what)
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: expected torch.float32, got {t.dtype}")


def kernel_args(ref_line, positions, s_array, closed: bool = False):
    """``(args, outs, keep)``: the checked :class:`ProjArgs` of one launch,
    the outputs it fills (as :func:`get_s_coords_plain` returns them) and
    the views that must live until the launch is enqueued.  Raises on a
    wrong device, dtype or shape before anything is launched."""
    _float32(ref_line, "ref_line")
    _float32(s_array, "s_array")
    if ref_line.dim() not in (2, 3) or ref_line.shape[-1] != 2 \
            or ref_line.shape[-2] < 1:
        raise ValueError(f"ref_line: expected (n, 2) or (R, n, 2) with "
                         f"n >= 1, got {tuple(ref_line.shape)}")
    if tuple(s_array.shape) != tuple(ref_line.shape[:-1]):
        raise ValueError(f"s_array: expected shape "
                         f"{tuple(ref_line.shape[:-1])}, got "
                         f"{tuple(s_array.shape)}")
    positions = tuple(positions)
    if not 1 <= len(positions) <= MAX_SETS:
        raise ValueError(f"positions: expected 1 to {MAX_SETS} sets, got "
                         f"{len(positions)}")
    per_row = ref_line.dim() == 3
    a = ProjArgs()
    a.line, a.s = cb.ptr(ref_line).value, cb.ptr(s_array).value
    a.line_si, a.line_sc = ref_line.stride()[-2:]
    a.s_si = s_array.stride(-1)
    a.line_sr = ref_line.stride(0) if per_row else 0
    a.s_sr = s_array.stride(0) if per_row else 0
    if per_row and ref_line.shape[0] > 1 and (a.line_sr == 0 or a.s_sr == 0):
        raise ValueError("ref_line, s_array: expected one polyline a row, "
                         "got a row stride of 0")
    a.n, a.closed, a.sets = ref_line.shape[-2], int(bool(closed)), \
        len(positions)
    keep, outs = [], []
    for k, p in enumerate(positions):
        _float32(p, f"positions[{k}]")
        if p.dim() == 0 or p.shape[-1] != 2:
            raise ValueError(f"positions[{k}]: expected (..., 2), got "
                             f"{tuple(p.shape)}")
        if per_row and tuple(p.shape) != (ref_line.shape[0], 2):
            raise ValueError(f"positions[{k}]: expected "
                             f"({ref_line.shape[0]}, 2) for a polyline a "
                             f"row, got {tuple(p.shape)}")
        lead = tuple(p.shape[:-1])
        # a view wherever the leading axes merge (a copy where they do not)
        q = p.reshape(math.prod(lead), 2)
        keep.append(q)
        a.pos[k] = q.data_ptr()
        a.pos_sq[k], a.pos_sc[k] = q.stride()
        a.count[k] = q.shape[0]
        s = torch.empty(lead, dtype=torch.float32, device=p.device)
        ia = torch.empty(lead, dtype=torch.int64, device=p.device)
        ib = torch.empty(lead, dtype=torch.int64, device=p.device)
        a.s_out[k], a.idx_a[k], a.idx_b[k] = (t.data_ptr()
                                              for t in (s, ia, ib))
        outs.append((s, (ia, ib)))
    a.items = max(a.count[k] for k in range(a.sets))
    return a, tuple(outs), keep


def get_s_coords(ref_line, positions, s_array, closed: bool = False):
    """``get_s_coord`` of each position set over one polyline
    (:func:`get_s_coords_plain`): one launch of the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if ref_line.device.type == "cpu":
        return get_s_coords_plain(ref_line, positions, s_array, closed)
    a, outs, _keep = kernel_args(ref_line, positions, s_array, closed)
    cb.check(cb.load("projection")(ctypes.byref(a), cb.stream()),
             "projection")
    get_s_coords.launches += 1
    return outs


get_s_coords.launches = 0
