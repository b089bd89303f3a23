"""Banded ADMM on velocity QPs: the CUDA kernel ``csrc/admm_vel.cu`` and
its plain PyTorch version ``ops/qp.admm_vel_qp`` (counterpart of the JAX
package's ``ops/qp.py:admm_vel_qp``, a ``lax.scan`` in XLA; no Pallas
kernel).

``d`` is the output of ``ops/qp._vel_qp_data``: per QP row ``e``, ``f``,
``rho_acc``, ``rho_dec``, ``u_acc``, ``u_dec`` (..., n-1) and ``rho_box``,
``q``, ``x0``, ``l_box``, ``u_box`` (..., n), any leading axes.  Returns
``(x (..., n), dict(r_prim, r_dual (...,)[, y (..., 3n-2)]))``, the whole
solve in one launch: one warp a QP row for n <= 128 (every call of the
planner), one block a row above.
"""

from __future__ import annotations

import ctypes

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import qp

# the largest n the kernel takes, and the largest of its warp design (one
# warp a row, WARP_ROWS rows a block; csrc/admm_vel.cu: N_MAX, WARP_N_MAX,
# WARP_ROWS); above WARP_N_MAX it runs the block design (one block a row)
N_MAX = 1024
WARP_N_MAX = 128
WARP_ROWS = 2
_LONG = ("e", "f", "rho_acc", "rho_dec", "u_acc", "u_dec")     # (..., n-1)
_SHORT = ("rho_box", "q", "x0", "l_box", "u_box")              # (..., n)


def design(n: int) -> str:
    """The design the kernel runs for rows of ``n`` points: ``"warp"`` or
    ``"block"``."""
    return "warp" if n <= WARP_N_MAX else "block"


def kernel_args(d: dict, iters: int = 60, sigma: float = 1e-6,
                alpha: float = 1.6, w_smooth: float = 1e-4,
                with_y: bool = False):
    """``(c_args, (x, r_prim, r_dual, y), keep)``: the checked arguments of
    the kernel's C entry point (all but the stream), the outputs it fills
    (``y`` None unless ``with_y``), shaped ``(R, ...)``, and the inputs that
    must live until the launch is enqueued."""
    lead, n = tuple(d["q"].shape[:-1]), d["q"].shape[-1]
    if n < 2 or n > N_MAX:
        raise ValueError(f"admm_vel: n = {n} points a row, the kernel "
                         f"takes 2 .. {N_MAX}")
    R = 1
    for s in lead:
        R *= s
    args = []
    for k in _LONG + _SHORT:
        t = d[k].reshape(R, d[k].shape[-1]).contiguous()
        cb.require(t, torch.float32,
                   (R, n - 1) if k in _LONG else (R, n), f"admm_vel {k}")
        args.append(t)
    e, f, rho_a, rho_d, ua, ud, rho_b, q, x0, lb, ub = args
    dev = q.device
    x = torch.empty((R, n), dtype=torch.float32, device=dev)
    r_prim = torch.empty((R,), dtype=torch.float32, device=dev)
    r_dual = torch.empty((R,), dtype=torch.float32, device=dev)
    y = (torch.empty((R, 3 * n - 2), dtype=torch.float32, device=dev)
         if with_y else None)
    c_args = (*(cb.ptr(t) for t in (e, f, rho_b, rho_a, rho_d, q, x0, lb,
                                     ub, ua, ud, x, r_prim, r_dual)),
              cb.ptr(y) if with_y else None, R, n, iters,
              ctypes.c_float(sigma), ctypes.c_float(alpha),
              ctypes.c_float(1 - alpha), ctypes.c_float(w_smooth))
    return c_args, (x, r_prim, r_dual, y), args


def admm_vel(d: dict, iters: int = 60, sigma: float = 1e-6,
             alpha: float = 1.6, w_smooth: float = 1e-4,
             with_y: bool = False):
    """The solve: the CUDA kernel on CUDA tensors, ``qp.admm_vel_qp`` on
    CPU tensors (which always returns ``y``).  ``with_y`` asks the kernel
    for the duals too."""
    if d["q"].device.type == "cpu":
        return qp.admm_vel_qp(d, iters=iters, sigma=sigma, alpha=alpha,
                              w_smooth=w_smooth)
    lead, n = tuple(d["q"].shape[:-1]), d["q"].shape[-1]
    c_args, (x, r_prim, r_dual, y), _keep = kernel_args(
        d, iters, sigma, alpha, w_smooth, with_y)
    if x.shape[0]:
        rc = cb.load("admm_vel")(*c_args, cb.stream())
        cb.check(rc, "admm_vel")
        admm_vel.launches += 1
    res = dict(r_prim=r_prim.reshape(lead), r_dual=r_dual.reshape(lead))
    if with_y:
        res["y"] = y.reshape(lead + (3 * n - 2,))
    return x.reshape(lead + (n,)), res


admm_vel.launches = 0
