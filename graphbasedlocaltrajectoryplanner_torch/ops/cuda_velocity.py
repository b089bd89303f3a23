"""Stacked velocity recurrences: the CUDA kernel template
``csrc/vel_scan.cu`` and its plain PyTorch version
(``ops/velocity.stacked_vel_scan``) — counterpart of the JAX package's
``ops/pallas_velocity.py``.  The kernel regroups the rows by mode itself
(one warp per mode in every tile of 32 rows), so callers stack rows in any
order.  Two instances, each with its own wrapper and launch count: :func:`vel_scan_cgg` (one constant local gg, the velocity
stage) and :func:`vel_scan` (per-step gg streams, the brake rows of the
opponent summary and the emergency profile).
"""

from __future__ import annotations

import ctypes

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops

# steps per shared-memory chunk of the kernel (``CH`` in csrc/vel_scan.cu):
# the T at which its tiling changes shape, for the tests of ragged shapes
CHUNK = 16


def kernel_machines(machines):
    """The machine table as the kernel takes it, at least two knots: a
    one-row table (the facade's default ``ax_max_machines``) is the
    constant acceleration of its row under ``np.interp``, and the same row
    twice (an interval of zero width) is that constant too."""
    machines = machines.to(torch.float32)
    if machines.shape[0] == 1:
        machines = machines.expand(2, 2)
    return machines.contiguous()


def _launch(k1, gg, k2, ds, v_lim, v_init, mode, machines, exp, drag, m_veh,
            const_gg):
    R, T = k1.shape
    dev = k1.device
    rows = [k1, k2, ds, v_lim] + ([] if gg is None else list(gg))
    rows = [x.contiguous() for x in rows]
    for x, what in zip(rows, ("k1", "k2", "ds", "v_lim", "axm1", "aym1",
                              "axm2", "aym2")):
        cb.require(x, torch.float32, (R, T), what)
    v_init = v_init.to(torch.float32).contiguous()
    mode = mode.to(torch.int32).contiguous()
    machines = kernel_machines(machines)
    cb.require(v_init, torch.float32, (R,), "v_init")
    cb.require(mode, torch.int32, (R,), "mode")
    cb.require(machines, torch.float32, (machines.shape[0], 2), "machines")
    k1, k2, ds, v_lim = rows[:4]
    null = ctypes.c_void_p(0)
    a1, y1, a2, y2 = ((null,) * 4 if gg is None
                      else tuple(cb.ptr(x) for x in rows[4:]))
    out = torch.empty((R, T + 1), dtype=torch.float32, device=dev)
    gg_ax, gg_ay = const_gg if const_gg is not None else (0.0, 0.0)
    f = ctypes.c_float
    rc = cb.load("vel_scan")(
        cb.ptr(k1), a1, y1, cb.ptr(k2), a2, y2, cb.ptr(ds), cb.ptr(v_lim),
        cb.ptr(v_init), cb.ptr(mode), cb.ptr(machines), machines.shape[0],
        cb.ptr(out), R, T, int(const_gg is not None), f(gg_ax), f(gg_ay),
        f(exp), f(1.0 / exp), f(drag), f(m_veh), f(velops._INTERP_EPS),
        cb.stream())
    cb.check(rc, "vel_scan")
    return out


def vel_scan(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim, v_init, mode,
             machines, dyn_model_exp, drag_coeff, m_veh):
    """Recurrences with per-step gg streams: the kernel's general instance
    on CUDA tensors, ``velocity.stacked_vel_scan`` on CPU tensors."""
    if k1.device.type == "cpu":
        return velops.stacked_vel_scan(k1, axm1, aym1, k2, axm2, aym2, ds,
                                       v_lim, v_init, mode, machines,
                                       dyn_model_exp, drag_coeff, m_veh)
    out = _launch(k1, (axm1, aym1, axm2, aym2), k2, ds, v_lim, v_init, mode,
                  machines, float(dyn_model_exp), float(drag_coeff),
                  float(m_veh), None)
    vel_scan.launches += 1
    return out


def vel_scan_cgg(k1, k2, ds, v_lim, v_init, mode, machines, dyn_model_exp,
                 drag_coeff, m_veh, gg_ax, gg_ay):
    """Recurrences with one constant local gg: the kernel's constant-gg
    instance on CUDA tensors, the plain version with the gg broadcast into
    rows on CPU tensors."""
    if k1.device.type == "cpu":
        ax = torch.full_like(k1, gg_ax)
        ay = torch.full_like(k1, gg_ay)
        return velops.stacked_vel_scan(k1, ax, ay, k2, ax, ay, ds, v_lim,
                                       v_init, mode, machines, dyn_model_exp,
                                       drag_coeff, m_veh)
    out = _launch(k1, None, k2, ds, v_lim, v_init, mode, machines,
                  float(dyn_model_exp), float(drag_coeff), float(m_veh),
                  (float(gg_ax), float(gg_ay)))
    vel_scan_cgg.launches += 1
    return out


vel_scan.launches = 0
vel_scan_cgg.launches = 0
