"""Velocity-profile recurrences (torch) — counterpart of the JAX package's
``ops/velocity.py`` (the parts the batched fleet tick uses).

Physics (the reference's forward-backward solver semantics):
  * local gg per point ``(ax_max, ay_max)``; friction shape
    ``ax_avail = ax_max * (1 - min(ay_used/ay_max, 1)^exp)^(1/exp)``
  * machine limit: rows ``[v, ax]`` interpolated at v (``np.interp``
    semantics, constant extrapolation), applied only while accelerating
  * drag ``v^2 * drag_coeff / m_veh`` (reduces acceleration, assists
    braking).

Every profile works on fixed-size padded rows: zero element lengths beyond
the true path end make each step a no-op there.  The recurrences run as
R independent rows of one stacked scan (:func:`stacked_vel_scan`); on the
card the scan is the hand-written kernel of ``ops/cuda_velocity.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-9
# np.interp's zero-width-interval guard at float32 (jnp.interp)
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))

# scan-pass modes for stacked_vel_scan
MODE_FWD = 0      # forward friction-circle + machine-limit acceleration
MODE_BRAKE = 1    # pure braking (friction + drag), no velocity bound
MODE_BWD = 2      # backward conservative refinement (pre-flipped inputs)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """np.interp for sorted ``xp`` (constant extrapolation), elementwise
    over ``x``, in the arithmetic order of ``jnp.interp``."""
    M = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, M - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _ax_tires(v, kappa_abs, ax_max, ay_max, dyn_model_exp):
    """Available longitudinal tire accel magnitude under lateral usage."""
    ay_used = v * v * kappa_abs
    frac = torch.clamp(ay_used / torch.clamp(ay_max, min=_EPS), 0.0, 1.0)
    radicand = 1.0 - torch.pow(frac, dyn_model_exp)
    return ax_max * torch.pow(torch.clamp(radicand, min=0.0),
                              1.0 / dyn_model_exp)


def stacked_vel_scan(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim, v_init, mode,
                     ax_max_machines, dyn_model_exp, drag_coeff, m_veh):
    """R independent velocity recurrences of length T, stepped together —
    the plain version of the velocity kernel.

    All per-step tensors are (R, T); ``v_init``/``mode`` are (R,).
    ``k2``/``axm2``/``aym2`` are the second interpolation point of MODE_BWD
    rows (pass k1/axm1/aym1 otherwise); MODE_BWD rows arrive pre-flipped
    and the caller flips the output back.

    :returns: (R, T + 1) velocities, column 0 = ``v_init``.
    """
    mode = mode.long()
    xp = ax_max_machines[:, 0].contiguous()
    fp = ax_max_machines[:, 1].contiguous()
    # a divisor tensor on the same device keeps this an IEEE division on
    # the card too (a Python-scalar divisor becomes a reciprocal multiply)
    m_t = torch.tensor(m_veh, dtype=k1.dtype, device=k1.device)
    is_fwd = mode == MODE_FWD
    is_brake = mode == MODE_BRAKE
    # a mode no row runs needs no candidate (one host read per call)
    has_fwd, has_brake = bool(is_fwd.any()), bool(is_brake.any())
    has_bwd = bool((mode == MODE_BWD).any())
    v = v_init.to(k1.dtype)
    out = [v]
    for t in range(k1.shape[1]):
        d_ = ds[:, t]
        vl_ = v_lim[:, t]
        a_t = _ax_tires(v, k1[:, t], axm1[:, t], aym1[:, t], dyn_model_exp)
        drag = v * v * drag_coeff / m_t
        dec = a_t + drag
        v_f = v_b = v_r = v
        if has_fwd:
            a_m = _interp(v, xp, fp)
            acc = torch.minimum(a_t, a_m) - drag
            v_f = torch.minimum(
                torch.sqrt(torch.clamp(v * v + 2.0 * acc * d_, min=0.0)), vl_)
        if has_brake:
            v_b = torch.sqrt(torch.clamp(v * v - 2.0 * dec * d_, min=0.0))
        if has_bwd:
            v_est = torch.sqrt(v * v + 2.0 * dec * d_)
            a_t2 = _ax_tires(v_est, k2[:, t], axm2[:, t], aym2[:, t],
                             dyn_model_exp)
            dec2 = a_t2 + v_est * v_est * drag_coeff / m_t
            v_r = torch.minimum(
                torch.sqrt(torch.clamp(
                    v * v + 2.0 * torch.minimum(dec, dec2) * d_, min=0.0)),
                vl_)
        v = torch.where(is_fwd, v_f, torch.where(is_brake, v_b, v_r))
        out.append(v)
    return torch.stack(out, dim=1)


def stacked_vel_scan_auto(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim, v_init,
                          mode, ax_max_machines, dyn_model_exp, drag_coeff,
                          m_veh, kernels: bool = True):
    """The stacked recurrences with per-step gg streams: through the CUDA
    kernel's wrapper (its plain version on CPU tensors) when ``kernels``,
    else the plain version on any device."""
    if kernels:
        from graphbasedlocaltrajectoryplanner_torch.ops.cuda_velocity import (
            vel_scan)
        return vel_scan(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim, v_init,
                        mode, ax_max_machines, dyn_model_exp, drag_coeff,
                        m_veh)
    return stacked_vel_scan(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim,
                            v_init, mode, ax_max_machines, dyn_model_exp,
                            drag_coeff, m_veh)


def stacked_vel_scan_cgg_auto(k1, k2, ds, v_lim, v_init, mode, machines,
                              dyn_model_exp, drag_coeff, m_veh, gg_ax, gg_ay,
                              kernels: bool = True):
    """The stacked recurrences with one constant local gg ``(gg_ax,
    gg_ay)``: the kernel's constant-gg instance (no gg streams), or the
    plain version with the constants broadcast into rows."""
    if kernels:
        from graphbasedlocaltrajectoryplanner_torch.ops.cuda_velocity import (
            vel_scan_cgg)
        return vel_scan_cgg(k1, k2, ds, v_lim, v_init, mode, machines,
                            dyn_model_exp, drag_coeff, m_veh, gg_ax, gg_ay)
    ax = torch.full_like(k1, gg_ax)
    ay = torch.full_like(k1, gg_ay)
    return stacked_vel_scan(k1, ax, ay, k2, ax, ay, ds, v_lim, v_init, mode,
                            machines, dyn_model_exp, drag_coeff, m_veh)


def calc_vel_profile_brake_auto(kappa, el_lengths, loc_gg, v_start,
                                dyn_model_exp=1.0, drag_coeff=0.85,
                                m_veh=1000.0, kernels: bool = True):
    """Brake-to-standstill profiles, one per row: ``kappa``/``el_lengths``
    (R, P), ``loc_gg`` (R, P, 2), ``v_start`` (R,) -> (R, P).  One
    MODE_BRAKE row each through :func:`stacked_vel_scan_auto` (the machine
    limit is inactive in brake mode; a constant table is supplied)."""
    machines = torch.tensor([[0.0, 1.0], [1.0, 1.0]], dtype=kappa.dtype,
                            device=kappa.device)
    kabs = torch.abs(kappa)[:, :-1]
    ax = loc_gg[:, :-1, 0]
    ay = loc_gg[:, :-1, 1]
    R = kappa.shape[0]
    return stacked_vel_scan_auto(
        kabs, ax, ay, kabs, ax, ay, el_lengths[:, :-1],
        torch.full_like(kabs, math.inf), v_start.to(kappa.dtype),
        torch.full((R,), MODE_BRAKE, dtype=torch.int32, device=kappa.device),
        machines, dyn_model_exp, drag_coeff, m_veh, kernels=kernels)


def calc_ax_profile(vx_profile, el_lengths):
    """Acceleration of a velocity profile along the last axis:
    ``(v_{i+1}^2 - v_i^2) / (2 ds_i)``, zero where ``ds == 0``.
    (..., P) -> (..., P-1)."""
    dv2 = vx_profile[..., 1:] ** 2 - vx_profile[..., :-1] ** 2
    el = el_lengths[..., :dv2.shape[-1]]
    return torch.where(el > _EPS, dv2 / torch.clamp(2.0 * el, min=_EPS), 0.0)


def conv_filt(signal, filt_window: int):
    """Unclosed moving-average filter along the last axis (tph
    ``conv_filt(closed=False)``): interior points averaged over the odd
    window, edge points ``i in [1, half)`` over the largest centered window
    that fits, the first and last samples raw."""
    if filt_window <= 1:
        return signal
    w = int(filt_window)
    if w % 2 == 0:
        raise ValueError("filt_window must be odd")
    half = w // 2
    n = signal.shape[-1]
    # centres half .. n-half-1, each a sum of window * (1/w) as a 'same'
    # convolution with a box kernel computes it
    mid = (signal.unfold(-1, w, 1) * (1.0 / w)).sum(-1)
    out = signal.clone()
    out[..., half:n - half] = mid
    for i in range(1, half):
        out[..., i] = signal[..., :2 * i + 1].mean(-1)
        out[..., n - 1 - i] = signal[..., n - 1 - 2 * i:].mean(-1)
    return out


def follow_control_vel(control_params: dict, obj_dist, control_d, v_obj,
                       v_ego, control_type: str = "PD"):
    """Follow-mode desired velocity: PD or PD-with-tan control law."""
    if control_type == "PD":
        return (v_obj - control_params["k_p"] * (control_d - obj_dist)
                + control_params["k_d"] * (v_obj - v_ego))
    if control_type == "PDtan":
        arg = torch.clamp((control_d - obj_dist) * math.pi / 2.0
                          / control_params["tan_w"],
                          -math.pi / 2 + 1e-5, math.pi / 2 - 1e-5)
        return (v_obj - torch.tan(arg) * control_params["k_p"]
                + control_params["k_d"] * (v_obj - v_ego))
    raise ValueError(f"unsupported control type {control_type!r}")


def stop_distance(v_brake, el_lengths, v_thresh: float = 0.1):
    """Distance travelled while a brake profile stays above ``v_thresh``:
    sum of element lengths while v > 0.1 (along the last axis)."""
    n = el_lengths.shape[-1]
    return torch.sum(torch.where(v_brake[..., :n] > v_thresh, el_lengths,
                                 0.0), dim=-1)
