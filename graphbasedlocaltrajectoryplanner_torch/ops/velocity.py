"""Velocity-profile recurrences (torch) — counterpart of the JAX package's
``ops/velocity.py``.

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


def _rows(x, lead, ref):
    """A scalar or leading-shaped argument as one value per flattened row
    (R,) on ``ref``'s dtype and device."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=ref.dtype,
                                              device=ref.device),
                              lead).reshape(-1)


def calc_vel_profile_fb(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                        v_start, v_end=None, dyn_model_exp: float = 1.0,
                        drag_coeff: float = 0.85, m_veh: float = 1000.0,
                        end_idx=None, kernels: bool = True):
    """Forward-backward velocity profile on (padded) paths (tph
    ``calc_vel_profile(..., closed=False)``), one per row of the leading
    axes: ``kappa``/``el_lengths`` (..., P), ``loc_gg`` (..., P, 2) local
    ``[ax_max, ay_max]``, ``ax_max_machines`` (M, 2); ``v_max``,
    ``v_start``, ``v_end`` and ``end_idx`` (the valid points, default all)
    scalars or (...,).  ``el_lengths[i] = 0`` from ``end_idx - 1`` on;
    ``v_end`` caps the last valid point and the padding.  The forward pass
    and the backward refinement are MODE_FWD and MODE_BWD rows of
    :func:`stacked_vel_scan`: with ``kernels`` through the velocity-scan
    kernel's general instance on CUDA tensors (``cuda_velocity.vel_scan``).
    Returns (..., P) velocities."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velocity
    scan = cuda_velocity.vel_scan if kernels else stacked_vel_scan
    lead, P = kappa.shape[:-1], kappa.shape[-1]
    kabs = torch.abs(kappa).reshape(-1, P)
    gg = torch.broadcast_to(loc_gg, lead + (P, 2)).reshape(-1, P, 2)
    ax, ay = gg[..., 0], gg[..., 1]
    el = torch.broadcast_to(el_lengths, lead + (P,)).reshape(-1, P)
    R = kabs.shape[0]
    v0 = torch.minimum(torch.sqrt(ay / torch.clamp(kabs, min=_EPS)),
                       _rows(v_max, lead, kabs)[:, None])
    idx = torch.arange(P, device=kappa.device)
    if v_end is not None:
        end = (torch.full((R,), P, device=kappa.device) if end_idx is None
               else torch.broadcast_to(torch.as_tensor(
                   end_idx, device=kappa.device), lead).reshape(-1))
        v0 = torch.where(idx >= end[:, None] - 1,
                         torch.minimum(v0, _rows(v_end, lead, kabs)[:, None]),
                         v0)
    v0[:, 0] = torch.minimum(v0[:, 0], _rows(v_start, lead, kabs))

    def mode(m):
        return torch.full((R,), m, dtype=torch.int32, device=kappa.device)
    k, a, y = kabs[:, :-1], ax[:, :-1], ay[:, :-1]
    v_f = scan(k, a, y, k, a, y, el[:, :-1], v0[:, 1:], v0[:, 0],
               mode(MODE_FWD), ax_max_machines, dyn_model_exp, drag_coeff,
               m_veh)
    flip = lambda x: torch.flip(x, dims=[-1])               # noqa: E731
    v_b = scan(
        flip(kabs[:, 1:]), flip(ax[:, 1:]), flip(ay[:, 1:]), flip(k),
        flip(a), flip(y), flip(el[:, :-1]), flip(v_f[:, :-1]), v_f[:, -1],
        mode(MODE_BWD), ax_max_machines, dyn_model_exp, drag_coeff, m_veh)
    return flip(v_b).reshape(lead + (P,))


def calc_vel_profile_brake(kappa, el_lengths, loc_gg, v_start,
                           dyn_model_exp: float = 1.0,
                           drag_coeff: float = 0.85, m_veh: float = 1000.0):
    """Brake-to-standstill profiles (tph ``calc_vel_profile_brake``), one
    per row of the leading axes; shapes as :func:`calc_vel_profile_fb`,
    ``v_start`` a scalar or (...,).  Returns (..., P) velocities."""
    lead, P = kappa.shape[:-1], kappa.shape[-1]
    v = calc_vel_profile_brake_auto(
        kappa.reshape(-1, P),
        torch.broadcast_to(el_lengths, lead + (P,)).reshape(-1, P),
        torch.broadcast_to(loc_gg, lead + (P, 2)).reshape(-1, P, 2),
        _rows(v_start, lead, kappa), dyn_model_exp, drag_coeff, m_veh,
        kernels=False)
    return v.reshape(lead + (P,))


def _associative_scan(combine, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along axis 1 with
    an associative ``combine`` — the recursion of
    ``jax.lax.associative_scan`` (pairs reduced, the odd prefixes scanned,
    the even ones completed), so every element is combined in the same
    order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(combine, combine(
        [e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[:, 0::2] = torch.cat([e[:, :1], ev], dim=1)
        r[:, 1::2] = od
        out.append(r)
    return out


def stacked_vel_scan_assoc(k1, axm1, aym1, k2, axm2, aym2, ds, v_lim, v_init,
                           mode, ax_max_machines, dyn_model_exp, drag_coeff,
                           m_veh, sweeps: int = 6):
    """Log-depth form of :func:`stacked_vel_scan` (same arguments, plus the
    Picard ``sweeps``).  In energy space ``E = v^2`` every mode's step is
    ``E_{t+1} = clip(E_t + c_t(v_t), 0, B_{t+1})`` with ``B = v_lim^2``
    (no cap on MODE_BRAKE rows); maps ``x -> clip(x + a, lo, hi)`` compose
    in closed form, so for fixed coefficients the chain is one associative
    scan.  Each sweep evaluates the coefficients at the previous sweep's
    profile; at the fixed point the result is the sequential one.
    Returns (R, T + 1) velocities."""
    mode = mode.long()[:, None]
    v0 = v_init.to(k1.dtype)
    E0 = v0 * v0
    inf = torch.tensor(math.inf, dtype=k1.dtype, device=k1.device)
    Bc = torch.where(torch.isfinite(v_lim), v_lim * v_lim, inf)
    Bc = torch.where(mode == MODE_BRAKE, inf, Bc)
    xp = ax_max_machines[:, 0].contiguous()
    fp = ax_max_machines[:, 1].contiguous()

    def coeffs(v):
        a_t = _ax_tires(v, k1, axm1, aym1, dyn_model_exp)
        drag = v * v * drag_coeff / m_veh
        c_f = 2.0 * (torch.minimum(a_t, _interp(v, xp, fp)) - drag) * ds
        dec = a_t + drag
        c_b = -2.0 * dec * ds
        v_est = torch.sqrt(v * v + 2.0 * dec * ds)
        a_t2 = _ax_tires(v_est, k2, axm2, aym2, dyn_model_exp)
        dec2 = a_t2 + v_est * v_est * drag_coeff / m_veh
        c_r = 2.0 * torch.minimum(dec, dec2) * ds
        return torch.where(mode == MODE_FWD, c_f,
                           torch.where(mode == MODE_BRAKE, c_b, c_r))

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    def combine(f, g):
        """g after f (the scan walks left to right)."""
        af, lf, hf = f
        ag, lg, hg = g
        return (af + ag, clip(lf + ag, lg, hg), clip(hf + ag, lg, hg))

    v = torch.where(torch.isfinite(v_lim), v_lim, v0[:, None])
    zero = torch.zeros_like(Bc)
    E = None
    for _ in range(sweeps):
        A, Lo, Hi = _associative_scan(combine, (coeffs(v), zero, Bc))
        E = clip(E0[:, None] + A, Lo, Hi)
        v = torch.sqrt(torch.clamp(torch.cat([E0[:, None], E[:, :-1]],
                                             dim=1), min=0.0))
    return torch.cat([E0[:, None], E], dim=1) ** 0.5


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


def calc_vel_profile_follow(kappa, el_lengths, loc_gg, ax_max_machines,
                            v_start, v_ego, v_obj, v_max, safety_d,
                            veh_length, obj_dist, opp_stop_dist, opp_vel_at,
                            control_params: dict, control_type: str = "PD",
                            dyn_model_exp: float = 1.0,
                            drag_coeff: float = 0.85, m_veh: float = 1000.0):
    """Follow-mode velocity profile (reference calc_vel_profile_follow),
    one per row of the leading axes: shapes as :func:`calc_vel_profile_fb`,
    every scalar argument a scalar or (...,).  The opponent's run-out on
    the global raceline comes summarized as ``opp_stop_dist`` and
    ``opp_vel_at`` (``planner/velplan.opponent_summary``).

    :returns: (vx (..., P), too_close, vel_bound_ok, v_control (...,),
        control_d)
    """
    lead, P = kappa.shape[:-1], kappa.shape[-1]
    kappa = kappa.reshape(-1, P)
    el = torch.broadcast_to(el_lengths, lead + (P,)).reshape(-1, P)
    gg = torch.broadcast_to(loc_gg, lead + (P, 2)).reshape(-1, P, 2)
    R = kappa.shape[0]
    rows = torch.arange(R, device=kappa.device)
    [v_start, v_ego, v_obj, v_max, safety_d, veh_length, obj_dist,
     opp_stop_dist, opp_vel_at] = [
        _rows(x, lead, kappa) for x in (v_start, v_ego, v_obj, v_max,
                                        safety_d, veh_length, obj_dist,
                                        opp_stop_dist, opp_vel_at)]
    phys = dict(dyn_model_exp=dyn_model_exp, drag_coeff=drag_coeff,
                m_veh=m_veh)
    control_d = control_params["c_p"] * safety_d + veh_length
    safety_total = safety_d + veh_length
    too_close = (obj_dist - safety_total) < 0.0

    # ego braking profile and stopping distance on the local path
    v_ego_brake = calc_vel_profile_brake(kappa, el, gg, v_start, **phys)
    ego_stop_d = stop_distance(v_ego_brake, el)
    s = torch.cat([torch.zeros_like(el[:, :1]),
                   torch.cumsum(el[:, :-1], dim=-1)], dim=-1)
    s_stop = obj_dist - safety_total + opp_stop_dist
    stop_idx = torch.clamp(torch.sum(s < s_stop[:, None], dim=-1), 0, P - 1)
    v_end = torch.where(s_stop > s[:, -1], opp_vel_at, 0.0)
    v_control = torch.minimum(torch.clamp(follow_control_vel(
        control_params, obj_dist, control_d, v_obj, v_ego, control_type),
        min=0.0), v_max)

    # segment 1: decelerate to the control velocity if faster
    seg1_active = (v_start > v_control) & (stop_idx >= 2)
    below = v_ego_brake <= v_control[:, None]
    idx_c_raw = torch.argmax(below.to(torch.int32), dim=-1)
    idx_c_raw = torch.where(below[rows, idx_c_raw], idx_c_raw, stop_idx)
    idx_c = torch.where(seg1_active, torch.minimum(
        torch.where(idx_c_raw == 0, stop_idx, idx_c_raw), stop_idx), 0)
    vx_control_start = torch.where(seg1_active, v_ego_brake[rows, idx_c],
                                   v_start)

    # segment 2: the fb profile capped at v_control up to stop_idx
    idxs = torch.arange(P, device=kappa.device)
    el_seg2 = torch.where(idxs < stop_idx[:, None], el, 0.0)
    el_seg2 = torch.where(idxs < idx_c[:, None], 0.0, el_seg2)
    v_seg2 = calc_vel_profile_fb(kappa, el_seg2, gg, ax_max_machines,
                                 v_control,
                                 torch.minimum(vx_control_start, v_control),
                                 v_end=v_end, end_idx=stop_idx + 1, **phys)
    vel_bound_ok = torch.abs(v_seg2[rows, idx_c] - vx_control_start) <= 1.0
    vel_bound_ok &= ~((~seg1_active) & (stop_idx < 2))
    vx = torch.where(idxs < idx_c[:, None], v_ego_brake, v_seg2)
    vx = torch.where(idxs > stop_idx[:, None], 0.0, vx)
    vel_bound_ok &= torch.abs(vx[:, 0] - v_start) <= 1.0

    # when the ego cannot stop in the distance anyway: plain ego brake
    cannot_hold = ego_stop_d >= s_stop
    vx = torch.where(cannot_hold[:, None], v_ego_brake, vx)
    vel_bound_ok = torch.where(cannot_hold, True, vel_bound_ok)

    # intersect with the unconstrained profile
    vx_compl = calc_vel_profile_fb(kappa, el, gg, ax_max_machines, v_max,
                                   v_start, **phys)
    vx = torch.minimum(vx, vx_compl)
    return (vx.reshape(lead + (P,)), too_close.reshape(lead),
            vel_bound_ok.reshape(lead), v_control.reshape(lead),
            control_d.reshape(lead))
