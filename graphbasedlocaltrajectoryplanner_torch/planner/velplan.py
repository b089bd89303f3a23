"""Per-action velocity planning (torch) — counterpart of the JAX package's
``planner/velplan.py``: ``opponent_summary``, ``velocity_stage_scenario``
and ``emergency_kernel`` for the batched fleet tick, ``velocity_kernel``,
``brake_on_backup_kernel`` and ``brake_em_sqp_kernel`` for the interactive
handler; both velocity backends, ``fb`` (forward-backward recurrences) and
``sqp`` (QP profiles by ADMM, ``ops/qp.py``).

Everything works on fixed-size padded rows with a leading scenario
dimension B: element lengths are zero at and beyond the true path end, and
dynamic sub-ranges (delay-compensation prefix, brake prefix, reduced
horizon) are masks on element lengths and curvatures.  The recurrences of
one dependency level run as one stacked scan over all scenarios' rows; the
QPs of one call run as one batched solve.
"""

from __future__ import annotations

import math

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import dynshift
from graphbasedlocaltrajectoryplanner_torch.ops import projection as proj
from graphbasedlocaltrajectoryplanner_torch.ops import qp
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops

# opponent brake-distance ggv
OPP_GGV_AX = 14.0
OPP_GGV_AY = 14.0

# emergency-profile vehicle constants
EMERG_VEH_MASS = 1160.0
EMERG_VEH_DRAGCOEFF = 0.854

# opponent brake-summary window (fine raceline points)
F_CAP = 128


_CUMSUM_BLOCK = 16


def _cumsum(x):
    """Inclusive cumulative sum along the last axis in the summation order
    of the reference's cumsum on the CPU (XLA's blocked rewrite): float32
    sequential within blocks of 16, block totals scanned the same way
    recursively, each block's exclusive prefix added last.

    The arc lengths it produces feed discrete choices of the velocity
    stage (stop index, follow hand-off), where a last-bit difference can
    move a profile; ``torch.cumsum`` accumulates in float64 on the CPU and
    in another order on the card."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    m = -(-n // _CUMSUM_BLOCK)
    xb = torch.nn.functional.pad(x, (0, m * _CUMSUM_BLOCK - n)).reshape(
        x.shape[:-1] + (m, _CUMSUM_BLOCK))
    inner = _cumsum(xb)
    tot = _cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (inner + excl[..., None]).reshape(
        x.shape[:-1] + (m * _CUMSUM_BLOCK,))[..., :n]


def _cumsum0(x):
    """Cumulative sum along the last axis with a leading zero, dropping the
    last element: ``[0, x0, x0+x1, ...]`` of the same length."""
    z = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([z, _cumsum(x[..., :-1])], dim=-1)


def _at(v, i):
    """v[..., i[...]] along the last axis."""
    return torch.gather(v, -1, i.long()[..., None])[..., 0]


def opponent_summary(glob_rl, glob_el, obj_pos, v_obj, dyn_model_exp,
                     drag_coeff, m_veh, f_cap: int = F_CAP,
                     kernels: bool = True):
    """Opponent stopping behaviour on the global raceline, per scenario.

    :param glob_rl: (F, 5) fine raceline [s, x, y, kappa, vel];
        ``glob_el`` (F,); ``obj_pos`` (B, 2); ``v_obj`` (B,).
    :returns: (opp_stop_dist (B,), roll_vel (B, f_cap), roll_el (B, f_cap),
               roll_cum (B, f_cap))."""
    F = glob_rl.shape[0]
    _, (idx_a, _) = proj.get_s_coord(glob_rl[:, 1:3], obj_pos, glob_rl[:, 0],
                                     closed=True)
    start = torch.remainder(idx_a, F - 1)
    # enough wrap copies that start (< F-1) + f_cap rows always exist
    n_tiles = 1 + -(-f_cap // (F - 1))
    glob2 = torch.cat([glob_rl[:F - 1, 3:5], glob_el[:F - 1, None]],
                      dim=1).repeat(n_tiles, 1)
    win = dynshift.select_window(glob2, start, f_cap)       # (B, f_cap, 3)
    kappa_r, vel_r, el_r = win[..., 0], win[..., 1], win[..., 2]
    v_start = torch.minimum(v_obj, vel_r[:, 0])
    gg = torch.full(kappa_r.shape + (2,), OPP_GGV_AX, dtype=kappa_r.dtype,
                    device=kappa_r.device)
    gg[..., 1] = OPP_GGV_AY
    v_brake = velops.calc_vel_profile_brake_auto(
        kappa_r, el_r, gg, v_start, dyn_model_exp, drag_coeff, m_veh,
        kernels=kernels)
    opp_stop_dist = velops.stop_distance(v_brake, el_r)
    return opp_stop_dist, vel_r, el_r, _cumsum(el_r)


def _runout_velocity(roll_vel, roll_cum, target_dist):
    """Raceline velocity after the opponent travelled ``target_dist``."""
    idx = torch.sum(roll_cum < target_dist[:, None], dim=-1) + 1
    idx = torch.clamp(idx, 0, roll_vel.shape[-1] - 1)
    return torch.where(target_dist <= 0.0, roll_vel[:, 0], _at(roll_vel, idx))


def _sqp_m_window(cols, pref_idx, l_real, m: int):
    """VpSQP's m-point window of a padded per-point table: rows
    ``pref_idx .. pref_idx + m - 1``; beyond the real slice length
    ``l_real`` every column repeats the row at ``l_real - 1`` and the
    element length (column 1) the step at ``l_real - 2``, both indices
    clamped into the window (so ``l_real <= 1`` repeats row 0).

    :param cols: (..., P, C) table with the element length in column 1;
        ``pref_idx`` and ``l_real`` (...,) (``pref_idx`` at most 64, the
        delay-compensation cut).
    :returns: (..., m, C).
    """
    idx_m = torch.arange(m, device=cols.device)
    win = dynshift.shift_rows_up(cols, pref_idx, 64)[..., :m, :]
    l_real = cuda_graph.as_tensor(l_real, device=cols.device).long()

    def row_at(j):
        j = torch.clamp(j, 0, m - 1)
        return torch.gather(win, -2, j[..., None, None].expand(
            win.shape[:-2] + (1, win.shape[-1])))[..., 0, :]
    last_v = row_at(l_real - 1)
    last_e = row_at(l_real - 2)
    out = torch.where((idx_m < l_real[..., None])[..., None], win,
                      last_v[..., None, :])
    el = torch.where(idx_m < l_real[..., None] - 1, win[..., 1],
                     last_e[..., 1:2])
    return torch.cat([out[..., :1], el[..., None], out[..., 2:]], dim=-1)


def _sqp_follow_vmax(m: int, vel_max, v_obj, obj_dist, safety_d, veh_length,
                     axc, step):
    """VpSQP's follow-mode pointwise velocity cap on the uniform step grid,
    per row of ``v_obj``/``obj_dist``/``axc`` (...,): ``vel_max`` up to the
    safety gap, then the opponent's braking curve (the closed form of
    ``v_k = sqrt(v_{k-1}^2 - 2 a step)``), one depleted sample at 2 m/s,
    and ``v_obj`` where the reference's loop leaves its prefill.

    :returns: (..., m)
    """
    idx_m = torch.arange(m, device=v_obj.device)
    # clamped as floats: XLA's float-to-int conversion saturates
    idx_vmax = torch.clamp(torch.ceil((obj_dist - safety_d - veh_length)
                                      / step), 0, m).to(torch.int32)
    j = idx_m - idx_vmax[..., None]
    rt = (v_obj ** 2)[..., None] \
        - (2.0 * axc * step)[..., None] * j.to(torch.float32)
    dep_j = torch.clamp(torch.floor(v_obj ** 2 / torch.clamp(
        2.0 * axc * step, min=1e-9)), max=2.0 ** 30).to(torch.int32) + 1
    fill_n = torch.where(dep_j <= m - 1, dep_j + 1, m - 1)[..., None]
    dep_j = dep_j[..., None]
    v_obj_c = v_obj[..., None].expand(j.shape)
    val = torch.where(j == 0, v_obj_c,
                      torch.where(j == dep_j, 2.0,
                                  torch.sqrt(torch.clamp(rt, min=0.0))))
    tail = torch.where((j >= 0) & (j < fill_n), val, v_obj_c)
    return torch.where(idx_m < idx_vmax[..., None], vel_max, tail)


def _sqp_tire_end(win, tire_end_idx, tire_end_mps2, veh_turn):
    """The gg of the m-point windows ``win`` (..., m, 4) [kappa el ax ay]
    with the tire-end gg on the last ``tire_end_idx`` points, and the
    conservative terminal velocity ``sqrt(tire_end_mps2 * veh_turn)``;
    ``tire_end_mps2`` a scalar or one per trailing row.  Returns (gg (...,
    m, 2), v_end)."""
    m = win.shape[-2]
    def f32(v):
        return cuda_graph.as_tensor(v, win.dtype, win.device)
    tire = f32(tire_end_mps2)
    in_tire = torch.arange(m, device=win.device) >= m - tire_end_idx
    gg = torch.where(in_tire[:, None], tire[..., None, None], win[..., 2:4])
    return gg, torch.sqrt(tire * f32(veh_turn))


def _sqp_profiles(win, gg, v_end, v_max, v_start, x0v, machines, drag_coeff,
                  m_veh, kernels):
    """The QP profiles of the m-point windows ``win`` (..., m, 4) in one
    batched solve (one kernel launch on the card): ``gg`` and ``v_end``
    from :func:`_sqp_tire_end` (the terminal velocity at the window's
    end), ``v = v_start`` pinned at its start, ``x0v`` (..., m) the
    warm-start guess.  Returns (vx (..., m), the ADMM's residuals)."""
    return qp.qp_vel_profile(
        win[..., 0], win[..., 1], gg, machines, v_max, v_start, v_end=v_end,
        end_idx=win.shape[-2], drag_coeff=drag_coeff, m_veh=m_veh, pin_idx=0,
        x0_v=x0v, kernels=kernels)


def _place_back(vx_m, shift, P: int):
    """m-grid profiles (..., m) back on the padded path rows ``shift + i``;
    rows beyond the window zero."""
    pad = torch.zeros(vx_m.shape[:-1] + (P - vx_m.shape[-1],),
                      dtype=vx_m.dtype, device=vx_m.device)
    return dynshift.shift_rows_down(torch.cat([vx_m, pad], dim=-1)[..., None],
                                    shift, 64)[..., 0]


def _sqp_store(vx_raw_m, P: int):
    """The warm-start store: the m grid values, then the last one repeated
    to P rows (the handler's shift-and-fill push reads them)."""
    return torch.cat([vx_raw_m, vx_raw_m[..., -1:].expand(
        vx_raw_m.shape[:-1] + (P - vx_raw_m.shape[-1],))], dim=-1)


def velocity_stage_scenario(paths, n_valids, gg, vel_course, c_len, vel_plan,
                            vel_est, vel_max, machines, v_max_offset,
                            v_end_rl, red_len, obj_dist, v_obj, safety_d,
                            opp_stop_dist, roll_vel, roll_cum, veh_length,
                            ctrl_cp, ctrl_kd, ctrl_kp, ctrl_tanw,
                            dyn_model_exp, drag_coeff, m_veh,
                            control_type: str = "PD", follow_slot: int = 1,
                            filt_window: int = 1, vp_backend: str = "fb",
                            sqp_x0=None, veh_turn=7.0, tire_end_idx: int = 0,
                            tire_end_mps2=5.0, sqp_m: int = None,
                            sqp_step=2.5, const_gg: tuple = None, *,
                            kernels: bool = True):
    """Slot-specialized velocity stage for a batch of scenarios.  The first
    ``c_len`` rows keep the committed ``vel_course`` and replanning starts
    from ``vel_plan``.

    ``fb``: the follow solver runs only for the follow slot (13 recurrence
    rows per scenario over 4 dependency levels) — on the kernel's
    constant-gg instance with ``const_gg``, else with per-row gg streams
    from ``gg`` (kernel 5 on the card).

    ``sqp``: the reference's SQP planner at fleet scale — no brake prefix,
    the 4 normal-branch QPs of a scenario and its follow QP (pointwise
    opponent cap) over a fixed ``sqp_m``-point window, all 5B as one
    batched ADMM solve; ``too_close`` never raised; the status hand-off per
    slot (infeasible solves zeroed, overtake slots also on inaccurate
    ones); no smoothing.

    ``filt_window`` > 1 smooths every fb profile with the moving average
    of ``ops/velocity.conv_filt`` (the handler's smoothing; ignored under
    ``sqp``, as the reference filters only the fb planner's profiles).

    :param paths: (B, 4, P, 5) [x y psi kappa el]; ``n_valids``,
        ``v_end_rl``, ``red_len`` (B, 4); ``gg`` (P, 2) shared local gg
        (unscaled); ``vel_course`` (B, P); ``c_len``, ``vel_plan``,
        ``vel_est``, ``obj_dist``, ``v_obj``, ``opp_stop_dist`` (B,);
        ``roll_vel``, ``roll_cum`` (B, F_CAP); scalar parameters as 0-dim
        float32 tensors (``dyn_model_exp``, ``drag_coeff``, ``m_veh`` as
        floats).
    :param const_gg: ``(ax, ay)``, the one constant local gg that ``gg``
        holds in every row (fb only; ignored under ``sqp``).
    :param sqp_x0: (B, 4, P) warm-start profiles (``sqp``; None: the
        reference's cold 20 m/s fill); ``veh_turn``, ``tire_end_mps2`` as
        0-dim tensors.
    :returns: dict(trajs (B, 4, P, 7), vel_bound (B, 4), too_close (B,),
        vx_sqp (B, 4, P), qp_status (B, 4) int32; the last two zero for
        ``fb``).
    """
    Fs = follow_slot
    B, _, P, _ = paths.shape
    dev = paths.device
    idx = torch.arange(P, device=dev)
    kappa = paths[..., 3]
    el = paths[..., 4]                                        # (B, 4, P)
    kabs = torch.abs(kappa)
    row_inf = torch.full((B, P - 1), math.inf, dtype=paths.dtype, device=dev)
    ctrl = {"c_p": ctrl_cp, "k_d": ctrl_kd, "k_p": ctrl_kp, "tan_w": ctrl_tanw}
    flip = lambda x: torch.flip(x, dims=[-1])                 # noqa: E731
    sqp = vp_backend == "sqp"
    if not sqp and vp_backend != "fb":
        raise ValueError(f"unknown velocity backend {vp_backend!r}")

    def _stack(rows, modes):
        cols = list(zip(*rows))
        per_step = [torch.stack(c, dim=1) for c in cols[:-1]]   # (B, r, T)
        r, T = per_step[0].shape[1:]
        per_step = [x.reshape(B * r, T) for x in per_step]
        v_init = torch.stack(cols[-1], dim=1).reshape(B * r)
        mode = cuda_graph.const_vector(modes, torch.int32, dev).repeat(B)
        return per_step, v_init, mode, r, T

    if const_gg is not None:
        def _lvl(rows, modes):
            (k1, k2, d_, vl), vi, mode, r, T = _stack(rows, modes)
            out = velops.stacked_vel_scan_cgg_auto(
                k1, k2, d_, vl, vi, mode, machines, dyn_model_exp,
                drag_coeff, m_veh, float(const_gg[0]), float(const_gg[1]),
                kernels=kernels)
            return out.reshape(B, r, T + 1)

        def _brake_row(k_abs, e, v0):
            return (k_abs[:, :-1], k_abs[:, :-1], e[:, :-1], row_inf, v0)

        def _fwd_row(k_abs, e, v_bound, v0):
            return (k_abs[:, :-1], k_abs[:, :-1], e[:, :-1], v_bound[:, 1:],
                    torch.minimum(v_bound[:, 0], v0))

        def _bwd_row(k_abs, e, v_f):
            return (flip(k_abs[:, 1:]), flip(k_abs[:, :-1]), flip(e[:, :-1]),
                    flip(v_f[:, :-1]), v_f[:, -1])
    else:
        # per-row gg streams (kernel 5)
        def _lvl(rows, modes):
            per_step, vi, mode, r, T = _stack(rows, modes)
            out = velops.stacked_vel_scan_auto(
                *per_step, vi, mode, machines, dyn_model_exp, drag_coeff,
                m_veh, kernels=kernels)
            return out.reshape(B, r, T + 1)

        g0 = gg[:-1, 0].expand(B, P - 1)
        g1 = gg[:-1, 1].expand(B, P - 1)
        g0r = flip(gg[1:, 0]).expand(B, P - 1)
        g1r = flip(gg[1:, 1]).expand(B, P - 1)
        g0f = flip(gg[:-1, 0]).expand(B, P - 1)
        g1f = flip(gg[:-1, 1]).expand(B, P - 1)

        def _brake_row(k_abs, e, v0):
            return (k_abs[:, :-1], g0, g1, k_abs[:, :-1], g0, g1, e[:, :-1],
                    row_inf, v0)

        def _fwd_row(k_abs, e, v_bound, v0):
            return (k_abs[:, :-1], g0, g1, k_abs[:, :-1], g0, g1, e[:, :-1],
                    v_bound[:, 1:], torch.minimum(v_bound[:, 0], v0))

        def _bwd_row(k_abs, e, v_f):
            return (flip(k_abs[:, 1:]), g0r, g1r, flip(k_abs[:, :-1]), g0f,
                    g1f, flip(e[:, :-1]), flip(v_f[:, :-1]), v_f[:, -1])

    c_len = c_len.long()
    # ---- level 0: brake prefix per slot (none under sqp) -------------------
    if sqp:
        pref_idx = c_len[:, None].expand(B, 4)
        vel_start = vel_plan[:, None].expand(B, 4)
        v_decel = torch.zeros_like(el)
    else:
        prefix_active = vel_plan > (vel_max + 0.1)                # (B,)
        el_pref = torch.where(idx < c_len[:, None, None], 0.0, el)
        v_decel = _lvl([_brake_row(kabs[:, s], el_pref[:, s], vel_plan)
                        for s in range(4)], [velops.MODE_BRAKE] * 4)
        reach = v_decel <= vel_max
        first_reach = torch.argmax(reach.to(torch.int32), dim=2)
        first_reach = torch.where(torch.any(reach, dim=2), first_reach, P - 1)
        pref_idx = torch.where(prefix_active[:, None],
                               torch.maximum(first_reach, c_len[:, None]),
                               c_len[:, None])                    # (B, 4)
        vel_start = torch.where(prefix_active[:, None],
                                _at(v_decel, pref_idx), vel_plan[:, None])

    masked = idx < pref_idx[..., None]
    kabs_m = torch.abs(torch.where(masked, 0.0, kappa))
    el_m = torch.where(masked, 0.0, el)
    s4 = _cumsum0(el)                                             # (B, 4, P)

    # ---- normal bounds per slot --------------------------------------------
    spl_len = _at(s4, torch.clamp(n_valids - 1, 0, P - 1))        # (B, 4)
    cum = _cumsum(el[..., :-1])
    below = cum < (spl_len[..., None] - 5.0)
    v_idx_red = torch.argmin(below.to(torch.int32), dim=-1) + 1
    v_idx_red = torch.where((v_idx_red == 1) & (n_valids > 1), n_valids,
                            v_idx_red)
    v_idx = torch.where(red_len, v_idx_red, n_valids)             # (B, 4)

    qp_status = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    vx_sqp = torch.zeros_like(el)
    if sqp:
        # ---- the 4 normal-branch QPs and the follow QP of every scenario
        # over the fixed m-point window, one batched solve --------------------
        m = P if sqp_m is None else min(sqp_m, P)
        with cuda_graph.span("gltpl.sqp_window"):
            x0v = (torch.full_like(el, 20.0) if sqp_x0 is None
                   else sqp_x0)[..., :m]                          # (B, 4, m)
            cols4 = torch.cat([kappa[..., None], el[..., None],
                               gg.expand(B, 4, P, 2)], dim=-1)    # (B,4,P,4)
            win_n = _sqp_m_window(cols4, c_len[:, None], v_idx - pref_idx, m)
            win_f = _sqp_m_window(cols4[:, Fs], c_len,
                                  n_valids[:, Fs] - pref_idx[:, Fs], m)
            vmax_f = _sqp_follow_vmax(m, vel_max, v_obj, obj_dist, safety_d,
                                      veh_length, gg[0, 0], sqp_step)  # (B, m)
            win5 = torch.cat([win_n, win_f[:, None]], dim=1)
            gg5, v_end5 = _sqp_tire_end(win5, tire_end_idx, tire_end_mps2,
                                        veh_turn)
            vmax5 = torch.cat([vel_max.expand(B, 4, m), vmax_f[:, None]],
                              dim=1)
            vs5 = torch.cat([vel_start, vel_start[:, Fs:Fs + 1]], dim=1)
            x05 = torch.cat([x0v, x0v[:, Fs:Fs + 1]], dim=1)
        vx5, res5 = _sqp_profiles(win5, gg5, v_end5, vmax5, vs5, x05,
                                  machines, drag_coeff, m_veh, kernels)
        with cuda_graph.span("gltpl.sqp_handoff"):
            st5 = qp.qp_solver_status(res5)
            st_n, st_f = st5[:, :4], st5[:, 4]
            # infeasible solves zero; overtake slots also inaccurate ones
            is_ot = torch.arange(4, device=dev) >= 2
            zero_n = (st_n == -3) | (is_ot & (st_n == 2))
            vx_qn = torch.where(zero_n[..., None], 0.0, vx5[:, :4])
            vx_qf = torch.where((st_f == -3)[:, None], 0.0, vx5[:, 4])
            vx_normal = _place_back(vx_qn, c_len[:, None], P)     # (B, 4, P)
            vx_follow = _place_back(vx_qf, c_len, P)              # (B, P)
            follow_bound = torch.abs(_at(vx_follow, pref_idx[:, Fs])
                                     - vel_start[:, Fs]) < v_max_offset
            too_close = torch.zeros((B,), dtype=torch.bool, device=dev)
            is_follow4 = torch.arange(4, device=dev) == Fs
            qp_status = torch.where(is_follow4, st_f[:, None], st_n)
            vx_sqp = _sqp_store(torch.where(is_follow4[:, None],
                                            vx_qf[:, None], vx_qn), P)
    else:
        # ---- follow scalars (follow slot only) -----------------------------
        control_d = ctrl_cp * safety_d + veh_length
        safety_total = safety_d + veh_length
        too_close = (obj_dist - safety_total) < 0.0
        s_f = _cumsum0(el_m[:, Fs])                               # (B, P)
        s_stop = obj_dist - safety_total + opp_stop_dist
        stop_idx = torch.clamp(torch.sum(s_f < s_stop[:, None], dim=-1), 0,
                               P - 1)
        opp_vel_at = _runout_velocity(
            roll_vel, roll_cum,
            opp_stop_dist - ((obj_dist - safety_total + opp_stop_dist)
                             - (_at(s4[:, Fs], torch.clamp(n_valids[:, Fs] - 1,
                                                           0, P - 1))
                                - _at(s4[:, Fs], pref_idx[:, Fs]))))
        v_end_f = torch.where(s_stop > s_f[:, -1], opp_vel_at, 0.0)
        v_control = torch.minimum(torch.clamp(
            velops.follow_control_vel(ctrl, obj_dist, control_d, v_obj,
                                      vel_est, control_type), min=0.0),
            vel_max)

        v_end = torch.where(red_len, 0.0, v_end_rl)
        tail = idx >= v_idx[..., None] - 1
        el_n = torch.where(tail, 0.0, el_m)
        v_lat = torch.sqrt(gg[:, 1] / torch.clamp(kabs_m, min=1e-9))
        v0_n = torch.minimum(v_lat, vel_max)
        v0_n = torch.where(tail, torch.minimum(v0_n, v_end[..., None]), v0_n)
        v0_u = torch.minimum(v_lat[:, Fs], vel_max)

        # ---- level 1: ego brake (F) + unconstrained fwd (F) + normal fwd x4
        lvl1 = _lvl([_brake_row(kabs_m[:, Fs], el_m[:, Fs], vel_start[:, Fs]),
                     _fwd_row(kabs_m[:, Fs], el_m[:, Fs], v0_u,
                              vel_start[:, Fs])]
                    + [_fwd_row(kabs_m[:, s], el_n[:, s], v0_n[:, s],
                                vel_start[:, s]) for s in range(4)],
                    [velops.MODE_BRAKE, velops.MODE_FWD]
                    + [velops.MODE_FWD] * 4)
        v_ego_brake = lvl1[:, 0]
        vf_u = lvl1[:, 1]
        vf_n = lvl1[:, 2:]
        ego_stop_d = velops.stop_distance(v_ego_brake, el_m[:, Fs])

        seg1_active = (vel_start[:, Fs] > v_control) & (stop_idx >= 2)
        below_c = v_ego_brake <= v_control[:, None]
        idx_c_raw = torch.argmax(below_c.to(torch.int32), dim=-1)
        idx_c_raw = torch.where(torch.any(below_c, dim=-1), idx_c_raw,
                                stop_idx)
        idx_c = torch.where(seg1_active,
                            torch.minimum(torch.where(idx_c_raw == 0,
                                                      stop_idx, idx_c_raw),
                                          stop_idx),
                            torch.zeros_like(stop_idx))
        vx_control_start = torch.where(seg1_active, _at(v_ego_brake, idx_c),
                                       vel_start[:, Fs])

        el_seg2 = torch.where(idx < stop_idx[:, None], el_m[:, Fs], 0.0)
        el_seg2 = torch.where(idx < idx_c[:, None], 0.0, el_seg2)
        v0_s = torch.minimum(v_lat[:, Fs], v_control[:, None])
        v0_s = torch.where(idx >= stop_idx[:, None],
                           torch.minimum(v0_s, v_end_f[:, None]), v0_s)

        # ---- level 2: seg2 fwd (F) + unconstrained bwd (F) + normal bwd x4
        lvl2 = _lvl([_fwd_row(kabs_m[:, Fs], el_seg2, v0_s,
                              torch.minimum(vx_control_start, v_control)),
                     _bwd_row(kabs_m[:, Fs], el_m[:, Fs], vf_u)]
                    + [_bwd_row(kabs_m[:, s], el_n[:, s], vf_n[:, s])
                       for s in range(4)],
                    [velops.MODE_FWD, velops.MODE_BWD]
                    + [velops.MODE_BWD] * 4)
        vf_s = lvl2[:, 0]
        vx_compl = flip(lvl2[:, 1])
        vx_normal = flip(lvl2[:, 2:])                             # (B, 4, P)

        # ---- level 3: seg2 bwd ---------------------------------------------
        v_seg2 = flip(_lvl([_bwd_row(kabs_m[:, Fs], el_seg2, vf_s)],
                           [velops.MODE_BWD])[:, 0])

        # ---- follow assembly -----------------------------------------------
        follow_bound = torch.abs(_at(v_seg2, idx_c) - vx_control_start) \
            <= 1.0
        follow_bound &= ~((~seg1_active) & (stop_idx < 2))
        vx_follow = torch.where(idx < idx_c[:, None], v_ego_brake, v_seg2)
        vx_follow = torch.where(idx > stop_idx[:, None], 0.0, vx_follow)
        follow_bound &= torch.abs(vx_follow[:, 0] - vel_start[:, Fs]) <= 1.0
        cannot_hold = ego_stop_d >= s_stop
        vx_follow = torch.where(cannot_hold[:, None], v_ego_brake, vx_follow)
        follow_bound = torch.where(cannot_hold, True, follow_bound)
        vx_follow = torch.minimum(vx_follow, vx_compl)

    # ---- normal assembly per slot ------------------------------------------
    vx_normal = torch.where(idx >= v_idx[..., None], 0.0, vx_normal)
    degenerate = (v_idx - pref_idx) <= 1                          # (B, 4)
    vx_normal = torch.where(degenerate[..., None], 0.0, vx_normal)
    at_pref = _at(vx_normal, pref_idx)
    normal_bound = torch.abs(at_pref - vel_start) < v_max_offset
    normal_bound = torch.where(degenerate, False, normal_bound)

    # ---- select per slot + prefix + smoothing + acceleration ---------------
    is_follow = torch.arange(4, device=dev) == Fs
    vx_follow_sel = torch.where(red_len[:, Fs, None],
                                torch.minimum(vx_follow, vx_normal[:, Fs]),
                                vx_follow)
    vx_branch = torch.where(is_follow[None, :, None], vx_follow_sel[:, None],
                            vx_normal)
    vel_bound = torch.where(is_follow[None, :], follow_bound[:, None],
                            normal_bound)
    vx_full = torch.where(masked, v_decel, vx_branch)
    vx_full = torch.where(idx < c_len[:, None, None], vel_course[:, None, :],
                          vx_full)
    if filt_window > 1 and not sqp:
        vx_full = velops.conv_filt(vx_full, filt_window)
    ax = (vx_full[..., 1:] ** 2 - vx_full[..., :-1] ** 2) \
        / torch.clamp(2.0 * el[..., :-1], min=1e-9)
    ax = torch.where(el[..., :-1] > 1e-9, ax, 0.0)
    stationary = torch.isclose(vx_full[..., :-1], torch.zeros_like(ax)) \
        & torch.isclose(ax, torch.zeros_like(ax)) \
        & (idx[:-1] < n_valids[..., None] - 1)
    ax = torch.where(stationary, -5.0, ax)
    ax_f = torch.cat([ax, torch.zeros_like(ax[..., :1])], dim=-1)
    trajs = torch.stack([s4, paths[..., 0], paths[..., 1], paths[..., 2],
                         paths[..., 3], vx_full, ax_f], dim=-1)
    return dict(trajs=trajs, vel_bound=vel_bound, too_close=too_close,
                vx_sqp=vx_sqp, qp_status=qp_status)


def emergency_kernel(traj, gg, kernels: bool = True):
    """Emergency brake-to-stop profile on each trajectory (B, P, 7)
    [s x y psi kappa vx ax] with the hard-coded emergency vehicle
    constants; ``gg`` (P, 2) local gg."""
    el = traj[..., 1:, 0] - traj[..., :-1, 0]
    el = torch.cat([el, torch.zeros_like(el[..., :1])], dim=-1)
    v_brake = velops.calc_vel_profile_brake_auto(
        traj[..., 4], el, gg.expand(traj.shape[0], -1, -1), traj[:, 0, 5],
        1.0, EMERG_VEH_DRAGCOEFF, EMERG_VEH_MASS, kernels=kernels)
    a_brake = velops.calc_ax_profile(v_brake, el)
    a_brake = torch.cat([a_brake, torch.zeros_like(a_brake[..., :1])], dim=-1)
    return torch.cat([traj[..., 0:5], v_brake[..., None],
                      a_brake[..., None]], dim=-1)


def velocity_kernel(path, n_valid, gg, vel_course, c_len, vel_plan, vel_est,
                    vel_max, gg_scale, old_gg_scale, machines, v_max_offset,
                    is_follow, red_len, v_end_rl, obj_dist, v_obj, safety_d,
                    opp_stop_dist, roll_vel, roll_cum, veh_length, ctrl_cp,
                    ctrl_kd, ctrl_kp, ctrl_tanw, dyn_model_exp, drag_coeff,
                    m_veh, control_type: str = "PD", filt_window: int = 1,
                    vp_backend: str = "fb", sqp_x0=None, is_overtake=None,
                    veh_turn=7.0, tire_end_idx: int = 0, tire_end_mps2=5.0,
                    sqp_m: int = None, sqp_step=2.5, *,
                    kernels: bool = True):
    """Full velocity profile of R actions of one tick (OTH:736-941).

    Per action: ``path`` (R, P, 5) [x y psi kappa el] cut at the ego
    position, ``n_valid``, ``is_follow``, ``red_len``, ``v_end_rl``,
    ``obj_dist``, ``v_obj`` (R,) and the unscaled local gg (R, P, 2).
    Shared by the tick: ``vel_course`` (P,) and ``c_len`` (the committed
    delay-compensation course), ``roll_vel``/``roll_cum`` (F_CAP,) and the
    scalars, as 0-dim float32 tensors (``dyn_model_exp``, ``drag_coeff``,
    ``m_veh`` as floats).

    ``fb``: the eight recurrences of each action (brake prefix; follow's
    ego brake, segment-2 forward and backward and the unconstrained
    forward and backward; the normal forward and backward) run as four
    dependency levels of one stacked scan each, with per-step gg streams:
    kernel 5 on the card.

    ``sqp`` (the reference's VpSQP): no brake prefix; per action a normal
    QP over the ``v_idx``-cut slice and a follow QP with the pointwise
    opponent cap, each over the fixed ``sqp_m``-point window from the cut
    with the unscaled gg, the tire-end gg over the last ``tire_end_idx``
    points and the conservative terminal velocity; the 2R QPs as one
    batched solve (one ADMM kernel launch on the card); the status
    hand-off (infeasible solves zeroed, overtakes — ``is_overtake`` (R,)
    — also on inaccurate ones); ``too_close`` never raised; no smoothing.
    ``sqp_x0`` (R, P) warm-start profiles (None: 20 m/s); ``veh_turn``
    0-dim tensors, ``tire_end_mps2`` 0-dim or (R,); ``sqp_step`` the
    uniform spline step of the follow cap.

    :returns: dict(traj (R, P, 7) [s x y psi kappa vx ax], vel_bound (R,),
        too_close (R,), follow_v_control (R,), follow_control_d,
        vx_sqp (R, P) the raw profiles for the warm-start store and
        qp_status (R,) int32 — both zero for ``fb``)
    """
    R, P, _ = path.shape
    dev = path.device
    idx = torch.arange(P, device=dev)
    kappa = path[..., 3]
    el = path[..., 4]
    s = _cumsum0(el)
    gg_s = gg * gg_scale
    row_inf = torch.full((R, P - 1), math.inf, dtype=path.dtype, device=dev)
    kabs = torch.abs(kappa)
    ctrl = {"c_p": ctrl_cp, "k_d": ctrl_kd, "k_p": ctrl_kp, "tan_w": ctrl_tanw}
    flip = lambda x: torch.flip(x, dims=[-1])                 # noqa: E731
    vel_plan_r = vel_plan.expand(R)
    sqp = vp_backend == "sqp"
    if not sqp and vp_backend != "fb":
        raise ValueError(f"unknown velocity backend {vp_backend!r}")

    def _lvl(rows, modes):
        cols = list(zip(*rows))
        n = len(rows)
        per_step = [torch.stack(c, dim=1).reshape(R * n, P - 1)
                    for c in cols[:-1]]
        v_init = torch.stack(cols[-1], dim=1).reshape(R * n)
        mode = cuda_graph.const_vector(modes, torch.int32, dev).repeat(R)
        out = velops.stacked_vel_scan_auto(
            *per_step[:8], v_init, mode, machines, dyn_model_exp, drag_coeff,
            m_veh, kernels=kernels)
        return out.reshape(R, n, P)

    def _brake_row(k_abs, g, e, v0):
        z = k_abs[:, :-1]
        return (z, g[:, :-1, 0], g[:, :-1, 1], z, g[:, :-1, 0], g[:, :-1, 1],
                e[:, :-1], row_inf, v0)

    def _fwd_row(k_abs, g, e, v_bound, v0):
        z = k_abs[:, :-1]
        return (z, g[:, :-1, 0], g[:, :-1, 1], z, g[:, :-1, 0], g[:, :-1, 1],
                e[:, :-1], v_bound[:, 1:], torch.minimum(v_bound[:, 0], v0))

    def _bwd_row(k_abs, g, e, v_f):
        return (flip(k_abs[:, 1:]), flip(g[:, 1:, 0]), flip(g[:, 1:, 1]),
                flip(k_abs[:, :-1]), flip(g[:, :-1, 0]), flip(g[:, :-1, 1]),
                flip(e[:, :-1]), flip(v_f[:, :-1]), v_f[:, -1])

    vel_idx = c_len.long()
    # ---- follow-mode control law -------------------------------------------
    control_d = ctrl_cp * safety_d + veh_length
    safety_total = safety_d + veh_length
    v_control = torch.minimum(torch.clamp(
        velops.follow_control_vel(ctrl, obj_dist, control_d, v_obj, vel_est,
                                  control_type), min=0.0), vel_max)

    # ---- normal-branch end -------------------------------------------------
    spl_len = _at(s, torch.clamp(n_valid - 1, 0, P - 1))
    cum = _cumsum(el[:, :-1])
    below = cum < (spl_len[:, None] - 5.0)
    v_idx_red = torch.argmin(below.to(torch.int32), dim=-1) + 1
    v_idx_red = torch.where((v_idx_red == 1) & (n_valid > 1), n_valid,
                            v_idx_red)
    v_idx = torch.where(red_len, v_idx_red, n_valid)

    qp_status = torch.zeros((R,), dtype=torch.int32, device=dev)
    vx_sqp = torch.zeros_like(el)
    if sqp:
        # ---- the profile starts at the delay-compensation cut from vel_plan
        pref_idx = vel_idx.expand(R)
        vel_start = vel_plan_r
        v_decel = torch.zeros_like(el)
        masked = idx < pref_idx[:, None]
        m = P if sqp_m is None else min(sqp_m, P)
        with cuda_graph.span("gltpl.sqp_window"):
            x0v = (torch.full_like(el, 20.0) if sqp_x0 is None
                   else sqp_x0)[:, :m]
            # unscaled gg: the reference applies gg_scale through fb only
            cols = torch.stack([kappa, el, gg[..., 0], gg[..., 1]], dim=-1)
            win_n = _sqp_m_window(cols, pref_idx, v_idx - pref_idx, m)
            win_f = _sqp_m_window(cols, pref_idx, n_valid - pref_idx, m)
            vmax_f = _sqp_follow_vmax(m, vel_max, v_obj, obj_dist, safety_d,
                                      veh_length, gg[:, 0, 0], sqp_step)
            win2 = torch.stack([win_n, win_f])
            gg2, v_end2 = _sqp_tire_end(win2, tire_end_idx, tire_end_mps2,
                                        veh_turn)
            vmax2 = torch.stack([vel_max.expand(R, m), vmax_f])
            x02 = torch.stack([x0v, x0v])
        vx2, res2 = _sqp_profiles(win2, gg2, v_end2, vmax2,
                                  vel_start.expand(2, R), x02, machines,
                                  drag_coeff, m_veh, kernels)
        with cuda_graph.span("gltpl.sqp_handoff"):
            st2 = qp.qp_solver_status(res2)
            st_n, st_f = st2[0], st2[1]
            ot = (torch.zeros_like(is_follow) if is_overtake is None
                  else is_overtake)
            zero_n = (st_n == -3) | (ot & (st_n == 2))
            vx_qn = torch.where(zero_n[:, None], 0.0, vx2[0])
            vx_qf = torch.where((st_f == -3)[:, None], 0.0, vx2[1])
            vx_normal = _place_back(vx_qn, pref_idx, P)
            vx_follow = _place_back(vx_qf, pref_idx, P)
            too_close = torch.zeros((R,), dtype=torch.bool, device=dev)
            follow_bound = torch.abs(_at(vx_follow, pref_idx) - vel_start) \
                < v_max_offset
            qp_status = torch.where(is_follow, st_f, st_n)
            vx_sqp = _sqp_store(torch.where(is_follow[:, None], vx_qf, vx_qn),
                                P)
    else:
        # ---- level 0: brake prefix to a lowered v_max ----------------------
        prefix_active = vel_plan > (vel_max + 0.1)
        el_pref = torch.where(idx < vel_idx, 0.0, el)
        gg_old = gg * old_gg_scale
        v_decel = _lvl([_brake_row(kabs, gg_old, el_pref, vel_plan_r)],
                       [velops.MODE_BRAKE])[:, 0]                 # (R, P)
        reach = v_decel <= vel_max
        first_reach = torch.argmax(reach.to(torch.int32), dim=-1)
        first_reach = torch.where(torch.any(reach, dim=-1), first_reach,
                                  P - 1)
        pref_idx = torch.where(prefix_active,
                               torch.maximum(first_reach, vel_idx), vel_idx)
        vel_start = torch.where(prefix_active, _at(v_decel, pref_idx),
                                vel_plan)

        masked = idx < pref_idx[:, None]
        kabs_m = torch.abs(torch.where(masked, 0.0, kappa))
        el_m = torch.where(masked, 0.0, el)

        # ---- follow-mode scalars -------------------------------------------
        too_close = (obj_dist - safety_total) < 0.0
        s_f = _cumsum0(el_m)
        s_stop = obj_dist - safety_total + opp_stop_dist
        stop_idx = torch.clamp(torch.sum(s_f < s_stop[:, None], dim=-1), 0,
                               P - 1)
        opp_vel_at = _runout_velocity(
            roll_vel.expand(R, -1), roll_cum.expand(R, -1),
            opp_stop_dist - ((obj_dist - safety_total + opp_stop_dist)
                             - (_at(s, torch.clamp(n_valid - 1, 0, P - 1))
                                - _at(s, pref_idx))))
        v_end_f = torch.where(s_stop > s_f[:, -1], opp_vel_at, 0.0)

        # ---- normal-branch bounds ------------------------------------------
        v_end = torch.where(red_len, 0.0, v_end_rl)
        tail = idx >= v_idx[:, None] - 1
        el_n = torch.where(tail, 0.0, el_m)
        v_lat = torch.sqrt(gg_s[..., 1] / torch.clamp(kabs_m, min=1e-9))
        v0_u = torch.minimum(v_lat, vel_max)
        v0_n = torch.where(tail, torch.minimum(v0_u, v_end[:, None]), v0_u)

        # ---- level 1: ego brake + unconstrained fwd + normal fwd -----------
        lvl1 = _lvl([_brake_row(kabs_m, gg_s, el_m, vel_start),
                     _fwd_row(kabs_m, gg_s, el_m, v0_u, vel_start),
                     _fwd_row(kabs_m, gg_s, el_n, v0_n, vel_start)],
                    [velops.MODE_BRAKE, velops.MODE_FWD, velops.MODE_FWD])
        v_ego_brake, vf_u, vf_n = lvl1[:, 0], lvl1[:, 1], lvl1[:, 2]
        ego_stop_d = velops.stop_distance(v_ego_brake, el_m)

        # follow segment-1 hand-off
        seg1_active = (vel_start > v_control) & (stop_idx >= 2)
        below_c = v_ego_brake <= v_control[:, None]
        idx_c_raw = torch.argmax(below_c.to(torch.int32), dim=-1)
        idx_c_raw = torch.where(torch.any(below_c, dim=-1), idx_c_raw,
                                stop_idx)
        idx_c = torch.where(seg1_active,
                            torch.minimum(torch.where(idx_c_raw == 0,
                                                      stop_idx, idx_c_raw),
                                          stop_idx),
                            torch.zeros_like(stop_idx))
        vx_control_start = torch.where(seg1_active, _at(v_ego_brake, idx_c),
                                       vel_start)
        el_seg2 = torch.where(idx < stop_idx[:, None], el_m, 0.0)
        el_seg2 = torch.where(idx < idx_c[:, None], 0.0, el_seg2)
        v0_s = torch.minimum(v_lat, v_control[:, None])
        v0_s = torch.where(idx >= stop_idx[:, None],
                           torch.minimum(v0_s, v_end_f[:, None]), v0_s)

        # ---- level 2: seg2 fwd + unconstrained bwd + normal bwd ------------
        lvl2 = _lvl([_fwd_row(kabs_m, gg_s, el_seg2, v0_s,
                              torch.minimum(vx_control_start, v_control)),
                     _bwd_row(kabs_m, gg_s, el_m, vf_u),
                     _bwd_row(kabs_m, gg_s, el_n, vf_n)],
                    [velops.MODE_FWD, velops.MODE_BWD, velops.MODE_BWD])
        vf_s = lvl2[:, 0]
        vx_compl = flip(lvl2[:, 1])
        vx_normal = flip(lvl2[:, 2])

        # ---- level 3: seg2 bwd ---------------------------------------------
        v_seg2 = flip(_lvl([_bwd_row(kabs_m, gg_s, el_seg2, vf_s)],
                           [velops.MODE_BWD])[:, 0])

        # ---- follow assembly -----------------------------------------------
        follow_bound = torch.abs(_at(v_seg2, idx_c) - vx_control_start) \
            <= 1.0
        follow_bound &= ~((~seg1_active) & (stop_idx < 2))
        vx_follow = torch.where(idx < idx_c[:, None], v_ego_brake, v_seg2)
        vx_follow = torch.where(idx > stop_idx[:, None], 0.0, vx_follow)
        follow_bound &= torch.abs(vx_follow[:, 0] - vel_start) <= 1.0
        cannot_hold = ego_stop_d >= s_stop
        vx_follow = torch.where(cannot_hold[:, None], v_ego_brake, vx_follow)
        follow_bound = torch.where(cannot_hold, True, follow_bound)
        vx_follow = torch.minimum(vx_follow, vx_compl)

    # ---- normal assembly ---------------------------------------------------
    vx_normal = torch.where(idx >= v_idx[:, None], 0.0, vx_normal)
    degenerate = (v_idx - pref_idx) <= 1
    vx_normal = torch.where(degenerate[:, None], 0.0, vx_normal)
    normal_bound = torch.abs(_at(vx_normal, pref_idx) - vel_start) \
        < v_max_offset
    normal_bound = torch.where(degenerate, False, normal_bound)

    # ---- select / merge, then the course, the prefix and the branch --------
    use_normal = ~is_follow
    use_merge = is_follow & red_len
    vx_branch = torch.where(
        use_normal[:, None], vx_normal,
        torch.where(use_merge[:, None], torch.minimum(vx_follow, vx_normal),
                    vx_follow))
    vel_bound = torch.where(use_normal, normal_bound, follow_bound)
    vx_full = torch.where(idx < vel_idx, vel_course,
                          torch.where(masked, v_decel, vx_branch))
    # the reference smooths the fb profiles only
    vx_f = vx_full if sqp else velops.conv_filt(vx_full, filt_window)
    ax = velops.calc_ax_profile(vx_f, el)
    stationary = torch.isclose(vx_f[:, :-1], torch.zeros_like(ax)) \
        & torch.isclose(ax, torch.zeros_like(ax)) \
        & (idx[:-1] < n_valid[:, None] - 1)
    ax = torch.where(stationary, -5.0, ax)
    ax_f = torch.cat([ax, torch.zeros_like(ax[:, :1])], dim=-1)
    traj = torch.stack([s, path[..., 0], path[..., 1], path[..., 2],
                        path[..., 3], vx_f, ax_f], dim=-1)
    return dict(traj=traj, vel_bound=vel_bound, too_close=too_close,
                follow_v_control=v_control, follow_control_d=control_d,
                vx_sqp=vx_sqp, qp_status=qp_status)


def brake_on_backup_kernel(path, n_valid, gg, vel_course, c_len, vel_plan,
                           dyn_model_exp, drag_coeff, m_veh,
                           kernels: bool = True):
    """Recursive-infeasibility fallback: full deceleration on the backup
    path (OTH:950-1006, VpForwardBackward.calc_vel_brake_em — no gg
    scale).  ``path`` (P, 5), ``gg`` (P, 2), ``vel_course`` (P,); returns
    (P, 7) [s x y psi kappa vx ax].  The brake row is kernel 5 on the
    card."""
    P = path.shape[0]
    idx = torch.arange(P, device=path.device)
    kappa = path[:, 3]
    el = path[:, 4]
    el_m = torch.where(idx < c_len, 0.0, el)
    vx = velops.calc_vel_profile_brake_auto(
        kappa[None], el_m[None], gg[None], vel_plan.reshape(1),
        dyn_model_exp, drag_coeff, m_veh, kernels=kernels)[0]
    vx_full = torch.where(idx < c_len, vel_course, vx)
    ax = velops.calc_ax_profile(vx_full, el)
    stationary = torch.isclose(vx_full[:-1], torch.zeros_like(ax)) \
        & torch.isclose(ax, torch.zeros_like(ax)) & (idx[:-1] < n_valid - 1)
    ax = torch.where(stationary, -5.0, ax)
    ax_f = torch.cat([ax, torch.zeros_like(ax[:1])])
    s = _cumsum0(el)
    return torch.stack([s, path[:, 0], path[:, 1], path[:, 2], path[:, 3],
                        vx_full, ax_f], dim=-1)


def brake_em_sqp_kernel(path, n_valid, gg, vel_course, c_len, vel_plan,
                        machines, veh_turn, tire_end_mps2, drag_coeff, m_veh,
                        sqp_m: int = None, kernels: bool = True):
    """SQP-mode recursive-infeasibility fallback, the reference's
    ``VpSQP.calc_vel_brake_em`` on the handler's backup ladder: the
    ``sqp_m``-point window from the delay-compensation cut solved as a QP
    with a 1 m/s cap, the conservative terminal velocity and a linear
    ``vel_plan`` -> 1 m/s initial guess; no smoothing.  ``path`` (P, 5),
    ``gg`` (P, 2) unscaled, ``vel_course`` (P,); ``vel_plan``,
    ``veh_turn``, ``tire_end_mps2`` 0-dim tensors.  Returns (P, 7)
    [s x y psi kappa vx ax]; the solve is one ADMM kernel launch on the
    card."""
    P = path.shape[0]
    dev = path.device
    idx = torch.arange(P, device=dev)
    kappa = path[:, 3]
    el = path[:, 4]
    m = P if sqp_m is None else min(sqp_m, P)
    cols = torch.stack([kappa, el, gg[:, 0], gg[:, 1]], dim=-1)
    c_len = cuda_graph.as_tensor(c_len, device=dev).long()
    win = _sqp_m_window(cols, c_len, n_valid - c_len, m)
    v_end = torch.sqrt(tire_end_mps2 * veh_turn)
    # linear vel_plan -> 1 m/s deceleration guess
    x0 = vel_plan + torch.arange(m, device=dev).to(path.dtype) \
        * (1.0 - vel_plan) / m
    vx_m, _ = qp.qp_vel_profile(
        win[:, 0], win[:, 1], win[:, 2:4], machines,
        torch.ones((m,), dtype=path.dtype, device=dev), vel_plan,
        v_end=v_end, end_idx=m, drag_coeff=drag_coeff, m_veh=m_veh,
        pin_idx=0, x0_v=x0, kernels=kernels)
    vx_full = _place_back(vx_m, c_len, P)
    vx_full = torch.where(idx < c_len, vel_course, vx_full)
    ax = velops.calc_ax_profile(vx_full, el)
    stationary = torch.isclose(vx_full[:-1], torch.zeros_like(ax)) \
        & torch.isclose(ax, torch.zeros_like(ax)) & (idx[:-1] < n_valid - 1)
    ax = torch.where(stationary, -5.0, ax)
    ax_f = torch.cat([ax, torch.zeros_like(ax[:1])])
    s = _cumsum0(el)
    return torch.stack([s, path[:, 0], path[:, 1], path[:, 2], path[:, 3],
                        vx_full, ax_f], dim=-1)
