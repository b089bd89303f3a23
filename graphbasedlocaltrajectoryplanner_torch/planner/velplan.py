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

from types import SimpleNamespace

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_prefix
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_projection
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velstage as vstage
from graphbasedlocaltrajectoryplanner_torch.ops import dynshift
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


def _cumsum(x, *, kernels: bool = True):
    """Inclusive cumulative sum along the last axis in the summation order
    of the reference's cumsum on the CPU (``ops/cuda_prefix``): with
    ``kernels`` one launch of the prefix-sum kernel on a CUDA tensor, else
    (and on the CPU) the plain version."""
    return (cuda_prefix.blocked_cumsum if kernels
            else cuda_prefix.blocked_cumsum_plain)(x)


def _cumsum0(x, *, kernels: bool = True):
    """Cumulative sum along the last axis with a leading zero, dropping the
    last element: ``[0, x0, x0+x1, ...]`` of the same length (one kernel
    launch with ``kernels`` on a CUDA tensor)."""
    return (cuda_prefix.blocked_cumsum if kernels
            else cuda_prefix.blocked_cumsum_plain)(x[..., :-1],
                                                   leading_zero=True)


def opponent_summary(glob_rl, glob_el, obj_pos, v_obj, dyn_model_exp,
                     drag_coeff, m_veh, f_cap: int = F_CAP,
                     kernels: bool = True):
    """Opponent stopping behaviour on the global raceline, per scenario.

    :param glob_rl: (F, 5) fine raceline [s, x, y, kappa, vel];
        ``glob_el`` (F,); ``obj_pos`` (B, 2); ``v_obj`` (B,).
    :returns: (opp_stop_dist (B,), roll_vel (B, f_cap), roll_el (B, f_cap),
               roll_cum (B, f_cap))."""
    F = glob_rl.shape[0]
    project = (cuda_projection.get_s_coords if kernels
               else cuda_projection.get_s_coords_plain)
    ((_, (idx_a, _)),) = project(glob_rl[:, 1:3], (obj_pos,), glob_rl[:, 0],
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
    return opp_stop_dist, vel_r, el_r, _cumsum(el_r, kernels=kernels)


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


def _place_back(vx_m, shift, P: int):
    """m-grid profiles (..., m) back on the padded path rows ``shift + i``;
    rows beyond the window zero."""
    pad = torch.zeros(vx_m.shape[:-1] + (P - vx_m.shape[-1],),
                      dtype=vx_m.dtype, device=vx_m.device)
    return dynshift.shift_rows_down(torch.cat([vx_m, pad], dim=-1)[..., None],
                                    shift, 64)[..., 0]


def _follow_control(ctrl_cp, ctrl_kd, ctrl_kp, ctrl_tanw, safety_d,
                    veh_length, obj_dist, v_obj, vel_est, vel_max,
                    control_type: str):
    """The follow mode's control law: (control_d, the velocity it holds
    behind the opponent, at most ``vel_max``)."""
    ctrl = {"c_p": ctrl_cp, "k_d": ctrl_kd, "k_p": ctrl_kp, "tan_w": ctrl_tanw}
    control_d = ctrl_cp * safety_d + veh_length
    v_control = torch.minimum(torch.clamp(
        velops.follow_control_vel(ctrl, obj_dist, control_d, v_obj, vel_est,
                                  control_type), min=0.0), vel_max)
    return control_d, v_control


def _scan(const_gg, machines, dyn_model_exp, drag_coeff, m_veh, kernels):
    """The stacked-recurrence scan of :func:`_lvl`: the constant-gg
    instance for ``const_gg`` = (ax, ay) (rows without gg streams), else
    per-row gg streams (kernel 5 on the card)."""
    if const_gg is None:
        return lambda *c: velops.stacked_vel_scan_auto(
            *c, machines, dyn_model_exp, drag_coeff, m_veh, kernels=kernels)
    ax, ay = float(const_gg[0]), float(const_gg[1])
    return lambda *c: velops.stacked_vel_scan_cgg_auto(
        *c, machines, dyn_model_exp, drag_coeff, m_veh, ax, ay,
        kernels=kernels)


def _lvl(level, scan):
    """One dependency level (``cuda_velstage.level*_plain``'s rows and
    modes): the r rows stacked to N x r rows of one scan launch.  Returns
    (N, r, P)."""
    rows, modes = level
    N, T = rows[0][0].shape
    return scan(*vstage.stack_rows(rows, modes)).reshape(N, len(rows), T + 1)


def _fb_profiles(kappa, el, s, n_valid, v_idx, red_len, v_end_rl, c_len,
                 vel_plan, vel_max, ay, gg_pref, gg, fs: int, v_control,
                 obj_dist, safety_d, veh_length, opp_stop_dist, roll_vel,
                 roll_cum, idx, scan, kernels: bool):
    """The fb backend on N groups of k paths (a scenario's slots, or one
    action's path), the follow profile on each group's path ``fs``: every
    path's brake prefix (level 0), then the follow's ego brake, segment-2
    forward and backward and unconstrained forward and backward beside
    every path's normal forward and backward, as three more levels of one
    stacked scan each (2k + 5 rows a group); the glue between the levels
    is ``ops/cuda_velstage``'s plain version.

    :param kappa, el, s: (N, k, P); ``n_valid``, ``v_idx``, ``red_len``,
        ``v_end_rl`` (N, k); ``c_len``, ``vel_plan``, ``v_control``,
        ``obj_dist`` (N,); ``roll_vel``, ``roll_cum`` (N, F_CAP); ``ay``
        broadcast against (N, k, P); ``gg_pref`` (the brake prefix's) and
        ``gg`` the rows' gg streams, both None for the constant-gg scan.
    :returns: (pref_idx, vel_start (N, k), v_decel, masked, vx_normal
        (N, k, P), qp_status (N, k), vx_sqp (N, k, P) (both zero),
        vx_follow (N, P), follow_bound, too_close (N,)).
    """
    N, k, P = el.shape
    g = SimpleNamespace(
        kappa=kappa, el=el, s=s, n_valid=n_valid, v_idx=v_idx,
        red_len=red_len, v_end_rl=v_end_rl, c_len=c_len, vel_plan=vel_plan,
        vel_max=vel_max, ay=ay, gg_pref=gg_pref, gg=gg, fs=fs,
        v_control=v_control, obj_dist=obj_dist, safety_d=safety_d,
        veh_length=veh_length, opp_stop_dist=opp_stop_dist,
        roll_vel=roll_vel, roll_cum=roll_cum, idx=idx)
    v_decel = _lvl(vstage.level0_plain(g), scan)                # (N, k, P)
    vstage.slots_plain(g, v_decel)
    vstage.slot_tensors_plain(g)
    lvl1 = _lvl(vstage.level1_plain(g), scan)
    vstage.follow_plain(g, lvl1, _cumsum0(g.ef, kernels=kernels))
    lvl2 = _lvl(vstage.level2_plain(g, lvl1), scan)
    lvl3 = _lvl(vstage.level3_plain(g, lvl2), scan)
    vx_normal, vx_follow, follow_bound = vstage.assembly_plain(g, lvl1, lvl2,
                                                           lvl3)
    return (g.pref_idx, g.vel_start, v_decel, g.masked, vx_normal,
            torch.zeros((N, k), dtype=torch.int32, device=el.device),
            torch.zeros_like(el), vx_follow, follow_bound, g.too_close)


def _fb_kernels(paths, s4, n_valids, red_len, v_end_rl, c_len, vel_plan,
                vel_max, ay, v_control, obj_dist, safety_d, veh_length,
                opp_stop_dist, roll_vel, roll_cum, fs: int, vel_course,
                v_max_offset, scan):
    """The fb backend and the stage's tail through the glue kernels of
    ``ops/cuda_velstage`` (constant-gg rows on the card): each level's rows
    written by one launch and scanned by another, the follow path's masked
    arc lengths summed from level 1's rows, then one epilogue launch.
    Returns (trajs, vel_bound, too_close)."""
    common = (paths, s4, n_valids, red_len, v_end_rl, c_len, vel_plan,
              vel_max, ay, v_control, obj_dist, safety_d, veh_length,
              opp_stop_dist, roll_vel, roll_cum, fs)
    N, k, P = paths.shape[:3]
    lv0 = scan(*vstage.fb_level(0, *common))
    *rows, pref_idx, vel_start, v_idx = vstage.fb_level(1, *common, lv=lv0)
    lv1 = scan(*rows)
    # the ego brake row's element lengths are the follow path's masked ones
    s_f = cuda_prefix.blocked_cumsum(rows[2].view(N, k + 2, P - 1)[:, 0],
                                     leading_zero=True)
    slots = (pref_idx, vel_start, v_idx)
    *rows, = vstage.fb_level(2, *common, lv=lv1, s_f=s_f, slots=slots)
    follow = tuple(rows[6:])
    lv2 = scan(*rows[:6])
    lv3 = scan(*vstage.fb_level(3, *common, lv=lv2, slots=slots,
                                follow=follow))
    trajs, vel_bound = vstage.epilogue(
        paths, s4, n_valids, c_len, vel_course, red_len, v_max_offset, fs,
        v_idx, pref_idx, vel_start, lv0=lv0, lv1=lv1, lv2=lv2, lv3=lv3,
        follow=follow)
    return trajs, vel_bound, follow[vstage.FOLLOW_STATE.index("too_close")]


def _sqp_qps(kappa, el, gg, n_valid, v_idx, c_len, vel_plan, vel_max,
             v_max_offset, fs: int, is_follow, overtake, obj_dist, v_obj,
             safety_d, veh_length, x0, veh_turn, tire_end_idx: int,
             tire_end_mps2, sqp_m, sqp_step, machines, drag_coeff, m_veh, idx,
             kernels: bool):
    """The sqp backend (the reference's VpSQP) on the paths of
    :func:`_fb_profiles`: no brake prefix; each path's normal QP over its
    ``v_idx``-cut slice and the follow QP with the pointwise opponent cap,
    over the fixed ``sqp_m``-point window from the cut with the unscaled
    ``gg`` (N, P, 2), the tire-end gg over the last ``tire_end_idx`` points
    and the conservative terminal velocity, all N (k + 1) as one batched
    solve (one ADMM kernel launch on the card); then the status hand-off:
    infeasible solves zeroed, the normal ones of ``overtake`` paths also
    inaccurate ones; ``too_close`` never raised.  ``x0`` (N, k, P) the warm
    start (None: 20 m/s); ``tire_end_mps2`` 0-dim or (N,); ``is_follow``
    (broadcast against (N, k)) picks the follow QP's status and profile for
    the store.  Returns as :func:`_fb_profiles`.
    """
    N, k, P = el.shape
    dev = el.device
    m = P if sqp_m is None else min(sqp_m, P)
    pref_idx = c_len[:, None].expand(N, k)
    vel_start = vel_plan[:, None].expand(N, k)
    with cuda_graph.span("gltpl.sqp_window"):
        x0v = (torch.full_like(el, 20.0) if x0 is None else x0)[..., :m]
        cols = torch.cat([kappa[..., None], el[..., None],
                          gg[:, None].expand(N, k, P, 2)], dim=-1)
        win_n = _sqp_m_window(cols, c_len[:, None], v_idx - pref_idx, m)
        win_f = _sqp_m_window(cols[:, fs], c_len, n_valid[:, fs] - c_len, m)
        vmax_f = _sqp_follow_vmax(m, vel_max, v_obj, obj_dist, safety_d,
                                  veh_length, gg[:, 0, 0], sqp_step)  # (N, m)
        win = torch.cat([win_n, win_f[:, None]], dim=1)       # (N, k+1, m, 4)
        tire = cuda_graph.as_tensor(tire_end_mps2, el.dtype, dev)[..., None]
        in_tire = torch.arange(m, device=dev) >= m - tire_end_idx
        gg_w = torch.where(in_tire[:, None], tire[..., None, None],
                           win[..., 2:4])
        v_end = torch.sqrt(tire * cuda_graph.as_tensor(veh_turn, el.dtype,
                                                       dev))
        vmax = torch.cat([vel_max.expand(N, k, m), vmax_f[:, None]], dim=1)
        vs = torch.cat([vel_start, vel_start[:, fs:fs + 1]], dim=1)
        x0w = torch.cat([x0v, x0v[:, fs:fs + 1]], dim=1)
    vx, res = qp.qp_vel_profile(
        win[..., 0], win[..., 1], gg_w, machines, vmax, vs, v_end=v_end,
        end_idx=m, drag_coeff=drag_coeff, m_veh=m_veh, pin_idx=0, x0_v=x0w,
        kernels=kernels)
    with cuda_graph.span("gltpl.sqp_handoff"):
        st = qp.qp_solver_status(res)
        st_n, st_f = st[:, :k], st[:, k:]                 # (N, k), (N, 1)
        zero_n = (st_n == -3) | (overtake & (st_n == 2))
        vx_qn = torch.where(zero_n[..., None], 0.0, vx[:, :k])
        vx_qf = torch.where((st_f == -3)[..., None], 0.0, vx[:, k:])
        shift = c_len[:, None]
        vx_follow = _place_back(vx_qf, shift, P)                  # (N, 1, P)
        follow_bound = torch.abs(vstage.at(vx_follow, shift)
                                 - vel_plan[:, None]) < v_max_offset
        # the warm-start store: the m grid values, the last repeated to P
        vx_sqp = torch.where(is_follow[..., None], vx_qf, vx_qn)
        vx_sqp = torch.cat([vx_sqp, vx_sqp[..., -1:].expand(
            N, k, P - m)], dim=-1)
        return (pref_idx, vel_start, torch.zeros_like(el),
                idx < pref_idx[..., None], _place_back(vx_qn, shift, P),
                torch.where(is_follow, st_f, st_n), vx_sqp, vx_follow[:, 0],
                follow_bound[:, 0],
                torch.zeros((N,), dtype=torch.bool, device=dev))


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
                            s4=None, kernels: bool = True):
    """Slot-specialized velocity stage for a batch of scenarios.  The first
    ``c_len`` rows keep the committed ``vel_course`` and replanning starts
    from ``vel_plan``.

    ``fb``: the follow solver runs only for the follow slot (13 recurrence
    rows per scenario over 4 dependency levels, :func:`_fb_profiles`) — on
    the kernel's constant-gg instance with ``const_gg``, else with per-row
    gg streams from ``gg`` (kernel 5 on the card).

    ``sqp``: the reference's SQP planner at fleet scale
    (:func:`_sqp_qps`) — the 4 normal-branch QPs of a scenario and its
    follow QP, all 5B as one batched ADMM solve; overtake slots (2 and 3)
    also zeroed on inaccurate solves; no smoothing.

    ``filt_window`` > 1 smooths every fb profile with the moving average
    of ``ops/velocity.conv_filt`` (the handler's smoothing; ignored under
    ``sqp``, as the reference filters only the fb planner's profiles).

    On the card with the kernels the glue around the recurrences is
    ``ops/cuda_velstage``'s kernels: under ``fb`` with ``const_gg`` and no
    smoothing each level's rows come from one launch and the tail from one
    more (:func:`_fb_kernels`), under ``sqp`` the tail; elsewhere (the CPU,
    ``kernels=False``, gg streams, ``filt_window`` > 1) their plain
    versions run, with the same results.

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
    :param s4: (B, 4, P) the arc lengths ``_cumsum0(paths[..., 4])`` where
        the caller has them (None: computed here).
    :returns: dict(trajs (B, 4, P, 7), vel_bound (B, 4), too_close (B,),
        vx_sqp (B, 4, P), qp_status (B, 4) int32; the last two zero for
        ``fb``).
    """
    Fs = follow_slot
    B, _, P, _ = paths.shape
    dev = paths.device
    sqp = vp_backend == "sqp"
    if not sqp and vp_backend != "fb":
        raise ValueError(f"unknown velocity backend {vp_backend!r}")
    c_len = c_len.long()
    if s4 is None:
        s4 = _cumsum0(paths[..., 4], kernels=kernels)             # (B, 4, P)
    # the glue kernels of ops/cuda_velstage: on the card with the kernels,
    # for the constant-gg fb rows or the sqp profiles, unsmoothed
    glue = kernels and dev.type != "cpu" and (
        sqp or (const_gg is not None and filt_window == 1))
    tail = dict(paths=paths, s=s4, n_valid=n_valids, c_len=c_len,
                vel_course=vel_course, red_len=red_len,
                v_max_offset=v_max_offset, fs=Fs)
    if not sqp:
        _, v_control = _follow_control(ctrl_cp, ctrl_kd, ctrl_kp, ctrl_tanw,
                                       safety_d, veh_length, obj_dist, v_obj,
                                       vel_est, vel_max, control_type)
        scan = _scan(const_gg, machines, dyn_model_exp, drag_coeff, m_veh,
                     kernels)
        zeros = (torch.zeros((B, 4), dtype=torch.int32, device=dev),
                 torch.zeros((B, 4, P), dtype=paths.dtype, device=dev))
    if glue and not sqp:
        trajs, vel_bound, too_close = _fb_kernels(
            paths, s4, n_valids, red_len, v_end_rl, c_len, vel_plan,
            vel_max, gg[:, 1], v_control, obj_dist, safety_d, veh_length,
            opp_stop_dist, roll_vel, roll_cum, Fs, vel_course, v_max_offset,
            scan)
        return dict(trajs=trajs, vel_bound=vel_bound, too_close=too_close,
                    vx_sqp=zeros[1], qp_status=zeros[0])
    idx = torch.arange(P, device=dev)
    kappa = paths[..., 3]
    el = paths[..., 4]                                        # (B, 4, P)
    v_idx = vstage.end_index(s4, n_valids, red_len)               # (B, 4)
    gg_b = gg.expand(B, P, 2)
    if sqp:
        (pref_idx, vel_start, v_decel, _, vx_normal, qp_status, vx_sqp,
         vx_follow, follow_bound, too_close) = _sqp_qps(
            kappa, el, gg_b, n_valids, v_idx, c_len, vel_plan, vel_max,
            v_max_offset, Fs, torch.arange(4, device=dev) == Fs,
            torch.arange(4, device=dev) >= 2, obj_dist, v_obj, safety_d,
            veh_length, sqp_x0, veh_turn, tire_end_idx, tire_end_mps2, sqp_m,
            sqp_step, machines, drag_coeff, m_veh, idx, kernels)
        if glue:
            trajs, vel_bound = vstage.epilogue(
                **tail, v_idx=v_idx, pref_idx=pref_idx, vel_start=vel_start,
                vx_normal=vx_normal, vx_follow=vx_follow,
                follow_bound=follow_bound)
            return dict(trajs=trajs, vel_bound=vel_bound,
                        too_close=too_close, vx_sqp=vx_sqp,
                        qp_status=qp_status)
    else:
        streams = None if const_gg is not None else gg_b
        (pref_idx, vel_start, v_decel, _, vx_normal, _, _, vx_follow,
         follow_bound, too_close) = _fb_profiles(
            kappa, el, s4, n_valids, v_idx, red_len, v_end_rl, c_len,
            vel_plan, vel_max, gg[:, 1], streams, streams, Fs, v_control,
            obj_dist, safety_d, veh_length, opp_stop_dist, roll_vel, roll_cum,
            idx, scan, kernels)
        qp_status, vx_sqp = zeros
    trajs, vel_bound = vstage.tail_plain(
        **tail, v_idx=v_idx, pref_idx=pref_idx, vel_start=vel_start,
        v_decel=v_decel, vx_normal=vx_normal, vx_follow=vx_follow,
        follow_bound=follow_bound, filt_window=1 if sqp else filt_window)
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
    ``m_veh`` as floats).  Each action is one path with its own follow
    profile; ``is_follow`` picks the follow branch, merged with the
    normal one on ``red_len``.

    ``fb`` (:func:`_fb_profiles`, eight recurrences an action): per-step
    gg streams scaled by ``gg_scale``, the brake prefix's by
    ``old_gg_scale`` (kernel 5 on the card).

    ``sqp`` (the reference's VpSQP, :func:`_sqp_qps`): a normal and a
    follow QP per action with the unscaled gg, the 2R QPs as one batched
    solve; overtakes — ``is_overtake`` (R,) — also zeroed on inaccurate
    solves; no smoothing.  ``sqp_x0`` (R, P) warm-start profiles (None:
    20 m/s); ``veh_turn`` 0-dim tensors, ``tire_end_mps2`` 0-dim or (R,);
    ``sqp_step`` the uniform spline step of the follow cap.

    :returns: dict(traj (R, P, 7) [s x y psi kappa vx ax], vel_bound (R,),
        too_close (R,), follow_v_control (R,), follow_control_d,
        vx_sqp (R, P) the raw profiles for the warm-start store and
        qp_status (R,) int32 — both zero for ``fb``)
    """
    R, P, _ = path.shape
    idx = torch.arange(P, device=path.device)
    kappa = path[:, None, :, 3]                                   # (R, 1, P)
    el = path[:, None, :, 4]
    s = _cumsum0(path[..., 4], kernels=kernels)
    sqp = vp_backend == "sqp"
    if not sqp and vp_backend != "fb":
        raise ValueError(f"unknown velocity backend {vp_backend!r}")
    vel_idx = c_len.long()
    control_d, v_control = _follow_control(
        ctrl_cp, ctrl_kd, ctrl_kp, ctrl_tanw, safety_d, veh_length, obj_dist,
        v_obj, vel_est, vel_max, control_type)
    v_idx = vstage.end_index(s, n_valid, red_len)
    if sqp:
        out = _sqp_qps(
            kappa, el, gg, n_valid[:, None], v_idx[:, None],
            vel_idx.expand(R), vel_plan.expand(R), vel_max, v_max_offset, 0,
            is_follow[:, None],
            False if is_overtake is None else is_overtake[:, None], obj_dist,
            v_obj, safety_d, veh_length,
            None if sqp_x0 is None else sqp_x0[:, None],
            veh_turn, tire_end_idx, tire_end_mps2, sqp_m, sqp_step, machines,
            drag_coeff, m_veh, idx, kernels)
    else:
        gg_s = gg * gg_scale
        out = _fb_profiles(
            kappa, el, s[:, None], n_valid[:, None], v_idx[:, None],
            red_len[:, None], v_end_rl[:, None], vel_idx.expand(R),
            vel_plan.expand(R), vel_max, gg_s[:, None, :, 1],
            gg * old_gg_scale, gg_s, 0, v_control, obj_dist, safety_d,
            veh_length, opp_stop_dist, roll_vel.expand(R, -1),
            roll_cum.expand(R, -1), idx,
            _scan(None, machines, dyn_model_exp, drag_coeff, m_veh, kernels),
            kernels)
    (pref_idx, vel_start, v_decel, masked, vx_normal, qp_status,
     vx_sqp) = (x[:, 0] for x in out[:7])
    vx_follow, follow_bound, too_close = out[7:]
    vx_normal, normal_bound = vstage.normal_bound(vx_normal, v_idx, pref_idx,
                                            vel_start, v_max_offset, idx)

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
    return dict(traj=vstage.profile(path, s, vx_full, n_valid[:, None], idx,
                              1 if sqp else filt_window),
                vel_bound=vel_bound, too_close=too_close,
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
    return vstage.profile(path, _cumsum0(el, kernels=kernels), vx_full,
                          n_valid, idx)


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
    el = path[:, 4]
    m = P if sqp_m is None else min(sqp_m, P)
    cols = torch.stack([path[:, 3], el, gg[:, 0], gg[:, 1]], dim=-1)
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
    return vstage.profile(path, _cumsum0(el, kernels=kernels), vx_full,
                          n_valid, idx)
