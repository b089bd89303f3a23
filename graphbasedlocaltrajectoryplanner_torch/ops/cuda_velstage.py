"""The fb velocity stage's glue: the CUDA kernels ``csrc/vel_stage.cu`` and
their plain PyTorch version.  No Pallas counterpart: the JAX package runs
this glue in XLA around its velocity kernel.

The fb backend (``planner/velplan._fb_profiles``) is four dependency levels
of stacked recurrences (``ops/cuda_velocity``): level 0 every path's brake
prefix; level 1 the follow slot's ego brake and unconstrained forward pass
beside every path's normal forward pass; level 2 the follow's segment-2
forward and unconstrained backward pass beside every normal backward pass;
level 3 the segment-2 backward pass.  Between the levels it derives each
level's rows from the last level's profiles (the prefix cut, masks, bounds,
the follow scalars, the segment-1 hand-off); after them it assembles the
follow profile, bounds the normal ones, selects a profile per slot and
computes the accelerations.  The plain version below is that code, split at
the scans (:func:`level0_plain` ... :func:`assembly_plain`,
:func:`tail_plain`); composed with the scans it is the fb backend of the
facade and of every path without the kernels.

On the card, for the fleet tick's constant-gg rows (no gg streams), two
wrappers replace the glue by five launches a tick:

* :func:`fb_level` (kernel ``vel_stage_level_kernel``), once before each
  level's scan: it writes the level's rows straight into the scan's
  (R, T) layout, row ``n * r + j`` as ``_lvl`` stacks them, backward rows
  flipped by their index, and the mode of each row; level 1 also writes
  each path's state (prefix cut, start velocity, end index), level 2 the
  follow state (stop index, hand-off, ``cannot_hold``, ``too_close``);
* :func:`epilogue` (kernel ``vel_stage_epilogue_kernel``), once after the
  last scan: the follow assembly (fb), the normal bounds, the slot select,
  the committed course and the profile ``[s x y psi kappa vx ax]`` with
  the stationary rule, in one launch; the sqp backend runs it without the
  follow assembly on its QP profiles.

Each kernel equals its plain version (:func:`fb_level_plain`,
:func:`epilogue_plain`) bit for bit, but for the follow slot's stopping
distance ``ego_stop_d``, a sum whose order ``torch.sum`` leaves open on the
card: in the kernel lane l of a warp adds the row's elements l, l + 32, ...
in turn and the 32 sums meet in a butterfly of shuffles, within
:func:`stop_distance_bound` of any other order; ``cannot_hold``, the one
use of it, and every other output are held exactly.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops

FWD, BRAKE, BWD = velops.MODE_FWD, velops.MODE_BRAKE, velops.MODE_BWD


def stop_distance_bound(el_abs_sum, n: int):
    """The largest difference of two float32 summation orders of ``n``
    terms whose magnitudes add up to ``el_abs_sum``: (n - 1) 2^-23 of it
    (each order within (n - 1) 2^-24 of the exact sum)."""
    return (n - 1) * 2.0 ** -23 * el_abs_sum


def at(v, i):
    """v[..., i[...]] along the last axis."""
    return torch.gather(v, -1, i.long()[..., None])[..., 0]


# ---- the rows of a level: a row is one recurrence for each of N paths, its
# per-step (N, P-1) columns and its (N,) start velocity; ``g`` the (N, P, 2)
# gg it streams, None for the scan's constant-gg instance --------------------

def _gg(g, rows):
    return () if g is None else (g[:, rows, 0], g[:, rows, 1])


def _row(k_abs, g, e, v_lim, v0):
    """A forward or brake row (brake: ``v_lim`` infinite)."""
    k = k_abs[:, :-1]
    gs = _gg(g, slice(None, -1))
    return (k, *gs, k, *gs, e[:, :-1], v_lim, v0)


def _fwd_row(k_abs, g, e, v_bound, v0):
    """A forward row under the pointwise bound ``v_bound`` (N, P)."""
    return _row(k_abs, g, e, v_bound[:, 1:], torch.minimum(v_bound[:, 0], v0))


def _bwd_row(k_abs, g, e, v_f):
    """The backward refinement of the forward profile ``v_f`` (N, P), on
    flipped inputs."""
    def flip(x):
        return torch.flip(x, dims=[-1])
    return (flip(k_abs[:, 1:]), *map(flip, _gg(g, slice(1, None))),
            flip(k_abs[:, :-1]), *map(flip, _gg(g, slice(None, -1))),
            flip(e[:, :-1]), flip(v_f[:, :-1]), v_f[:, -1])


def stack_rows(rows, modes):
    """The r rows of a level stacked to the N x r rows of one scan, row
    ``n * r + j``: each per-step column (N r, P-1), the start velocities
    (N r,) and the modes (N r,) int32."""
    cols = list(zip(*rows))
    N, T = cols[0][0].shape
    r = len(rows)
    per_step = [torch.stack(c, dim=1).reshape(N * r, T) for c in cols[:-1]]
    v_init = torch.stack(cols[-1], dim=1).reshape(N * r)
    mode = cuda_graph.const_vector(modes, torch.int32,
                                   v_init.device).repeat(N)
    return (*per_step, v_init, mode)


# ---- the glue of _fb_profiles, level by level (``g`` holds its inputs, as
# _fb_profiles' arguments, and what each step adds) ---------------------------

def _inf_row(g):
    N, _, P = g.el.shape
    return torch.full((N, P - 1), math.inf, dtype=g.el.dtype,
                      device=g.el.device)


def _prefix(g):
    g.prefix_active = g.vel_plan > (g.vel_max + 0.1)              # (N,)
    g.kabs = torch.abs(g.kappa)


def level0_plain(g):
    """Level 0: brake prefix to a lowered v_max, every path."""
    _prefix(g)
    k = g.el.shape[1]
    el_pref = torch.where(g.idx < g.c_len[:, None, None], 0.0, g.el)
    row_inf = _inf_row(g)
    return ([_row(g.kabs[:, j], g.gg_pref, el_pref[:, j], row_inf,
                  g.vel_plan) for j in range(k)], [BRAKE] * k)


def slots_plain(g, v_decel):
    """Each path's prefix cut and start velocity from level 0's profiles
    ``v_decel`` (N, k, P)."""
    P = v_decel.shape[-1]
    reach = v_decel <= g.vel_max
    first_reach = torch.argmax(reach.to(torch.int32), dim=-1)
    first_reach = torch.where(torch.any(reach, dim=-1), first_reach, P - 1)
    g.pref_idx = torch.where(g.prefix_active[:, None],
                             torch.maximum(first_reach, g.c_len[:, None]),
                             g.c_len[:, None])                    # (N, k)
    g.vel_start = torch.where(g.prefix_active[:, None],
                              at(v_decel, g.pref_idx), g.vel_plan[:, None])


def slot_tensors_plain(g):
    """The masks, masked curvature and lengths and the normal bounds of
    every path, from its prefix cut and end index."""
    g.masked = g.idx < g.pref_idx[..., None]
    g.kabs_m = torch.abs(torch.where(g.masked, 0.0, g.kappa))
    g.el_m = torch.where(g.masked, 0.0, g.el)
    v_end = torch.where(g.red_len, 0.0, g.v_end_rl)
    tail = g.idx >= g.v_idx[..., None] - 1
    g.el_n = torch.where(tail, 0.0, g.el_m)
    g.v_lat = torch.sqrt(g.ay / torch.clamp(g.kabs_m, min=1e-9))
    g.v0 = torch.minimum(g.v_lat, g.vel_max)
    g.v0_n = torch.where(tail, torch.minimum(g.v0, v_end[..., None]), g.v0)
    g.kf, g.ef = g.kabs_m[:, g.fs], g.el_m[:, g.fs]
    g.vsf = g.vel_start[:, g.fs]


def level1_plain(g):
    """Level 1: ego brake + unconstrained fwd (follow) + normal fwd."""
    k = g.el.shape[1]
    return ([_row(g.kf, g.gg, g.ef, _inf_row(g), g.vsf),
             _fwd_row(g.kf, g.gg, g.ef, g.v0[:, g.fs], g.vsf)]
            + [_fwd_row(g.kabs_m[:, j], g.gg, g.el_n[:, j], g.v0_n[:, j],
                        g.vel_start[:, j]) for j in range(k)],
            [BRAKE, FWD] + [FWD] * k)


def _el_seg2(g):
    el_seg2 = torch.where(g.idx < g.stop_idx[:, None], g.ef, 0.0)
    return torch.where(g.idx < g.idx_c[:, None], 0.0, el_seg2)


def follow_plain(g, lvl1, s_f):
    """The follow scalars and the segment-1 hand-off from level 1's
    profiles ``lvl1`` (N, k + 2, P) and the follow path's masked arc
    lengths ``s_f`` (N, P)."""
    P = s_f.shape[-1]
    fs = g.fs
    safety_total = g.safety_d + g.veh_length
    g.too_close = (g.obj_dist - safety_total) < 0.0
    s_stop = g.obj_dist - safety_total + g.opp_stop_dist
    g.stop_idx = torch.clamp(torch.sum(s_f < s_stop[:, None], dim=-1), 0,
                             P - 1)
    # the opponent's raceline velocity after its run-out
    run = g.opp_stop_dist - ((g.obj_dist - safety_total + g.opp_stop_dist)
                             - (at(g.s[:, fs], torch.clamp(
                                 g.n_valid[:, fs] - 1, 0, P - 1))
                                - at(g.s[:, fs], g.pref_idx[:, fs])))
    i_run = torch.clamp(torch.sum(g.roll_cum < run[:, None], dim=-1) + 1, 0,
                        g.roll_vel.shape[-1] - 1)
    opp_vel_at = torch.where(run <= 0.0, g.roll_vel[:, 0],
                             at(g.roll_vel, i_run))
    v_end_f = torch.where(s_stop > s_f[:, -1], opp_vel_at, 0.0)

    v_ego_brake = lvl1[:, 0]
    g.ego_stop_d = velops.stop_distance(v_ego_brake, g.ef)
    g.cannot_hold = g.ego_stop_d >= s_stop
    g.seg1_active = (g.vsf > g.v_control) & (g.stop_idx >= 2)
    below_c = v_ego_brake <= g.v_control[:, None]
    idx_c_raw = torch.argmax(below_c.to(torch.int32), dim=-1)
    idx_c_raw = torch.where(torch.any(below_c, dim=-1), idx_c_raw,
                            g.stop_idx)
    g.idx_c = torch.where(g.seg1_active,
                          torch.minimum(torch.where(idx_c_raw == 0,
                                                    g.stop_idx, idx_c_raw),
                                        g.stop_idx),
                          torch.zeros_like(g.stop_idx))
    g.vx_control_start = torch.where(g.seg1_active, at(v_ego_brake, g.idx_c),
                                     g.vsf)
    g.el_seg2 = _el_seg2(g)
    v0_s = torch.minimum(g.v_lat[:, fs], g.v_control[:, None])
    g.v0_s = torch.where(g.idx >= g.stop_idx[:, None],
                         torch.minimum(v0_s, v_end_f[:, None]), v0_s)


def level2_plain(g, lvl1):
    """Level 2: seg2 fwd + unconstrained bwd (follow) + normal bwd."""
    k = g.el.shape[1]
    vf_u, vf_n = lvl1[:, 1], lvl1[:, 2:]
    return ([_fwd_row(g.kf, g.gg, g.el_seg2, g.v0_s,
                      torch.minimum(g.vx_control_start, g.v_control)),
             _bwd_row(g.kf, g.gg, g.ef, vf_u)]
            + [_bwd_row(g.kabs_m[:, j], g.gg, g.el_n[:, j], vf_n[:, j])
               for j in range(k)],
            [FWD] + [BWD] * (k + 1))


def level3_plain(g, lvl2):
    """Level 3: seg2 bwd."""
    return [_bwd_row(g.kf, g.gg, g.el_seg2, lvl2[:, 0])], [BWD]


def assembly_plain(g, lvl1, lvl2, lvl3):
    """The follow assembly: (vx_normal (N, k, P), vx_follow (N, P),
    follow_bound (N,)) from the profiles of levels 1-3."""
    v_ego_brake = lvl1[:, 0]
    vx_compl = torch.flip(lvl2[:, 1], dims=[-1])
    vx_normal = torch.flip(lvl2[:, 2:], dims=[-1])                # (N, k, P)
    v_seg2 = torch.flip(lvl3[:, 0], dims=[-1])
    idx_c, stop_idx = g.idx_c, g.stop_idx
    follow_bound = torch.abs(at(v_seg2, idx_c) - g.vx_control_start) <= 1.0
    follow_bound &= ~((~g.seg1_active) & (stop_idx < 2))
    vx_follow = torch.where(g.idx < idx_c[:, None], v_ego_brake, v_seg2)
    vx_follow = torch.where(g.idx > stop_idx[:, None], 0.0, vx_follow)
    follow_bound &= torch.abs(vx_follow[:, 0] - g.vsf) <= 1.0
    vx_follow = torch.where(g.cannot_hold[:, None], v_ego_brake, vx_follow)
    follow_bound = torch.where(g.cannot_hold, True, follow_bound)
    vx_follow = torch.minimum(vx_follow, vx_compl)
    return vx_normal, vx_follow, follow_bound


# ---- the tail of the velocity stage -----------------------------------------

def end_index(s, n_valid, red_len):
    """The normal branch's end per path: ``n_valid``, or on a reduced
    horizon the first point 5 m short of the spline end.  ``s`` (..., P)
    leading-zero arc lengths; ``n_valid``, ``red_len`` (...)."""
    P = s.shape[-1]
    spl_len = at(s, torch.clamp(n_valid - 1, 0, P - 1))
    below = s[..., 1:] < (spl_len[..., None] - 5.0)  # the sums of el[:-1]
    v_idx_red = torch.argmin(below.to(torch.int32), dim=-1) + 1
    v_idx_red = torch.where((v_idx_red == 1) & (n_valid > 1), n_valid,
                            v_idx_red)
    return torch.where(red_len, v_idx_red, n_valid)


def normal_bound(vx_normal, v_idx, pref_idx, vel_start, v_max_offset, idx):
    """The normal profiles (..., P) zeroed from ``v_idx`` on (wholly where
    nothing is left after the prefix) and their velocity bound."""
    vx_normal = torch.where(idx >= v_idx[..., None], 0.0, vx_normal)
    degenerate = (v_idx - pref_idx) <= 1
    vx_normal = torch.where(degenerate[..., None], 0.0, vx_normal)
    bound = torch.abs(at(vx_normal, pref_idx) - vel_start) < v_max_offset
    return vx_normal, torch.where(degenerate, False, bound)


def profile(path, s, vx, n_valid, idx, filt_window: int = 1):
    """The profile [s x y psi kappa vx ax] (..., P, 7) of ``vx`` smoothed
    over ``filt_window`` (``velops.conv_filt``) on ``path``: ax -5 m/s^2
    where the car stands before the path end (``n_valid`` broadcasts
    against (..., P-1)), zero at the last point."""
    vx = velops.conv_filt(vx, filt_window)
    ax = velops.calc_ax_profile(vx, path[..., 4])
    stationary = torch.isclose(vx[..., :-1], torch.zeros_like(ax)) \
        & torch.isclose(ax, torch.zeros_like(ax)) & (idx[:-1] < n_valid - 1)
    ax = torch.where(stationary, -5.0, ax)
    ax_f = torch.cat([ax, torch.zeros_like(ax[..., :1])], dim=-1)
    return torch.stack([s, path[..., 0], path[..., 1], path[..., 2],
                        path[..., 3], vx, ax_f], dim=-1)


def tail_plain(paths, s, n_valid, c_len, vel_course, red_len, v_max_offset,
               fs: int, v_idx, pref_idx, vel_start, v_decel, vx_normal,
               vx_follow, follow_bound, filt_window: int = 1):
    """The scenario stage's tail on a backend's profiles: the normal
    bounds, the follow slot's profile (merged with its normal one on a
    reduced horizon) and bound, the committed course and the prefix, and
    the profile of each slot.  Returns (trajs (N, k, P, 7), vel_bound
    (N, k))."""
    k, P = paths.shape[1], paths.shape[2]
    idx = torch.arange(P, device=paths.device)
    is_follow = torch.arange(k, device=paths.device) == fs
    vx_normal, n_bound = normal_bound(vx_normal, v_idx, pref_idx, vel_start,
                                      v_max_offset, idx)
    vx_follow_sel = torch.where(red_len[:, fs, None],
                                torch.minimum(vx_follow, vx_normal[:, fs]),
                                vx_follow)
    vx_branch = torch.where(is_follow[None, :, None], vx_follow_sel[:, None],
                            vx_normal)
    vel_bound = torch.where(is_follow[None, :], follow_bound[:, None],
                            n_bound)
    vx_full = torch.where(idx < pref_idx[..., None], v_decel, vx_branch)
    vx_full = torch.where(idx < c_len[:, None, None], vel_course[:, None, :],
                          vx_full)
    return (profile(paths, s, vx_full, n_valid[..., None], idx, filt_window),
            vel_bound)


# ---- the kernels' specifications --------------------------------------------

def _glue(paths, s, n_valid, red_len, v_end_rl, c_len, vel_plan, vel_max, ay,
          v_control, obj_dist, safety_d, veh_length, opp_stop_dist, roll_vel,
          roll_cum, fs):
    """The namespace of :func:`level0_plain` and the steps after it for the
    constant-gg rows of ``paths`` (N, k, P, 5)."""
    return SimpleNamespace(
        kappa=paths[..., 3], el=paths[..., 4], s=s, n_valid=n_valid,
        red_len=red_len, v_end_rl=v_end_rl, c_len=c_len, vel_plan=vel_plan,
        vel_max=vel_max, ay=ay, v_control=v_control, obj_dist=obj_dist,
        safety_d=safety_d, veh_length=veh_length,
        opp_stop_dist=opp_stop_dist, roll_vel=roll_vel, roll_cum=roll_cum,
        fs=fs, gg=None, gg_pref=None,
        idx=torch.arange(paths.shape[2], device=paths.device))


# the state a level passes on, as fb_level returns it after the rows
SLOT_STATE = ("pref_idx", "vel_start", "v_idx")
FOLLOW_STATE = ("stop_idx", "idx_c", "seg1_active", "cannot_hold",
                "too_close", "vx_control_start", "ego_stop_d")


def fb_level_plain(level: int, paths, s, n_valid, red_len, v_end_rl, c_len,
                   vel_plan, vel_max, ay, v_control, obj_dist, safety_d,
                   veh_length, opp_stop_dist, roll_vel, roll_cum, fs: int,
                   lv=None, s_f=None, slots=None, follow=None):
    """Plain version of :func:`fb_level` (the specification of its kernel):
    level ``level``'s rows ``(k1, k2, ds, v_lim, v_init, mode)`` as
    :func:`stack_rows` stacks them, from the inputs of ``_fb_profiles`` for
    ``paths`` (N, k, P, 5) and ``ay`` (P,), and for levels 1-3 the last
    level's profiles ``lv`` (N r, P); level 1 adds the paths' state
    (:data:`SLOT_STATE`: (N, k) each), which levels 2 and 3 take as
    ``slots``; level 2 (which also takes the follow path's masked arc
    lengths ``s_f`` (N, P)) adds the follow state (:data:`FOLLOW_STATE`:
    (N,) each), which level 3 takes as ``follow``."""
    g = _glue(paths, s, n_valid, red_len, v_end_rl, c_len, vel_plan, vel_max,
              ay, v_control, obj_dist, safety_d, veh_length, opp_stop_dist,
              roll_vel, roll_cum, fs)
    N, k, P = g.el.shape
    if level == 0:
        return stack_rows(*level0_plain(g))
    if level == 1:
        _prefix(g)
        slots_plain(g, lv.reshape(N, k, P))
        g.v_idx = end_index(s, n_valid, red_len)
        slot_tensors_plain(g)
        return stack_rows(*level1_plain(g)) + tuple(
            getattr(g, n) for n in SLOT_STATE)
    g.pref_idx, g.vel_start, g.v_idx = slots
    slot_tensors_plain(g)
    if level == 2:
        lvl1 = lv.reshape(N, k + 2, P)
        follow_plain(g, lvl1, s_f)
        return stack_rows(*level2_plain(g, lvl1)) + tuple(
            getattr(g, n) for n in FOLLOW_STATE)
    if level != 3:
        raise ValueError(f"level: expected 0 to 3, got {level}")
    g.stop_idx, g.idx_c = follow[0], follow[1]
    g.el_seg2 = _el_seg2(g)
    return stack_rows(*level3_plain(g, lv.reshape(N, k + 2, P)))


def epilogue_plain(paths, s, n_valid, c_len, vel_course, red_len,
                   v_max_offset, fs: int, v_idx, pref_idx, vel_start,
                   vx_normal=None, vx_follow=None, follow_bound=None,
                   lv0=None, lv1=None, lv2=None, lv3=None, follow=None):
    """Plain version of :func:`epilogue` (the specification of its
    kernel): :func:`tail_plain` with ``filt_window`` 1 on ``paths``
    (N, k, P, 5), returning (trajs (N, k, P, 7), vel_bound (N, k)).

    fb: the follow assembly (:func:`assembly_plain`) on the four levels'
    profiles ``lv0`` .. ``lv3`` as the scans give them, the paths' state
    ``v_idx``, ``pref_idx``, ``vel_start`` (N, k) and the follow state
    ``follow`` (:data:`FOLLOW_STATE`).  sqp (``lv2`` None): the QP
    profiles ``vx_normal`` (N, k, P), ``vx_follow`` (N, P) and
    ``follow_bound`` (N,); ``pref_idx`` and ``vel_start`` (broadcast to
    (N, k)) the committed course's end and the planned velocity."""
    N, k, P = paths.shape[:3]
    if lv2 is not None:
        st = dict(zip(FOLLOW_STATE, follow))
        g = SimpleNamespace(idx=torch.arange(P, device=paths.device),
                            vsf=vel_start[:, fs], **st)
        vx_normal, vx_follow, follow_bound = assembly_plain(
            g, lv1.reshape(N, k + 2, P), lv2.reshape(N, k + 2, P),
            lv3.reshape(N, 1, P))
        v_decel = lv0.reshape(N, k, P)
    else:
        v_decel = torch.zeros_like(vx_normal)
    return tail_plain(paths, s, n_valid, c_len, vel_course, red_len,
                      v_max_offset, fs, v_idx, pref_idx, vel_start, v_decel,
                      vx_normal, vx_follow, follow_bound)


# ---- the kernels ------------------------------------------------------------

class StageArgs(ctypes.Structure):
    """``vel_stage::Args`` of ``csrc/vel_stage.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "paths", "s", "n_valid", "c_len", "red_len", "v_end_rl", "vel_plan",
        "vel_max", "ay", "v_control", "obj_dist", "safety_d", "veh_length",
        "opp_stop_dist", "roll_vel", "roll_cum", "s_f", "lv0", "lv1", "lv2",
        "lv3", "pref_idx", "vel_start", "v_idx", "stop_idx", "idx_c",
        "seg1_active", "cannot_hold", "too_close", "vx_control_start",
        "ego_stop_d", "k1", "k2", "ds", "v_lim", "v_init", "mode",
        "vel_course", "v_max_offset", "vx_normal", "vx_follow",
        "follow_bound", "trajs", "vel_bound")] + [(name, ctypes.c_longlong) for name in (
            "N", "pref_sn", "pref_sj", "vs_sn", "vs_sj", "ay_st")] + [
        (name, ctypes.c_int) for name in ("k", "P", "F", "fs", "level", "fb")]


def _f32(t, shape, what):
    t = t.contiguous()
    cb.require(t, torch.float32, shape, what)
    return t


def _i64(t, shape, what):
    t = t.long().contiguous()
    cb.require(t, torch.int64, shape, what)
    return t


def _flag(t, shape, what):
    t = t.contiguous()
    cb.require(t, torch.bool, shape, what)
    return t


def _scalar(t, what):
    if not torch.is_tensor(t) or t.numel() != 1:
        raise ValueError(f"{what}: expected a one-element tensor")
    return _f32(t.reshape(()), (), what)


def _common(a, paths, s, n_valid, c_len, red_len):
    """The inputs of every launch, checked, and their sizes into ``a``;
    returns (N, k, P) and the checked tensors by field."""
    if paths.dim() != 4 or paths.shape[3] != 5 or paths.shape[2] < 2:
        raise ValueError(f"paths: expected (N, k, P, 5) with P >= 2, got "
                         f"{tuple(paths.shape)}")
    N, k, P = paths.shape[:3]
    if N == 0 or k == 0:
        raise ValueError(f"paths: expected N, k >= 1, got "
                         f"{tuple(paths.shape)}")
    keep = dict(paths=_f32(paths, (N, k, P, 5), "paths"),
                s=_f32(s, (N, k, P), "s"),
                n_valid=_i64(n_valid, (N, k), "n_valid"),
                c_len=_i64(c_len, (N,), "c_len"),
                red_len=_flag(red_len, (N, k), "red_len"))
    a.N, a.k, a.P = N, k, P
    return (N, k, P), keep


def level_args(level: int, paths, s, n_valid, red_len, v_end_rl, c_len,
               vel_plan, vel_max, ay, v_control, obj_dist, safety_d,
               veh_length, opp_stop_dist, roll_vel, roll_cum, fs: int,
               lv=None, s_f=None, slots=None, follow=None):
    """``(args, out, keep)``: the checked :class:`StageArgs` of one
    ``fb_level`` launch, the outputs it fills (as :func:`fb_level_plain`
    returns them) and the tensors that must live until the launch is
    enqueued.  Raises on a wrong level, device, dtype or shape before
    anything is launched."""
    if level not in (0, 1, 2, 3):
        raise ValueError(f"level: expected 0 to 3, got {level}")
    cb.require_card(paths, "paths")
    a = StageArgs()
    (N, k, P), keep = _common(a, paths, s, n_valid, c_len, red_len)
    if not 0 <= fs < k:
        raise ValueError(f"fs: expected a slot of {k}, got {fs}")
    F = roll_vel.shape[-1] if roll_vel.dim() == 2 else 0
    if F < 1:
        raise ValueError(f"roll_vel: expected (N, F), got "
                         f"{tuple(roll_vel.shape)}")
    # ay as it is: a (P,) view, of stride 0 where the gg is constant
    cb.require_card(ay, "ay")
    if ay.dtype != torch.float32 or tuple(ay.shape) != (P,):
        raise ValueError(f"ay: expected torch.float32 of shape ({P},), got "
                         f"{ay.dtype} of shape {tuple(ay.shape)}")
    keep.update(
        v_end_rl=_f32(v_end_rl, (N, k), "v_end_rl"),
        vel_plan=_f32(vel_plan, (N,), "vel_plan"),
        vel_max=_scalar(vel_max, "vel_max"), ay=ay,
        v_control=_f32(v_control, (N,), "v_control"),
        obj_dist=_f32(obj_dist, (N,), "obj_dist"),
        safety_d=_scalar(safety_d, "safety_d"),
        veh_length=_scalar(veh_length, "veh_length"),
        opp_stop_dist=_f32(opp_stop_dist, (N,), "opp_stop_dist"),
        roll_vel=_f32(roll_vel, (N, F), "roll_vel"),
        roll_cum=_f32(roll_cum, (N, F), "roll_cum"))
    r_in = (k, k + 2, k + 2)
    if level:
        keep[f"lv{level - 1}"] = _f32(lv, (N * r_in[level - 1], P), "lv")
    if level == 2:
        keep["s_f"] = _f32(s_f, (N, P), "s_f")
    if level >= 2:
        pref_idx, vel_start, v_idx = slots
        keep.update(pref_idx=_i64(pref_idx, (N, k), "pref_idx"),
                    vel_start=_f32(vel_start, (N, k), "vel_start"),
                    v_idx=_i64(v_idx, (N, k), "v_idx"))
    if level == 3:
        keep.update(stop_idx=_i64(follow[0], (N,), "stop_idx"),
                    idx_c=_i64(follow[1], (N,), "idx_c"))
    for name, t in keep.items():
        setattr(a, name, t.data_ptr())
    a.ay_st, a.F, a.fs, a.level = ay.stride(0), F, fs, level
    dev = paths.device
    R = N * (k, k + 2, k + 2, 1)[level]
    T = P - 1

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    k1, ds, v_lim = empty((R, T)), empty((R, T)), empty((R, T))
    # only backward rows (levels 2 and 3) take a second curvature stream
    k2 = empty((R, T)) if level >= 2 else k1     # levels 0, 1: k2 is k1
    v_init, mode = empty((R,)), empty((R,), torch.int32)
    out = (k1, k2, ds, v_lim, v_init, mode)
    if level == 1:
        out += (empty((N, k), torch.int64), empty((N, k)),
                empty((N, k), torch.int64))
        a.pref_idx, a.vel_start, a.v_idx = (t.data_ptr() for t in out[6:])
    if level == 2:
        out += (empty((N,), torch.int64), empty((N,), torch.int64),
                empty((N,), torch.bool), empty((N,), torch.bool),
                empty((N,), torch.bool), empty((N,)), empty((N,)))
        (a.stop_idx, a.idx_c, a.seg1_active, a.cannot_hold, a.too_close,
         a.vx_control_start, a.ego_stop_d) = (t.data_ptr() for t in out[6:])
    a.k1, a.k2, a.ds, a.v_lim, a.v_init, a.mode = (
        t.data_ptr() for t in (k1, k2, ds, v_lim, v_init, mode))
    return a, out, keep


def fb_level(level: int, paths, s, n_valid, red_len, v_end_rl, c_len,
             vel_plan, vel_max, ay, v_control, obj_dist, safety_d,
             veh_length, opp_stop_dist, roll_vel, roll_cum, fs: int, lv=None,
             s_f=None, slots=None, follow=None):
    """One level's rows and state (:func:`fb_level_plain`): the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if paths.device.type == "cpu":
        return fb_level_plain(level, paths, s, n_valid, red_len, v_end_rl,
                              c_len, vel_plan, vel_max, ay, v_control,
                              obj_dist, safety_d, veh_length, opp_stop_dist,
                              roll_vel, roll_cum, fs, lv, s_f, slots, follow)
    a, out, _keep = level_args(level, paths, s, n_valid, red_len, v_end_rl,
                               c_len, vel_plan, vel_max, ay, v_control,
                               obj_dist, safety_d, veh_length, opp_stop_dist,
                               roll_vel, roll_cum, fs, lv, s_f, slots, follow)
    cb.check(cb.load("vel_stage")(ctypes.byref(a), cb.stream()),
             "vel_stage")
    fb_level.launches += 1
    return out


def epilogue_args(paths, s, n_valid, c_len, vel_course, red_len,
                  v_max_offset, fs: int, v_idx, pref_idx, vel_start,
                  vx_normal=None, vx_follow=None, follow_bound=None, lv0=None,
                  lv1=None, lv2=None, lv3=None, follow=None):
    """``(args, out, keep)`` of one ``epilogue`` launch, as
    :func:`level_args`."""
    cb.require_card(paths, "paths")
    a = StageArgs()
    (N, k, P), keep = _common(a, paths, s, n_valid, c_len, red_len)
    if not 0 <= fs < k:
        raise ValueError(f"fs: expected a slot of {k}, got {fs}")
    fb = lv2 is not None
    if fb == (vx_normal is not None):
        raise ValueError("expected either the four levels' profiles (fb) "
                         "or the QP profiles (sqp)")
    # pref_idx and vel_start as they are: (N, k), or broadcast from (N,)
    for name, t, dt in (("pref_idx", pref_idx, torch.int64),
                        ("vel_start", vel_start, torch.float32)):
        if tuple(t.shape) != (N, k):
            raise ValueError(f"{name}: expected shape {(N, k)}, got "
                             f"{tuple(t.shape)}")
        cb.require_card(t, name)
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        keep[name] = t
    a.pref_sn, a.pref_sj = pref_idx.stride()
    a.vs_sn, a.vs_sj = vel_start.stride()
    keep.update(vel_course=_f32(vel_course, (N, P), "vel_course"),
                v_max_offset=_scalar(v_max_offset, "v_max_offset"),
                v_idx=_i64(v_idx, (N, k), "v_idx"))
    if fb:
        keep.update(lv0=_f32(lv0, (N * k, P), "lv0"),
                    lv1=_f32(lv1, (N * (k + 2), P), "lv1"),
                    lv2=_f32(lv2, (N * (k + 2), P), "lv2"),
                    lv3=_f32(lv3, (N, P), "lv3"))
        for name, t in zip(FOLLOW_STATE[:4], follow[:4]):
            keep[name] = (_i64(t, (N,), name) if name in ("stop_idx", "idx_c")
                          else _flag(t, (N,), name))
        keep["vx_control_start"] = _f32(follow[5], (N,), "vx_control_start")
    else:
        keep.update(vx_normal=_f32(vx_normal, (N, k, P), "vx_normal"),
                    vx_follow=_f32(vx_follow, (N, P), "vx_follow"),
                    follow_bound=_flag(follow_bound, (N,), "follow_bound"))
    for name, t in keep.items():
        setattr(a, name, t.data_ptr())
    a.fs, a.fb = fs, int(fb)
    dev = paths.device
    out = (torch.empty((N, k, P, 7), dtype=torch.float32, device=dev),
           torch.empty((N, k), dtype=torch.bool, device=dev))
    a.trajs, a.vel_bound = out[0].data_ptr(), out[1].data_ptr()
    return a, out, keep


def epilogue(paths, s, n_valid, c_len, vel_course, red_len, v_max_offset,
             fs: int, v_idx, pref_idx, vel_start, vx_normal=None,
             vx_follow=None, follow_bound=None, lv0=None, lv1=None, lv2=None,
             lv3=None, follow=None):
    """The stage's tail in one launch (:func:`epilogue_plain`): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    if paths.device.type == "cpu":
        return epilogue_plain(paths, s, n_valid, c_len, vel_course, red_len,
                              v_max_offset, fs, v_idx, pref_idx, vel_start,
                              vx_normal, vx_follow, follow_bound, lv0, lv1,
                              lv2, lv3, follow)
    a, out, _keep = epilogue_args(paths, s, n_valid, c_len, vel_course,
                                  red_len, v_max_offset, fs, v_idx, pref_idx,
                                  vel_start, vx_normal, vx_follow,
                                  follow_bound, lv0, lv1, lv2, lv3, follow)
    cb.check(cb.load("vel_stage_epilogue")(ctypes.byref(a), cb.stream()),
             "vel_stage_epilogue")
    epilogue.launches += 1
    return out


fb_level.launches = 0
epilogue.launches = 0
