"""Ideal-controller vehicle dummy — advances the ego along the last planned
trajectory to close the control loop without a physics simulator (behavioral
counterpart of reference testing_tools/src/vdc_dummy.py:5-58).

Re-expressed in closed form: the planned velocity course is piecewise linear
in arc length, so ``ds/dt = v(s)`` integrates exactly per segment
(exponential in-segment advance for a linear ``v(s)``) instead of the
reference's 1 ms Euler loop — vectorized over the whole course, no Python
stepping.  A stopped course still creeps at the reference's floor of
0.1 m/s (1e-4 m of arc per 1 ms reference Euler step).
"""

from __future__ import annotations

import numpy as np

# minimum advance speed: the reference floors each 1 ms Euler step at
# 1e-4 m of arc, i.e. an effective 0.1 m/s creep on a stopped course
_V_FLOOR = 0.1


def _segment_times(s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Exact traversal time of each course segment under piecewise-linear
    velocity: dt = ds * ln(v1/v0) / (v1 - v0), with the degenerate
    constant-velocity limit ds / v."""
    ds = np.diff(s)
    v0, v1 = v[:-1], v[1:]
    dv = v1 - v0
    near_const = np.abs(dv) < 1e-9
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lin = ds * np.log(v1 / v0) / np.where(near_const, 1.0, dv)
    return np.where(near_const, ds / v0, t_lin)


def vdc_dummy(pos_est, last_s_course, last_path, last_vel_course,
              iter_time: float):
    """Advance ``iter_time`` seconds along the trajectory.

    :param pos_est: current ego position [x, y].
    :param last_s_course: (P,) arc-length stations of the planned course.
    :param last_path: (P, >=2) planned xy path at those stations.
    :param last_vel_course: (P,) planned velocities at those stations.
    :returns: (new position [x, y], velocity estimate there)
    """
    path = np.asarray(last_path, float)
    s_course = np.asarray(last_s_course, float)
    vel = np.asarray(last_vel_course, float)
    if path.shape[0] <= 2:
        return list(map(float, pos_est)), float(vel[0])

    # project the ego onto the course: anchor at the earlier of the two
    # nearest path points, offset by the straight-line distance to it
    d2 = np.einsum("ij,ij->i", path[:, :2] - np.asarray(pos_est, float),
                   path[:, :2] - np.asarray(pos_est, float))
    anchor = int(min(np.argpartition(d2, 2)[:2]))
    s = s_course[anchor] + float(np.sqrt(d2[anchor]))

    # closed-form advance: cumulative traversal times per segment, then an
    # exponential in-segment step for the residual time
    v_eff = np.maximum(vel, _V_FLOOR)
    t_seg = _segment_times(s_course, v_eff)
    t_cum = np.concatenate([[0.0], np.cumsum(t_seg)])
    # time already consumed from the course start to s (exact in-segment
    # time — t(s) is logarithmic within a segment, not linear)
    j = int(np.clip(np.searchsorted(s_course, s, side="right") - 1,
                    0, len(s_course) - 2))
    v_at = lambda x, i: v_eff[i] + (v_eff[i + 1] - v_eff[i]) \
        * (x - s_course[i]) / max(s_course[i + 1] - s_course[i], 1e-12)
    slope_j = (v_eff[j + 1] - v_eff[j]) \
        / max(s_course[j + 1] - s_course[j], 1e-12)
    if abs(slope_j) < 1e-9:
        t_in = (s - s_course[j]) / v_eff[j]
    else:
        t_in = np.log(max(v_at(s, j), _V_FLOOR) / v_eff[j]) / slope_j
    t_now = float(t_cum[j] + t_in)
    t_target = t_now + float(iter_time)
    if t_target >= t_cum[-1]:
        s_new = s_course[-1]                    # course exhausted: pin end
    else:
        i = int(np.searchsorted(t_cum, t_target, side="right") - 1)
        dt = t_target - t_cum[i]
        s0, s1 = s_course[i], s_course[i + 1]
        v0, v1 = v_eff[i], v_eff[i + 1]
        slope = (v1 - v0) / max(s1 - s0, 1e-12)
        if abs(slope) < 1e-9:
            s_new = s0 + v0 * dt
        else:
            s_new = s0 + v0 * np.expm1(slope * dt) / slope
        s_new = min(s_new, s1)

    pos_out = [float(np.interp(s_new, s_course, path[:, 0])),
               float(np.interp(s_new, s_course, path[:, 1]))]
    return pos_out, float(np.interp(s_new, s_course, vel))
