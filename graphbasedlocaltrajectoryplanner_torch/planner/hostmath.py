"""Host-side NumPy helpers of the stateful handler (float64, on
variable-length arrays) — the port's own copy of the JAX package's
``planner/hostmath.py``, kept identical line for line: the handler's
decisions (start node, cut indices, object distances) rest on it.  The
math is that of the reference helper_funcs/src/closest_path_index.py and
get_s_coord.py."""

from __future__ import annotations

import math

import numpy as np


def closest_path_index(path: np.ndarray, pos) -> int:
    d2 = (path[:, 0] - pos[0]) ** 2 + (path[:, 1] - pos[1]) ** 2
    return int(np.argmin(d2))


def _angle3pt(a, b, c) -> float:
    ang = math.atan2(c[1] - b[1], c[0] - b[0]) - math.atan2(a[1] - b[1], a[0] - b[0])
    if ang > math.pi:
        ang -= 2 * math.pi
    elif ang <= -math.pi:
        ang += 2 * math.pi
    return ang


def get_s_coord(ref_line: np.ndarray, pos, s_array: np.ndarray = None,
                only_index: bool = False, closed: bool = False):
    """Continuous s + enclosing indices (reference get_s_coord.py:34-99)."""
    idx_nb = closest_path_index(ref_line, pos)
    n = ref_line.shape[0]
    if closed:
        idx1 = (idx_nb - 1) % n
        idx2 = (idx_nb + 1) % n
    else:
        idx1 = max(idx_nb - 1, 0)
        idx2 = min(idx_nb + 1, n - 1)

    ang1 = abs(_angle3pt(ref_line[idx_nb], pos, ref_line[idx1]))
    ang2 = abs(_angle3pt(ref_line[idx_nb], pos, ref_line[idx2]))

    s = None
    if not only_index:
        if ang1 > ang2:
            a_pos, b_pos = ref_line[idx1], ref_line[idx_nb]
        else:
            a_pos, b_pos = ref_line[idx_nb], ref_line[idx2]
        if s_array is None:
            s_array = np.cumsum(np.sqrt(np.sum(np.diff(ref_line, axis=0) ** 2,
                                               axis=1)))
        if s_array[0] > 0.05:
            s_array = np.insert(s_array, 0, 0.0)
        denom = (b_pos[0] - a_pos[0]) ** 2 + (b_pos[1] - a_pos[1]) ** 2
        t = (((pos[0] - a_pos[0]) * (b_pos[0] - a_pos[0])
              + (pos[1] - a_pos[1]) * (b_pos[1] - a_pos[1]))
             / max(denom, 1e-12))
        foot = [a_pos[0] + t * (b_pos[0] - a_pos[0]),
                a_pos[1] + t * (b_pos[1] - a_pos[1])]
        ds = math.hypot(a_pos[0] - foot[0], a_pos[1] - foot[1])
        s = (s_array[idx1] if ang1 > ang2 else s_array[idx_nb]) + ds

    if ang1 >= ang2:
        return s, [idx1, idx_nb]
    return s, [idx_nb, idx2]


def check_inside_bounds(bound1: np.ndarray, bound2: np.ndarray, pos) -> bool:
    """On-track check (reference check_inside_bounds.py:27-57)."""
    centerline = (bound1 + bound2) / 2.0
    b_idx = get_s_coord(centerline, pos, only_index=True, closed=True)[1]
    w = np.linspace(0.0, 1.0, 50)[:, None]
    b1 = bound1[b_idx[0]] * (1 - w) + bound1[b_idx[1]] * w
    b2 = bound2[b_idx[0]] * (1 - w) + bound2[b_idx[1]] * w
    cl = centerline[b_idx[0]] * (1 - w) + centerline[b_idx[1]] * w
    k = closest_path_index(cl, pos)
    d_track2 = np.sum((b1[k] - b2[k]) ** 2)
    d1 = np.sum((b1[k] - np.asarray(pos)) ** 2)
    d2 = np.sum((b2[k] - np.asarray(pos)) ** 2)
    return not (d1 > d_track2 or d2 > d_track2)
