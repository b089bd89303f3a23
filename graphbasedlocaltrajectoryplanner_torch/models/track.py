"""Global-trajectory (track) import + variable layer spacing — the port's
own copy of the JAX package's ``models/track.py`` (host NumPy, runs once
per track)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GlobalTrajectory:
    """Parsed 12-column LTPL track file (x_ref;y_ref;width_right;width_left;
    x_normvec;y_normvec;alpha;s_racetraj;psi;kappa;vx;ax) — the closing
    duplicate row is dropped."""
    refline: np.ndarray          # (n, 2)
    width_right: np.ndarray      # (n,)
    width_left: np.ndarray       # (n,)
    normvec: np.ndarray          # (n, 2) normalized
    alpha: np.ndarray            # (n,) raceline offset along normvec [m]
    el_lengths: np.ndarray       # (n,) raceline segment lengths (diff of s col)
    vel_rl: np.ndarray           # (n,) raceline velocity [mps]
    kappa_rl: np.ndarray         # (n,) raceline curvature [1/m]

    @property
    def raceline(self) -> np.ndarray:
        return self.refline + self.normvec * self.alpha[:, None]


def import_globtraj_csv(path: str) -> GlobalTrajectory:
    data = np.loadtxt(path, delimiter=";", comments="#")
    return GlobalTrajectory(
        refline=data[:-1, 0:2],
        width_right=data[:-1, 2],
        width_left=data[:-1, 3],
        normvec=data[:-1, 4:6],
        alpha=data[:-1, 6],
        el_lengths=np.diff(data[:, 7]),
        vel_rl=data[:-1, 10],
        kappa_rl=data[:-1, 9],
    )


def variable_step_size(kappa: np.ndarray,
                       dist: np.ndarray,
                       d_curve: float,
                       d_straight: float,
                       curve_th: float,
                       force_last: bool = False) -> list:
    """Select layer indices along the track: denser in curves, sparser on
    straights (a curvature exceedance after the minimum curve distance
    pulls the next layer in)."""
    next_dist = 0.0
    next_dist_min = 0.0
    cur_dist = 0.0
    idx_array = []
    for idx, dist_val in enumerate(dist):
        if (cur_dist + dist_val) > next_dist_min and abs(kappa[idx]) > curve_th:
            next_dist = cur_dist
        if (cur_dist + dist_val) > next_dist:
            idx_array.append(idx)
            next_dist += d_straight if abs(kappa[idx]) < curve_th else d_curve
            next_dist_min = cur_dist + d_curve
        cur_dist += dist_val
    if force_last and (len(kappa) - 1) not in idx_array:
        idx_array.append(len(kappa) - 1)
    return idx_array


def make_oval_track(n: int = 400,
                    r: float = 60.0,
                    straight: float = 250.0,
                    width: float = 12.0,
                    v_max: float = 50.0,
                    ay_max: float = 10.0) -> GlobalTrajectory:
    """Procedurally generated closed oval test track (two straights + two
    half-circles), centered raceline."""
    total = 2 * straight + 2 * np.pi * r
    s = np.linspace(0.0, total, n, endpoint=False)
    pts = np.zeros((n, 2))
    psi_tan = np.zeros(n)
    kappa = np.zeros(n)
    for i, si in enumerate(s):
        if si < straight:                         # bottom straight, +x
            pts[i] = [si, 0.0]
            psi_tan[i] = 0.0
        elif si < straight + np.pi * r:           # right half circle ccw
            th = (si - straight) / r
            pts[i] = [straight + r * np.sin(th), r - r * np.cos(th)]
            psi_tan[i] = th
            kappa[i] = 1.0 / r
        elif si < 2 * straight + np.pi * r:       # top straight, -x
            d = si - straight - np.pi * r
            pts[i] = [straight - d, 2 * r]
            psi_tan[i] = np.pi
        else:                                     # left half circle
            th = (si - 2 * straight - np.pi * r) / r
            pts[i] = [-r * np.sin(th), 2 * r - r * (1 - np.cos(th))]
            psi_tan[i] = np.pi + th
            kappa[i] = 1.0 / r
    # normvec points to the right of travel
    normvec = np.column_stack([np.sin(psi_tan), -np.cos(psi_tan)])
    el = np.full(n, total / n)
    vel = np.minimum(v_max, np.sqrt(ay_max / np.maximum(np.abs(kappa), 1e-6)))
    return GlobalTrajectory(
        refline=pts,
        width_right=np.full(n, width / 2),
        width_left=np.full(n, width / 2),
        normvec=normvec,
        alpha=np.zeros(n),
        el_lengths=el,
        vel_rl=vel,
        kappa_rl=kappa,
    )
