"""Track input of the plain reference: the LTPL 12-column track CSV, the
generated closed oval written in that format, and the upstream layer
selection along the raceline.  Plain NumPy."""

from __future__ import annotations

import dataclasses

import numpy as np

# x_ref;y_ref;width_right;width_left;x_normvec;y_normvec;alpha;s_racetraj;
# psi;kappa;vx;ax
N_COLS = 12


@dataclasses.dataclass
class Track:
    """A track file's rows without the closing duplicate; ``el`` are the
    raceline's element lengths (the differences of the s column, the
    closing one included)."""
    refline: np.ndarray
    width_right: np.ndarray
    width_left: np.ndarray
    normvec: np.ndarray
    alpha: np.ndarray
    el: np.ndarray
    kappa: np.ndarray
    vel: np.ndarray

    @property
    def raceline(self) -> np.ndarray:
        return self.refline + self.alpha[:, None] * self.normvec


def read_csv(path: str) -> Track:
    rows = np.loadtxt(path, delimiter=";", comments="#", ndmin=2)
    if rows.shape[1] != N_COLS:
        raise ValueError(f"{path}: {rows.shape[1]} columns, not {N_COLS}")
    body = rows[:-1]
    return Track(refline=body[:, 0:2], width_right=body[:, 2],
                 width_left=body[:, 3], normvec=body[:, 4:6],
                 alpha=body[:, 6], el=np.diff(rows[:, 7]),
                 kappa=body[:, 9], vel=body[:, 10])


def oval_rows(n: int, r: float, straight: float, width: float,
              v_max: float, ay_max: float) -> np.ndarray:
    """The closed oval (a straight along +x, a half circle to the left, a
    straight back, a half circle home) as ``n + 1`` CSV rows, the last the
    first again at the full length; the raceline on the centre line, its
    speed the lateral limit ``sqrt(ay_max / kappa)`` capped at ``v_max``."""
    total = 2.0 * straight + 2.0 * np.pi * r
    out = np.zeros((n + 1, N_COLS))
    for i in range(n):
        s = total * i / n
        if s < straight:
            x, y, head, k = s, 0.0, 0.0, 0.0
        elif s < straight + np.pi * r:
            th = (s - straight) / r
            x, y, head, k = straight + r * np.sin(th), r * (1 - np.cos(th)), \
                th, 1.0 / r
        elif s < 2.0 * straight + np.pi * r:
            x, y, head, k = straight - (s - straight - np.pi * r), 2.0 * r, \
                np.pi, 0.0
        else:
            th = (s - 2.0 * straight - np.pi * r) / r
            x, y, head, k = -r * np.sin(th), r * (1 + np.cos(th)), \
                np.pi + th, 1.0 / r
        v = v_max if k == 0.0 else min(v_max, np.sqrt(ay_max / k))
        # the normal points to the right of the direction of travel
        out[i] = [x, y, width / 2, width / 2, np.sin(head), -np.cos(head),
                  0.0, s, 0.0, k, v, 0.0]
    out[n] = out[0]
    out[n, 7] = total
    return out


def select_layers(kappa, el, d_curve: float, d_straight: float,
                  curve_thr: float, keep_last: bool) -> np.ndarray:
    """Indices of the raceline points that become layers: a layer every
    ``d_straight`` metres, every ``d_curve`` in curves (|kappa| above
    ``curve_thr``), where a curve that starts after the minimum curve
    distance pulls the next layer in at once."""
    picked = []
    s = 0.0
    target = 0.0
    earliest = 0.0
    for i in range(len(el)):
        nxt = s + el[i]
        curved = abs(kappa[i]) > curve_thr
        if curved and nxt > earliest:
            target = s
        if nxt > target:
            picked.append(i)
            target += d_straight if abs(kappa[i]) < curve_thr else d_curve
            earliest = s + d_curve
        s = nxt
    if keep_last and picked[-1] != len(kappa) - 1:
        picked.append(len(kappa) - 1)
    return np.asarray(picked)
