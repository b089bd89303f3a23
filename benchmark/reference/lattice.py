"""The plain reference's offline phase: the lattice of a track under the
offline INI, built in float64 NumPy, one layer or edge at a time where
that reads plainest.

Nodes sit on each layer's normal every ``lat_resolution`` metres, their
headings blended from the left bound over the raceline to the right
bound; an edge joins node n of layer l to node m of the next layer when m
lies within the lateral fan-out of n and the cubic Hermite curve between
them keeps its curvature under the vehicle's and the layer's limits
(raceline to raceline edges follow the periodic raceline spline and
always stay); edges of nodes with no way in or out go; each edge costs
its curvature mean and peak, length and raceline distance.  The search
costs (edge and virtual-goal) are kept as float32, the precision the
planner's tables hold; everything else stays float64.
"""

from __future__ import annotations

import configparser
import dataclasses
import math

import numpy as np

from benchmark.reference import track as trk

UNREACHABLE = np.float32(1e30)        # a search cost that blocks
REACH_LIMIT = 1e29                    # costs at or above it are no path


@dataclasses.dataclass
class Offline:
    lat_resolution: float
    variable_heading: bool
    lon_straight_step: float
    lon_curve_step: float
    curve_thr: float
    lat_offset: float
    virt_goal_n: bool
    min_vel_race: float
    closure_detection_dist: float
    vel_decrease_lat: float
    min_plan_horizon: float
    plan_horizon_mode: str
    stepsize_approx: float
    veh_width: float
    veh_length: float
    veh_turn: float
    w_raceline: float
    w_raceline_sat: float
    w_length: float
    w_curv_avg: float
    w_curv_peak: float
    w_virt_goal: float


def read_offline(path: str) -> Offline:
    cp = configparser.ConfigParser()
    if not cp.read(path):
        raise FileNotFoundError(path)
    kw = {}
    for f in dataclasses.fields(Offline):
        sec = next(s for s in cp.sections() if f.name in cp[s])
        if f.type == "bool":
            kw[f.name] = cp.getboolean(sec, f.name)
        elif f.type == "str":
            kw[f.name] = cp.get(sec, f.name).strip()
        else:
            kw[f.name] = cp.getfloat(sec, f.name)
    return Offline(**kw)


@dataclasses.dataclass
class RefLattice:
    L: int
    N: int
    S: int
    H_max: int
    closed: bool
    cfg: Offline
    refline: np.ndarray           # (L, 2)
    normvec: np.ndarray
    raceline: np.ndarray          # (L, 2)
    s_rl: np.ndarray              # (L,)
    vel_rl: np.ndarray            # (L,)
    rl_idx: np.ndarray            # (L,) int
    nodes_in_layer: np.ndarray    # (L,) int
    node_pos: np.ndarray          # (L, N, 2)
    node_psi: np.ndarray          # (L, N)
    node_valid: np.ndarray        # (L, N)
    rl_coeffs: np.ndarray         # (L, 4, 2) periodic raceline spline
    edge_coeffs: np.ndarray       # (L, N, N, 4, 2) each edge's curve
    edge_valid: np.ndarray        # (L, N, N)
    edge_npts: np.ndarray         # (L, N, N) int
    edge_len: np.ndarray          # (L, N, N)
    samples: np.ndarray           # (L, N, N, S, 2)
    w: np.ndarray                 # (L, N, N) float32, UNREACHABLE if none
    vg: np.ndarray                # (L, N) float32 virtual-goal cost
    h_goal: np.ndarray            # (L,) int horizon of a start layer
    glob: np.ndarray              # (F, 5) fine raceline s, x, y, kappa, v
    glob_el: np.ndarray           # (F,)

    FLOAT_FIELDS = ("refline", "normvec", "raceline", "s_rl", "vel_rl",
                    "node_pos", "node_psi", "rl_coeffs", "edge_coeffs",
                    "edge_len", "samples", "w", "vg", "glob", "glob_el")


def heading(dx, dy):
    """Heading of a direction, 0 to the north, counter-clockwise, wrapped
    into [-pi, pi)."""
    return wrap(np.arctan2(dy, dx) - np.pi / 2)


def wrap(a):
    return np.mod(a + np.pi, 2 * np.pi) - np.pi


def direction(psi):
    return np.stack([-np.sin(psi), np.cos(psi)], axis=-1)


def polyline_heading(pts: np.ndarray, el: np.ndarray) -> np.ndarray:
    """Heading of a closed polyline at each point from the chord between
    its neighbours ``round(1 m / mean element)`` steps away (at least
    one)."""
    n = len(pts)
    k = max(round(1.0 / float(np.mean(el))), 1)
    ahead = pts[(np.arange(n) + k) % n]
    behind = pts[(np.arange(n) - k) % n]
    d = ahead - behind
    return heading(d[:, 0], d[:, 1])


def blend(a: float, b: float, num: int) -> np.ndarray:
    """``num`` headings evenly from ``a`` to ``b`` the short way round."""
    if num <= 0:
        return np.zeros(0)
    if abs(a - b) < np.pi:
        return np.linspace(a, b, num)
    a2 = a + 2 * np.pi if a < 0 else a
    b2 = b + 2 * np.pi if b < 0 else b
    return wrap(np.linspace(a2, b2, num))


def hermite(p0, p1, psi0, psi1):
    """Cubic from p0 to p1 leaving along psi0 and arriving along psi1, the
    end tangents as long as the chord: coefficients (4, 2) of
    a0 + a1 t + a2 t^2 + a3 t^3."""
    chord = math.hypot(p1[0] - p0[0], p1[1] - p0[1])
    t0 = direction(psi0) * chord
    t1 = direction(psi1) * chord
    d = p1 - p0
    return np.array([p0, t0, 3 * d - 2 * t0 - t1, -2 * d + t0 + t1])


def from_tangents(pts, tang, seg):
    """Cubic pieces through ``pts`` (k+1, 2) with unit arc tangents
    ``tang`` (k+1, 2) at the knots and piece lengths ``seg`` (k,)."""
    out = np.zeros((len(seg), 4, 2))
    for j in range(len(seg)):
        t0 = tang[j] * seg[j]
        t1 = tang[j + 1] * seg[j]
        d = pts[j + 1] - pts[j]
        out[j] = [pts[j], t0, 3 * d - 2 * t0 - t1, -2 * d + t0 + t1]
    return out


def periodic_spline(pts: np.ndarray) -> np.ndarray:
    """C2 closed cubic spline through ``pts`` (n, 2), chord-length
    parametrised: the tangents solve the cyclic system of second
    derivative continuity, densely."""
    n = len(pts)
    nxt = np.roll(pts, -1, axis=0)
    seg = np.maximum(np.hypot(*(nxt - pts).T), 1e-12)
    A = np.zeros((n, n))
    rhs = np.zeros((n, 2))
    for i in range(n):
        lp, li = seg[i - 1], seg[i]
        lam = lp / li
        A[i, i - 1] += 1.0
        A[i, i] += 2.0 * (1.0 + lam)
        A[i, (i + 1) % n] += lam
        rhs[i] = 3.0 * ((pts[i] - pts[i - 1]) / lp
                        + lam * (nxt[i] - pts[i]) / li)
    tang = np.linalg.solve(A, rhs)
    return from_tangents(np.vstack([pts, pts[:1]]),
                         np.vstack([tang, tang[:1]]), seg)


def evaluate(c, t):
    t = np.asarray(t, float)[..., None]
    return c[..., 0, :] + t * (c[..., 1, :] + t * (c[..., 2, :]
                                                   + t * c[..., 3, :]))


def derivatives(c, t):
    t = np.asarray(t, float)[..., None]
    d = c[..., 1, :] + t * (2 * c[..., 2, :] + 3 * t * c[..., 3, :])
    dd = 2 * c[..., 2, :] + 6 * t * c[..., 3, :]
    return d, dd


def curvature(d, dd):
    den = np.maximum((d[..., 0] ** 2 + d[..., 1] ** 2) ** 1.5, 1e-12)
    return (d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]) / den


def build(tr: trk.Track, cfg: Offline) -> RefLattice:
    race_fine = tr.raceline
    closed = bool(np.hypot(*(race_fine[0] - race_fine[-1]))
                  < cfg.closure_detection_dist)
    if not closed:
        raise ValueError("the reference plans closed tracks only")
    s_fine = np.concatenate([[0.0], np.cumsum(tr.el)])
    fine = np.column_stack([race_fine, tr.kappa, tr.vel])
    glob = np.column_stack([s_fine, np.vstack([fine, fine[:1]])])
    glob_el = np.append(np.diff(glob[:, 0]), 0.0)

    idx = trk.select_layers(tr.kappa, tr.el, cfg.lon_curve_step,
                            cfg.lon_straight_step, cfg.curve_thr, False)
    L = len(idx)
    refline, normvec = tr.refline[idx], tr.normvec[idx]
    alpha, wr, wl = tr.alpha[idx], tr.width_right[idx], tr.width_left[idx]
    vel_rl, s_rl = tr.vel[idx], s_fine[idx]
    # element lengths between layers; the closing one is left at zero
    lay_el = np.array([tr.el[a:b].sum() for a, b in zip(idx[:-1], idx[1:])]
                      + [0.0])
    raceline = refline + alpha[:, None] * normvec

    # nodes
    half = cfg.veh_width / 2
    if min(np.min(wl - half + alpha), np.min(wr - half - alpha)) < 0:
        raise ValueError("raceline outside the vehicle's margin")
    psi_rl = polyline_heading(raceline, lay_el)
    bl = refline - wl[:, None] * normvec
    br = refline + wr[:, None] * normvec
    psi_bl = polyline_heading(bl, np.hypot(*(np.roll(bl, -1, 0) - bl).T))
    psi_br = polyline_heading(br, np.hypot(*(np.roll(br, -1, 0) - br).T))
    rl_idx = np.floor((wl - half + alpha) / cfg.lat_resolution).astype(int)
    offsets, psis = [], []
    for i in range(L):
        a = np.arange(alpha[i] - rl_idx[i] * cfg.lat_resolution, wr[i] - half,
                      cfg.lat_resolution)
        if cfg.variable_heading:
            p = np.concatenate([
                blend(psi_bl[i], psi_rl[i], rl_idx[i] + 1)[:-1],
                blend(psi_rl[i], psi_br[i], len(a) - rl_idx[i])])
        else:
            p = np.full(len(a), psi_rl[i])
        offsets.append(a)
        psis.append(p)
    nil = np.array([len(a) for a in offsets])
    N = max(8, -(-int(nil.max()) // 8) * 8)
    node_off = np.zeros((L, N))
    node_psi = np.zeros((L, N))
    node_valid = np.zeros((L, N), bool)
    for i in range(L):
        node_off[i, :nil[i]] = offsets[i]
        node_psi[i, :nil[i]] = psis[i]
        node_valid[i, :nil[i]] = True
    node_pos = refline[:, None] + node_off[..., None] * normvec[:, None]
    rl_coeffs = periodic_spline(raceline)

    # edges
    coeffs = np.zeros((L, N, N, 4, 2))
    cand = np.zeros((L, N, N), bool)
    is_rl = np.zeros((L, N, N), bool)
    for l in range(L):
        l2 = (l + 1) % L
        for n in range(nil[l]):
            centre = rl_idx[l2] + n - rl_idx[l]
            ref = node_pos[l2, min(max(centre, 0), nil[l2] - 1)]
            fan = math.floor(np.hypot(*(ref - node_pos[l, n]))
                             * cfg.lat_offset / cfg.lat_resolution + 0.5)
            for m in range(max(0, centre - fan),
                           min(nil[l2] - 1, centre + fan) + 1):
                cand[l, n, m] = True
                if n == rl_idx[l] and m == rl_idx[l2]:
                    is_rl[l, n, m] = True
                    coeffs[l, n, m] = rl_coeffs[l]
                else:
                    coeffs[l, n, m] = hermite(node_pos[l, n], node_pos[l2, m],
                                              node_psi[l, n], node_psi[l2, m])
    pts15 = evaluate(coeffs[:, :, :, None], np.linspace(0, 1, 15))
    len15 = np.hypot(*np.moveaxis(np.diff(pts15, axis=3), -1, 0)).sum(-1)
    npts = np.maximum(np.ceil(len15 / cfg.stepsize_approx).astype(int) + 1, 2)
    S = int(np.max(np.where(cand, npts, 2)))
    t = np.minimum(np.arange(S) / np.maximum(npts[..., None] - 1, 1), 1.0)
    samples = evaluate(coeffs[:, :, :, None], t)
    kap = curvature(*derivatives(coeffs[:, :, :, None], t))
    live = np.arange(S) < npts[..., None]
    step = np.hypot(*np.moveaxis(np.diff(samples, axis=3), -1, 0))
    edge_len = np.where(live[..., 1:], step, 0.0).sum(-1)
    k_peak = np.abs(kap).max(-1)
    corner = (vel_rl * cfg.min_vel_race) ** 2 / 10.0
    ok = (k_peak <= 1.0 / cfg.veh_turn) \
        & (k_peak <= 1.0 / np.maximum(corner, 1e-12)[:, None, None])
    valid = cand & (ok | is_rl)

    # drop edges of nodes that cannot be entered or left, until none
    while True:
        has_in = np.roll(valid.any(axis=1), 1, axis=0)    # (L, N)
        has_out = valid.any(axis=2)
        drop = valid & (~has_in[:, :, None]
                        | ~np.roll(has_out, -1, axis=0)[:, None, :])
        if not drop.any():
            break
        valid &= ~drop

    # offline cost
    k_live = np.where(live, kap, 0.0)
    k_mean = np.abs(k_live).sum(-1) / npts
    k_hi = np.where(live, kap, -np.inf).max(-1)
    k_lo = np.where(live, kap, np.inf).min(-1)
    lat = np.abs(rl_idx[(np.arange(L) + 1) % L][:, None, None]
                 - np.arange(N)[None, None, :]) * cfg.lat_resolution
    cost = (cfg.w_curv_avg * k_mean ** 2 * edge_len
            + cfg.w_curv_peak * (k_hi - k_lo) ** 2 * edge_len
            + cfg.w_length * edge_len
            + np.minimum(cfg.w_raceline * edge_len * lat,
                         cfg.w_raceline_sat * edge_len))
    w = np.where(valid, cost, UNREACHABLE).astype(np.float32)

    if cfg.virt_goal_n:
        vg = np.abs(rl_idx[:, None] - np.arange(N)[None, :]) \
            * cfg.lat_resolution * cfg.w_virt_goal
    else:
        raise ValueError("the reference needs virt_goal_n=True")
    vg = np.where(node_valid, vg, UNREACHABLE).astype(np.float32)

    if cfg.plan_horizon_mode != "distance":
        raise ValueError("the reference needs plan_horizon_mode=distance")
    h_goal = np.zeros(L, int)
    for l in range(L):
        target = s_rl[l] + cfg.min_plan_horizon
        if target > s_rl[-1]:
            target -= s_rl[-1]
        end = int(np.searchsorted(s_rl, target, side="left"))
        h_goal[l] = (end - l) % L or L - 1
    return RefLattice(
        L=L, N=N, S=S, H_max=int(h_goal.max()), closed=closed, cfg=cfg,
        refline=refline, normvec=normvec, raceline=raceline, s_rl=s_rl,
        vel_rl=vel_rl, rl_idx=rl_idx, nodes_in_layer=nil, node_pos=node_pos,
        node_psi=node_psi, node_valid=node_valid, rl_coeffs=rl_coeffs,
        edge_coeffs=coeffs, edge_valid=valid, edge_npts=npts,
        edge_len=edge_len, samples=samples, w=w, vg=vg, h_goal=h_goal,
        glob=glob, glob_el=glob_el)
