"""Offline lattice construction and the lattice container (torch) —
counterpart of the JAX package's ``models/lattice.py``.

The lattice over a track with L layers and at most N lateral nodes per
layer is held as dense tensors: nodes ``(L, N)``, edges ``(L, N, N)`` (an
entry ``[l, n, m]`` is the spline edge from node n of layer l to node m of
layer (l+1) mod L) with offline cost ``w`` (INF when absent) and sampled
points ``samples_xy (L, N, N, S, 2)``, the virtual-goal cost and the
planning-horizon tables.

The build is host code in float64 (NumPy, with the heading and spline
helpers run as float64 torch on the CPU) and casts to float32 at the end,
as the JAX builder does.  ``save_lattice``/``load_lattice`` read and write
the JAX package's npz format, and :func:`lattice_from_numpy` carries a
lattice's arrays across from the JAX package bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    GlobalTrajectory, variable_step_size)
from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
from graphbasedlocaltrajectoryplanner_torch.ops.heading import (
    calc_head_curv_num, normalize_psi)
from graphbasedlocaltrajectoryplanner_torch.ops.search import INF
from graphbasedlocaltrajectoryplanner_torch.utils.config import OfflineConfig

# virt_goal_n=False goal-scan rank scale (dominates every real path cost
# while N * SCALE stays far below FEAS_THRESH)
GOAL_RANK_SCALE = 1e12

VERSION = 1.0


@dataclasses.dataclass
class Lattice:
    """Dense lattice tensors + static metadata (fields as in the JAX
    package's ``Lattice``)."""
    # nodes
    node_pos: torch.Tensor        # (L, N, 2)
    node_psi: torch.Tensor        # (L, N)
    node_valid: torch.Tensor      # (L, N) bool
    rl_idx: torch.Tensor          # (L,) int32 raceline node index per layer
    nodes_in_layer: torch.Tensor  # (L,) int32
    # edges (l, n -> l+1 mod L, m)
    w: torch.Tensor               # (L, N, N) offline cost, INF if absent
    edge_valid: torch.Tensor      # (L, N, N) bool
    edge_len: torch.Tensor        # (L, N, N) chord length over samples
    edge_npts: torch.Tensor       # (L, N, N) int32 sample count
    samples_xy: torch.Tensor      # (L, N, N, S, 2)
    samples_el: torch.Tensor      # (L, N, N, S) inter-sample element lengths
    # goal / horizon
    vg_cost: torch.Tensor         # (L, N) virtual-goal lateral cost
    end_layer_for_start: torch.Tensor  # (L,) int32
    h_goal_for_start: torch.Tensor     # (L,) int32
    # track data (downsampled to layers)
    refline: torch.Tensor         # (L, 2)
    normvec: torch.Tensor         # (L, 2)
    alpha: torch.Tensor           # (L,)
    s_rl: torch.Tensor            # (L,)
    vel_rl: torch.Tensor          # (L,)
    raceline: torch.Tensor        # (L, 2)
    track_width_right: torch.Tensor  # (L,)
    track_width_left: torch.Tensor   # (L,)
    raceline_coeffs: torch.Tensor    # (L, 4, 2) periodic raceline spline
    # fine global raceline: columns s, x, y, kappa, vel (+ element lengths)
    glob_rl: torch.Tensor         # (F, 5)
    glob_el: torch.Tensor         # (F,)
    # static metadata
    L: int = dataclasses.field(metadata=dict(static=True))
    N: int = dataclasses.field(metadata=dict(static=True))
    S: int = dataclasses.field(metadata=dict(static=True))
    H_max: int = dataclasses.field(metadata=dict(static=True))
    closed: bool = dataclasses.field(metadata=dict(static=True))
    lat_resolution: float = dataclasses.field(metadata=dict(static=True))
    lat_offset: float = dataclasses.field(metadata=dict(static=True))
    sampled_resolution: float = dataclasses.field(metadata=dict(static=True))
    veh_width: float = dataclasses.field(metadata=dict(static=True))
    veh_length: float = dataclasses.field(metadata=dict(static=True))
    veh_turn: float = dataclasses.field(metadata=dict(static=True))
    vel_decrease_lat: float = dataclasses.field(metadata=dict(static=True))
    virt_goal_cost: float = dataclasses.field(metadata=dict(static=True))
    md5_params: str = dataclasses.field(metadata=dict(static=True))
    graph_id: str = dataclasses.field(metadata=dict(static=True))

    @property
    def device(self) -> torch.device:
        return self.w.device

    def edge_coeffs(self, l, n, m):
        """Hermite coefficients (..., 4, 2) of the edges (l, n) -> (l+1, m),
        rebuilt from the nodes (raceline edges reuse the periodic raceline
        spline segment); ``l``, ``n``, ``m`` ints or index tensors."""
        dev = self.device
        l, n, m = (torch.as_tensor(x, device=dev).long() for x in (l, n, m))
        l2 = torch.remainder(l + 1, self.L)
        her = spl.fit_hermite(self.node_pos[l, n], self.node_pos[l2, m],
                              self.node_psi[l, n], self.node_psi[l2, m])
        is_rl = (n == self.rl_idx[l]) & (m == self.rl_idx[l2])
        return torch.where(is_rl[..., None, None], self.raceline_coeffs[l],
                           her)

    def to(self, device=None) -> "Lattice":
        """A copy with every tensor on ``device`` (default: the card)."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dev) for k in ARRAY_FIELDS})


ARRAY_FIELDS = [f.name for f in dataclasses.fields(Lattice)
                if not f.metadata.get("static", False)]
META_FIELDS = [f.name for f in dataclasses.fields(Lattice)
               if f.metadata.get("static", False)]


def lattice_from_numpy(arrays: dict, meta: dict) -> Lattice:
    """The port's lattice from another lattice's arrays (``np.asarray`` of
    each array field, e.g. of the JAX package's ``Lattice``) and its static
    metadata, on the CPU.  Dtypes are kept, so the data is bit-identical."""
    kw = {k: torch.from_numpy(np.array(arrays[k], copy=True))
          for k in ARRAY_FIELDS}
    kw.update({k: meta[k] for k in META_FIELDS})
    return Lattice(**kw)


# ---------------------------------------------------------------------------
# node skeleton
# ---------------------------------------------------------------------------

def _calc_head_curv_num_np(path, el_lengths, is_closed):
    psi, kappa = calc_head_curv_num(
        torch.as_tensor(np.asarray(path, np.float64)),
        torch.as_tensor(np.asarray(el_lengths, np.float64)), is_closed)
    return psi.numpy(), kappa.numpy()


def _interp_heading(psi_a, psi_b, num):
    """linspace between two headings along the short way with +-pi wrap."""
    if num <= 0:
        return np.zeros((0,))
    if abs(psi_a - psi_b) < np.pi:
        return np.linspace(psi_a, psi_b, num=num)
    pa = psi_a + 2 * np.pi * (psi_a < 0)
    pb = psi_b + 2 * np.pi * (psi_b < 0)
    return normalize_psi(torch.as_tensor(np.linspace(pa, pb, num=num))).numpy()


def build_node_skeleton(refline, normvec, alpha, width_right, width_left,
                        length_raceline, cfg: OfflineConfig, closed: bool):
    """Spread lateral nodes on every layer normal.

    :returns: (node_alpha (L, N), node_psi (L, N), node_valid (L, N),
               rl_idx (L,), nodes_in_layer (L,))  [N = padded max]
    """
    L = refline.shape[0]
    raceline = refline + normvec * alpha[:, None]
    closed_idx = None if closed else -1

    psi_rl, _ = _calc_head_curv_num_np(
        raceline, np.asarray(length_raceline[:closed_idx]), closed)
    if cfg.variable_heading:
        bound_r = refline + normvec * width_right[:, None]
        bound_l = refline - normvec * width_left[:, None]
        d_l = np.diff(np.vstack([bound_l, bound_l[:1]]), axis=0)
        len_bl = np.hypot(d_l[:, 0], d_l[:, 1])
        d_r = np.diff(np.vstack([bound_r, bound_r[:1]]), axis=0)
        len_br = np.hypot(d_r[:, 0], d_r[:, 1])
        psi_bl, _ = _calc_head_curv_num_np(bound_l, len_bl[:closed_idx],
                                           closed)
        psi_br, _ = _calc_head_curv_num_np(bound_r, len_br[:closed_idx],
                                           closed)

    half_w = cfg.veh_width / 2.0
    margin_left = np.min(width_left - half_w + alpha)
    margin_right = np.min(width_right - half_w - alpha)
    if margin_left < 0.0 or margin_right < 0.0:
        max_w = cfg.veh_width + min(margin_left, margin_right) * 2
        raise ValueError(
            "Provided raceline holds points outside the safety margin! "
            f"Maximum possible vehicle width is {max_w:.3f} m — reduce "
            "'veh_width' or adapt the race line.")

    rl_idx = np.floor((width_left - half_w + alpha)
                      / cfg.lat_resolution).astype(np.int32)
    alphas_per_layer = []
    psis_per_layer = []
    for i in range(L):
        s0 = alpha[i] - rl_idx[i] * cfg.lat_resolution
        a = np.arange(s0, width_right[i] - half_w, cfg.lat_resolution)
        if cfg.variable_heading:
            p1 = _interp_heading(psi_bl[i], psi_rl[i], rl_idx[i] + 1)[:-1]
            p2 = _interp_heading(psi_rl[i], psi_br[i], len(a) - rl_idx[i])
            p = np.concatenate([p1, p2])
        else:
            p = np.full(len(a), psi_rl[i])
        alphas_per_layer.append(a)
        psis_per_layer.append(p)

    nodes_in_layer = np.array([len(a) for a in alphas_per_layer], np.int32)
    N = int(np.max(nodes_in_layer))
    N_pad = max(8, int(np.ceil(N / 8)) * 8)

    node_alpha = np.zeros((L, N_pad))
    node_psi = np.zeros((L, N_pad))
    node_valid = np.zeros((L, N_pad), bool)
    for i in range(L):
        k = nodes_in_layer[i]
        node_alpha[i, :k] = alphas_per_layer[i]
        node_psi[i, :k] = psis_per_layer[i]
        node_valid[i, :k] = True
    return node_alpha, node_psi, node_valid, rl_idx, nodes_in_layer


# ---------------------------------------------------------------------------
# edge generation — vectorized over (L, N, N), float64
# ---------------------------------------------------------------------------

def _build_edges(node_pos, node_psi, node_valid, rl_idx, nodes_in_layer,
                 vel_rl, raceline_coeffs, cfg: OfflineConfig, closed: bool):
    L, N, _ = node_pos.shape
    nxt = (np.arange(L) + 1) % L

    # fan-out window
    n_idx = np.arange(N)
    end_ref = rl_idx[nxt][:, None] + n_idx[None, :] - rl_idx[:, None]
    ref_clip = np.clip(end_ref, 0, nodes_in_layer[nxt][:, None] - 1)
    p_ref = node_pos[nxt[:, None], ref_clip]
    dist = np.linalg.norm(p_ref - node_pos, axis=-1)
    lat_steps = np.floor(dist * cfg.lat_offset / cfg.lat_resolution
                         + 0.5).astype(np.int32)

    m_idx = np.arange(N)[None, None, :]
    lo = np.maximum(0, end_ref - lat_steps)[:, :, None]
    hi = np.minimum(nodes_in_layer[nxt][:, None] - 1,
                    end_ref + lat_steps)[:, :, None]
    in_fan = (m_idx >= lo) & (m_idx <= hi)
    valid = in_fan & node_valid[:, :, None] & node_valid[nxt][:, None, :]
    if not closed:
        valid[L - 1] = False

    # Hermite coefficients of all candidate edges, float64
    p0 = np.asarray(node_pos, np.float64)[:, :, None, :]
    p1 = np.asarray(node_pos, np.float64)[nxt][:, None, :, :]
    psi0 = np.asarray(node_psi, np.float64)[:, :, None]
    psi1 = np.asarray(node_psi, np.float64)[nxt][:, None, :]
    dist = np.linalg.norm(p1 - p0, axis=-1, keepdims=True)
    d0 = np.stack([-np.sin(psi0), np.cos(psi0)], axis=-1) * dist
    d1 = np.stack([-np.sin(psi1), np.cos(psi1)], axis=-1) * dist
    dp = p1 - p0
    coeffs = np.stack([np.broadcast_to(p0, dp.shape), d0,
                       3.0 * dp - 2.0 * d0 - d1,
                       -2.0 * dp + d0 + d1], axis=-2)     # (L,N,N,4,2)
    # raceline edges reuse the periodic raceline spline
    is_rl_edge = ((n_idx[None, :, None] == rl_idx[:, None, None])
                  & (m_idx == rl_idx[nxt][:, None, None]))
    coeffs = np.where(is_rl_edge[..., None, None],
                      np.asarray(raceline_coeffs,
                                 np.float64)[:, None, None, :, :], coeffs)

    def _eval(c, t):
        t = t[..., None]
        return (c[..., 0, :] + t * (c[..., 1, :]
                + t * (c[..., 2, :] + t * c[..., 3, :])))

    def _kappa(c, t):
        t = t[..., None]
        d = c[..., 1, :] + t * (2.0 * c[..., 2, :] + t * 3.0 * c[..., 3, :])
        dd = 2.0 * c[..., 2, :] + t * 6.0 * c[..., 3, :]
        denom = np.power(d[..., 0] ** 2 + d[..., 1] ** 2, 1.5)
        return (d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]) \
            / np.maximum(denom, 1e-12)

    # sampling: n_pts per edge from the 15-point approximate length
    t15 = np.linspace(0.0, 1.0, 15)
    pts15 = _eval(coeffs[:, :, :, None, :, :], t15[None, None, None, :])
    lengths15 = np.sum(np.linalg.norm(np.diff(pts15, axis=3), axis=-1),
                       axis=-1)
    n_pts = np.ceil(lengths15 / cfg.stepsize_approx).astype(np.int64) + 1
    n_pts = np.maximum(n_pts, 2)
    S = int(np.max(np.where(valid, n_pts, 2)))

    t_idx = np.arange(S)
    t_vals = np.minimum(t_idx[None, None, None, :]
                        / np.maximum(n_pts[..., None] - 1, 1), 1.0)
    samples = _eval(coeffs[:, :, :, None, :, :], t_vals)  # (L,N,N,S,2)
    kappa_s = _kappa(coeffs[:, :, :, None, :, :], t_vals)

    # edge chord length over its own samples
    seg = np.linalg.norm(np.diff(samples, axis=3), axis=-1)
    seg_valid = t_idx[None, None, None, 1:] <= (n_pts[..., None] - 1)
    edge_len = np.sum(np.where(seg_valid, seg, 0.0), axis=-1)

    # curvature kill (vehicle turn radius, min-race-speed corner radius);
    # raceline-to-raceline edges always kept
    kappa_abs_max = np.max(np.abs(kappa_s), axis=-1)
    vel_lim = np.asarray(vel_rl)[:, None, None] * cfg.min_vel_race
    min_turn = vel_lim ** 2 / 10.0
    kappa_ok = (kappa_abs_max <= 1.0 / cfg.veh_turn) & \
               (kappa_abs_max <= 1.0 / np.maximum(min_turn, 1e-12))
    valid = np.asarray(valid & (kappa_ok | is_rl_edge))
    return (valid, coeffs, np.asarray(samples, np.float32),
            np.asarray(n_pts, np.int32), edge_len, kappa_s, is_rl_edge, S)


def _prune(valid: np.ndarray, closed: bool) -> np.ndarray:
    """Reachability prune: iteratively drop edges of nodes without parents
    or children (start/end layers exempt on unclosed tracks)."""
    L = valid.shape[0]
    valid = valid.copy()
    while True:
        has_child = valid.any(axis=2)
        has_parent = np.roll(valid.any(axis=1), 1, axis=0)
        if not closed:
            has_parent[0] = True
            has_child[L - 1] = True
        bad_out = valid & ~has_parent[:, :, None]
        bad_in = valid & ~np.roll(has_child, -1, axis=0)[:, None, :]
        removed = bad_out | bad_in
        if not removed.any():
            return valid
        valid &= ~removed


def _offline_cost(valid, kappa_s, n_pts, edge_len, rl_idx,
                  cfg: OfflineConfig):
    """Per-edge offline cost (curvature average/peak, length, raceline
    deviation), float64 then stored as float32."""
    L, N, _, S = kappa_s.shape
    t_idx = np.arange(S)
    sample_ok = t_idx[None, None, None, :] < n_pts[..., None]
    k = np.where(sample_ok, kappa_s, 0.0)
    mean_abs = np.sum(np.abs(k), axis=-1) / np.maximum(n_pts, 1)
    k_for_ext = np.where(sample_ok, kappa_s, np.nan)
    with np.errstate(invalid="ignore"):
        k_max = np.nanmax(k_for_ext, axis=-1)
        k_min = np.nanmin(k_for_ext, axis=-1)
    peak = np.abs(k_max - k_min)

    cost = cfg.w_curv_avg * mean_abs ** 2 * edge_len
    cost += cfg.w_curv_peak * peak ** 2 * edge_len
    cost += cfg.w_length * edge_len
    nxt = (np.arange(L) + 1) % L
    lat_dist = np.abs(rl_idx[nxt][:, None, None]
                      - np.arange(N)[None, None, :]) * cfg.lat_resolution
    cost += np.minimum(cfg.w_raceline * edge_len * lat_dist,
                       cfg.w_raceline_sat * edge_len)
    return np.where(valid, cost, float(INF)).astype(np.float32)


def _samples_el_table(samples: np.ndarray) -> np.ndarray:
    """(L, N, N, S) inter-sample element lengths (last column 0)."""
    d = np.linalg.norm(np.diff(samples, axis=3), axis=-1)
    return np.concatenate(
        [d, np.zeros(d.shape[:3] + (1,), d.dtype)], axis=3).astype(np.float32)


# ---------------------------------------------------------------------------
# main builder
# ---------------------------------------------------------------------------

def build_lattice(gt: GlobalTrajectory, cfg: OfflineConfig,
                  md5_params: str = "", graph_id: str = "torch0") -> Lattice:
    """Build the lattice of a track on the host; the result lies on the CPU
    (``.to()`` moves it to the card)."""
    s_fine = np.concatenate([[0.0], np.cumsum(gt.el_lengths)])
    raceline_fine = gt.raceline
    closed = bool(np.hypot(raceline_fine[0, 0] - raceline_fine[-1, 0],
                           raceline_fine[0, 1] - raceline_fine[-1, 1])
                  < cfg.closure_detection_dist)

    # fine global raceline (s, x, y, kappa, vel) — closed duplicate appended
    rl_params = np.column_stack([raceline_fine, gt.kappa_rl, gt.vel_rl])
    if closed:
        glob_rl = np.column_stack([s_fine,
                                   np.vstack([rl_params, rl_params[:1]])])
    else:
        glob_rl = np.column_stack([s_fine[:-1], rl_params])
    glob_el = np.append(np.diff(glob_rl[:, 0]), 0.0)

    idx = variable_step_size(gt.kappa_rl, gt.el_lengths,
                             d_curve=cfg.lon_curve_step,
                             d_straight=cfg.lon_straight_step,
                             curve_th=cfg.curve_thr,
                             force_last=not closed)
    refline = gt.refline[idx]
    width_right = gt.width_right[idx]
    width_left = gt.width_left[idx]
    normvec = gt.normvec[idx]
    alpha = gt.alpha[idx]
    vel_rl = gt.vel_rl[idx]
    s_rl = s_fine[idx]
    length_rl = [float(np.sum(gt.el_lengths[a:b]))
                 for a, b in zip(idx[:-1], idx[1:])] + [0.0]

    # float64 through the geometric build (headings, raceline spline, edge
    # fan-out): float32 heading noise perturbs edge curvatures enough to
    # flip near-optimal DP argmins
    node_alpha, node_psi, node_valid, rl_idx, nodes_in_layer = \
        build_node_skeleton(refline, normvec, alpha, width_right,
                            width_left, length_rl, cfg, closed)
    raceline = refline + normvec * alpha[:, None]
    raceline_coeffs = spl.fit_periodic_chain(
        torch.as_tensor(np.vstack([raceline, raceline[:1]]),
                        dtype=torch.float64)).numpy()
    L, N = node_alpha.shape
    node_pos = refline[:, None, :] + normvec[:, None, :] * node_alpha[..., None]

    valid, coeffs, samples, n_pts, edge_len, kappa_s, is_rl_edge, S = \
        _build_edges(node_pos, node_psi, node_valid, rl_idx, nodes_in_layer,
                     vel_rl, raceline_coeffs, cfg, closed)
    valid = _prune(valid, closed)
    w = _offline_cost(valid, kappa_s, n_pts, edge_len, rl_idx, cfg)

    # virtual goal cost; with virt_goal_n=False the reference's goal scan
    # order (raceline node, then decreasing, then increasing indices)
    # becomes a rank bias so goal selection stays one weighted argmin
    n_ar = np.arange(N)[None, :]
    if cfg.virt_goal_n:
        vg = np.abs(rl_idx[:, None] - n_ar) \
            * cfg.lat_resolution * cfg.w_virt_goal
    else:
        rank = np.where(n_ar <= rl_idx[:, None], rl_idx[:, None] - n_ar, n_ar)
        vg = rank.astype(np.float64) * GOAL_RANK_SCALE
    vg_cost = np.where(node_valid, vg, float(INF)).astype(np.float32)

    # planning horizon tables
    end_layer = np.zeros(L, np.int32)
    for start in range(L):
        if cfg.plan_horizon_mode == "distance":
            des = s_rl[start] + cfg.min_plan_horizon
            if des > s_rl[-1]:
                des = des - s_rl[-1] if closed else s_rl[-1]
            end_layer[start] = int(np.searchsorted(s_rl, des, side="left"))
        elif cfg.plan_horizon_mode == "layers":
            if closed:
                end_layer[start] = (start + int(cfg.min_plan_horizon)) % L
            else:
                end_layer[start] = min(start + int(cfg.min_plan_horizon),
                                       L - 1)
        else:
            raise ValueError(f"unsupported plan_horizon_mode "
                             f"{cfg.plan_horizon_mode!r}")
    h_goal = np.mod(end_layer - np.arange(L), L).astype(np.int32)
    h_goal = np.where(h_goal == 0, L - 1 if closed else 0, h_goal)
    H_max = int(np.max(h_goal))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return Lattice(
        node_pos=f32(node_pos),
        node_psi=f32(node_psi),
        node_valid=torch.as_tensor(node_valid),
        rl_idx=torch.as_tensor(np.asarray(rl_idx, np.int32)),
        nodes_in_layer=torch.as_tensor(np.asarray(nodes_in_layer, np.int32)),
        w=torch.as_tensor(w),
        edge_valid=torch.as_tensor(valid),
        edge_len=f32(edge_len),
        edge_npts=torch.as_tensor(n_pts),
        samples_xy=torch.as_tensor(samples),
        samples_el=torch.as_tensor(_samples_el_table(samples)),
        vg_cost=torch.as_tensor(vg_cost),
        end_layer_for_start=torch.as_tensor(end_layer),
        h_goal_for_start=torch.as_tensor(np.asarray(h_goal, np.int32)),
        refline=f32(refline),
        normvec=f32(normvec),
        alpha=f32(alpha),
        s_rl=f32(s_rl),
        vel_rl=f32(vel_rl),
        raceline=f32(raceline),
        track_width_right=f32(width_right),
        track_width_left=f32(width_left),
        raceline_coeffs=f32(raceline_coeffs),
        glob_rl=f32(glob_rl),
        glob_el=f32(glob_el),
        L=L, N=N, S=S, H_max=H_max, closed=closed,
        lat_resolution=cfg.lat_resolution,
        lat_offset=cfg.lat_offset,
        sampled_resolution=cfg.stepsize_approx,
        veh_width=cfg.veh_width,
        veh_length=cfg.veh_length,
        veh_turn=cfg.veh_turn,
        vel_decrease_lat=cfg.vel_decrease_lat,
        virt_goal_cost=cfg.w_virt_goal,
        md5_params=md5_params,
        graph_id=graph_id,
    )


# ---------------------------------------------------------------------------
# artifact store (the JAX package's npz format)
# ---------------------------------------------------------------------------

def save_lattice(lat: Lattice, path: str) -> None:
    arrays = {k: getattr(lat, k).cpu().numpy() for k in ARRAY_FIELDS}
    meta = {f"meta_{k}": np.asarray(getattr(lat, k)) for k in META_FIELDS}
    meta["meta_VERSION"] = np.asarray(VERSION)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays, **meta)


def load_lattice(path: str) -> Optional[Lattice]:
    """Read an npz lattice artifact onto the CPU; None if it is missing,
    unreadable or of another format version."""
    if not os.path.isfile(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
    except Exception:
        return None
    if float(z.get("meta_VERSION", -1)) != VERSION:
        return None
    arrays = {}
    for k in ARRAY_FIELDS:
        if k == "samples_el" and k not in z:
            arrays[k] = _samples_el_table(z["samples_xy"])
        else:
            arrays[k] = z[k]
    meta = {}
    for k in META_FIELDS:
        v = z[f"meta_{k}"][()]
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, bytes):
            v = v.decode()
        meta[k] = v
    return lattice_from_numpy(arrays, meta)


def load_or_build(globtraj, cfg_path: str, store_path: str,
                  force_recalc: bool = False, graph_id: str = "torch0"):
    """md5-keyed load-or-rebuild of the lattice artifact
    (main_offline_callback.py:56-74), in the JAX package's npz format and
    with its cache key, so either package reads the other's artifact.

    ``globtraj`` may be a CSV path, the name of a built-in synthetic track
    (``"oval"``) or a :class:`GlobalTrajectory`; the key covers the track
    data and the offline INI in every case.  Returns ``(lattice on the CPU,
    built_now)``.
    """
    import hashlib

    from graphbasedlocaltrajectoryplanner_torch.models.track import (
        import_globtraj_csv, make_oval_track)
    from graphbasedlocaltrajectoryplanner_torch.utils.config import md5_file

    gt = None
    if isinstance(globtraj, GlobalTrajectory):
        gt = globtraj
    elif globtraj == "oval":
        gt = make_oval_track()
    if gt is not None:
        h = hashlib.md5()
        for f in dataclasses.fields(gt):
            h.update(np.ascontiguousarray(getattr(gt, f.name)).tobytes())
        md5 = h.hexdigest() + md5_file(cfg_path)
    else:
        md5 = md5_file(globtraj) + md5_file(cfg_path)
    if not force_recalc:
        lat = load_lattice(store_path)
        if lat is not None and lat.md5_params == md5:
            return lat, False
    cfg = OfflineConfig.from_ini(cfg_path)
    if gt is None:
        gt = import_globtraj_csv(globtraj)
    lat = build_lattice(gt, cfg, md5_params=md5, graph_id=graph_id)
    save_lattice(lat, store_path)
    return lat, True
