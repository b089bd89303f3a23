"""Cubic-spline kernels (torch) — counterpart of the JAX package's
``ops/splines.py`` (tph ``calc_splines`` / ``interp_splines`` /
``calc_head_curv_an``).

Spline model: per segment a parametric cubic
``x(t) = a0 + a1 t + a2 t^2 + a3 t^3`` with ``t in [0, 1]`` (independently
for x and y); coefficient tensors are shaped ``(..., 4, 2)``.  Chains are
fitted through their nodal arc tangents ``m_j`` (tridiagonal system with
clamped or periodic boundaries) solved by a Thomas sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops.heading import (
    heading_to_dir, dir_to_heading)


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 2, as sqrt(x*x + y*y)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def fit_hermite(p0, p1, psi0, psi1):
    """Cubic segment through ``p0 -> p1`` with boundary headings (tangent
    magnitude = point distance).  Batched over leading dims; returns
    ``(..., 4, 2)``."""
    dist = _norm2(p1 - p0)[..., None]
    d0 = heading_to_dir(psi0) * dist
    d1 = heading_to_dir(psi1) * dist
    dp = p1 - p0
    return torch.stack([p0, d0, 3.0 * dp - 2.0 * d0 - d1,
                        -2.0 * dp + d0 + d1], dim=-2)


def _thomas(lower, diag, upper, rhs):
    """Tridiagonal solve (Thomas algorithm) along axis 0.

    ``lower``, ``diag``, ``upper``: (n, *batch); ``rhs``: (n, *batch) or
    (n, *batch, k).  ``lower[0]`` and ``upper[-1]`` are ignored.
    """
    if rhs.dim() > diag.dim():
        lower, diag, upper = lower[..., None], diag[..., None], upper[..., None]
    n = diag.shape[0]
    c_prev = diag[0] * 0.0
    d_prev = rhs[0] * 0.0
    cs, ds = [], []
    for i in range(n):
        denom = diag[i] - lower[i] * c_prev
        c_prev = upper[i] / denom
        d_prev = (rhs[i] - lower[i] * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x = rhs[0] * 0.0
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x = ds[i] - cs[i] * x
        xs[i] = x
    return torch.stack(xs)


def _cyclic_thomas(lower, diag, upper, rhs):
    """Cyclic tridiagonal solve of one system (wrap terms ``lower[0]`` and
    ``upper[-1]``) via a Sherman-Morrison correction on :func:`_thomas`.
    ``lower/diag/upper``: (n,); ``rhs``: (n,) or (n, k)."""
    n = diag.shape[0]
    alpha = lower[0]
    beta = upper[-1]
    gamma = -diag[0]
    diag_mod = diag.clone()
    diag_mod[0] = diag_mod[0] - gamma
    diag_mod[n - 1] = diag_mod[n - 1] - alpha * beta / gamma
    u = torch.zeros(n, dtype=diag.dtype, device=diag.device)
    u[0] = gamma
    u[n - 1] = beta
    y = _thomas(lower, diag_mod, upper, rhs)
    if rhs.dim() > 1:
        q = _thomas(lower, diag_mod, upper, u[:, None])[:, 0]
        v_y = y[0] + (alpha / gamma) * y[n - 1]
        v_q = q[0] + (alpha / gamma) * q[n - 1]
        return y - q[:, None] * (v_y / (1.0 + v_q))[None, :]
    q = _thomas(lower, diag_mod, upper, u)
    v_y = y[0] + (alpha / gamma) * y[n - 1]
    v_q = q[0] + (alpha / gamma) * q[n - 1]
    return y - q * (v_y / (1.0 + v_q))


def _coeffs_from_tangents(points, m, seg_len):
    """Hermite coefficients per segment from nodal arc tangents.

    ``points``, ``m``: (..., n+1, 2); ``seg_len``: (..., n).
    Returns (..., n, 4, 2)."""
    dp = points[..., 1:, :] - points[..., :-1, :]
    mL0 = m[..., :-1, :] * seg_len[..., None]
    mL1 = m[..., 1:, :] * seg_len[..., None]
    return torch.stack([points[..., :-1, :], mL0,
                        3.0 * dp - 2.0 * mL0 - mL1,
                        -2.0 * dp + mL0 + mL1], dim=-2)


def fit_clamped_chain(points, psi_s, psi_e, el_lengths=None):
    """C2 cubic chain through ``points`` (n, 2) with clamped boundary
    headings (tph ``calc_splines`` with psi_s/psi_e).  Returns (n-1, 4, 2)."""
    n_seg = points.shape[0] - 1
    if el_lengths is None:
        seg_len = _norm2(points[1:] - points[:-1])
    else:
        seg_len = el_lengths
    seg_len = torch.clamp(seg_len, min=1e-12)
    m0 = heading_to_dir(psi_s)
    mn = heading_to_dir(psi_e)
    if n_seg == 1:
        return _coeffs_from_tangents(points, torch.stack([m0, mn]), seg_len)
    lam = seg_len[:-1] / seg_len[1:]
    dp_over_l = (points[1:] - points[:-1]) / seg_len[:, None]
    rhs = 3.0 * (dp_over_l[:-1] + lam[:, None] * dp_over_l[1:])
    rhs[0] = rhs[0] + (-m0)
    rhs[-1] = rhs[-1] + (-lam[-1] * mn)
    ones = torch.ones_like(lam)
    lower = torch.cat([ones[:1] * 0.0, ones[1:]])
    diag = 2.0 * (1.0 + lam)
    upper = torch.cat([lam[:-1], ones[:1] * 0.0])
    m_int = _thomas(lower, diag, upper, rhs)
    m = torch.cat([m0[None], m_int, mn[None]], dim=0)
    return _coeffs_from_tangents(points, m, seg_len)


def fit_periodic_chain(points_closed, el_lengths=None):
    """C2 periodic cubic chain through ``points_closed`` (n+1, 2) with the
    first point repeated at the end (periodic ``m_0 = m_n``).  Returns
    (n, 4, 2)."""
    if el_lengths is None:
        seg_len = _norm2(points_closed[1:] - points_closed[:-1])
    else:
        seg_len = el_lengths
    seg_len = torch.clamp(seg_len, min=1e-12)
    prev_len = torch.roll(seg_len, 1)
    lam = prev_len / seg_len
    dp_over_l = (points_closed[1:] - points_closed[:-1]) / seg_len[:, None]
    rhs = 3.0 * (torch.roll(dp_over_l, 1, dims=0) + lam[:, None] * dp_over_l)
    lower = torch.ones_like(lam)
    diag = 2.0 * (1.0 + lam)
    m = _cyclic_thomas(lower, diag, lam, rhs)
    m_ext = torch.cat([m, m[:1]], dim=0)
    return _coeffs_from_tangents(points_closed, m_ext, seg_len)


def eval_spline(coeffs, t):
    """Evaluate segment(s) ``coeffs`` (..., 4, 2) at ``t`` (...,) -> (..., 2)."""
    t = cuda_graph.as_tensor(t, coeffs.dtype, coeffs.device)[..., None]
    a0, a1, a2, a3 = (coeffs[..., 0, :], coeffs[..., 1, :],
                      coeffs[..., 2, :], coeffs[..., 3, :])
    return a0 + t * (a1 + t * (a2 + t * a3))


def eval_spline_d(coeffs, t):
    """First derivative wrt t."""
    t = cuda_graph.as_tensor(t, coeffs.dtype, coeffs.device)[..., None]
    a1, a2, a3 = coeffs[..., 1, :], coeffs[..., 2, :], coeffs[..., 3, :]
    return a1 + t * (2.0 * a2 + t * 3.0 * a3)


def eval_spline_dd(coeffs, t):
    """Second derivative wrt t."""
    t = cuda_graph.as_tensor(t, coeffs.dtype, coeffs.device)[..., None]
    a2, a3 = coeffs[..., 2, :], coeffs[..., 3, :]
    return 2.0 * a2 + t * 6.0 * a3


def head_curv_an(coeffs, t):
    """Analytic heading + curvature at parameter(s) t (tph
    ``calc_head_curv_an``)."""
    d = eval_spline_d(coeffs, t)
    dd = eval_spline_dd(coeffs, t)
    psi = dir_to_heading(d[..., 0], d[..., 1])
    denom = torch.pow(d[..., 0] ** 2 + d[..., 1] ** 2, 1.5)
    kappa = (d[..., 0] * dd[..., 1] - d[..., 1] * dd[..., 0]) \
        / torch.clamp(denom, min=1e-12)
    return psi, kappa


def spline_lengths(coeffs, n_interp: int = 15):
    """Approximate arc length per segment by summing ``n_interp - 1``
    chords.  ``coeffs``: (..., 4, 2)."""
    t = torch.linspace(0.0, 1.0, n_interp, dtype=coeffs.dtype,
                       device=coeffs.device)
    t_b = t.expand(coeffs.shape[:-2] + (n_interp,))
    pts = eval_spline(coeffs[..., None, :, :], t_b)
    return torch.sum(_norm2(pts[..., 1:, :] - pts[..., :-1, :]), dim=-1)


def sample_uniform(coeffs, stepsize_approx: float, s_max: int,
                   n_interp: int = 15):
    """Sample one cubic segment ``coeffs`` (4, 2) t-uniformly, padded to
    ``s_max`` points (tph ``interp_splines(..., stepsize_approx,
    incl_last_point=True)`` on a single segment, gen_edges.py:128-131):
    ``ceil(length / step) + 1`` points, at least 2.

    Returns (points (s_max, 2), t_values (s_max,), n_pts 0-dim int32,
    length); padding repeats the end point (t = 1).
    """
    length = spline_lengths(coeffs, n_interp)
    n_pts = torch.clamp(
        torch.ceil(length / stepsize_approx).to(torch.int32) + 1, max=s_max)
    n_pts = torch.clamp(n_pts, min=2)
    idx = torch.arange(s_max, device=coeffs.device)
    t_vals = torch.clamp(idx / torch.clamp(n_pts - 1, min=1), max=1.0)
    pts = eval_spline(coeffs, t_vals)
    return pts, t_vals, n_pts, length


def sample_chain_stepnum(coeffs, stepnum, total_pts: int):
    """Sample chains of segments with a fixed number of points per segment
    (tph ``interp_splines(..., stepnum_fixed=...)``): ``t`` uniform in
    [0, 1] per segment, a shared endpoint emitted once, the final endpoint
    included; padding repeats the final point.  Batched over leading axes.

    :param coeffs: (..., n_seg, 4, 2).
    :param stepnum: (..., n_seg) int, points per segment with both ends.
    :param total_pts: output size (>= sum(stepnum - 1) + 1).
    :returns: (points (..., total_pts, 2), seg_idx (..., total_pts),
        t (..., total_pts))
    """
    dev = coeffs.device
    n_seg = coeffs.shape[-3]
    stepnum = cuda_graph.as_tensor(stepnum, device=dev).long()
    counts = torch.clamp(stepnum - 1, min=0)
    starts = torch.cat([torch.zeros_like(counts[..., :1]),
                        torch.cumsum(counts, dim=-1)], dim=-1)
    n_total = starts[..., -1:] + 1                          # (..., 1)
    idx = torch.arange(total_pts, device=dev)
    seg_idx = torch.sum(starts[..., None, 1:] <= idx[:, None], dim=-1)
    seg_idx = torch.clamp(seg_idx, 0, n_seg - 1)
    within = idx - torch.gather(starts, -1, seg_idx)
    t = within / torch.clamp(torch.gather(stepnum, -1, seg_idx) - 1, min=1)
    last_seg = torch.clamp(torch.sum(starts[..., 1:] <= n_total - 1, dim=-1,
                                     keepdim=True), 0, n_seg - 1)
    end = idx >= n_total - 1
    t = torch.where(end, 1.0, t).to(coeffs.dtype)
    seg_idx = torch.where(end, last_seg, seg_idx)
    c = torch.gather(coeffs, -3, seg_idx[..., None, None].expand(
        seg_idx.shape + coeffs.shape[-2:]))
    return eval_spline(c, t), seg_idx, t


def dense_calc_splines_np(path: np.ndarray,
                          el_lengths: np.ndarray = None,
                          psi_s: float = None,
                          psi_e: float = None):
    """Dense NumPy construction of the reference linear system (tph
    ``calc_splines`` layout), the golden of the spline tests.  Returns
    (coeffs_x (n, 4), coeffs_y (n, 4))."""
    path = np.asarray(path, float)
    closed = np.all(np.isclose(path[0], path[-1]))
    if el_lengths is None:
        el_lengths = np.sqrt(np.sum(np.diff(path, axis=0) ** 2, axis=1))
    else:
        el_lengths = np.asarray(el_lengths, float)
    if closed:
        el_lengths = np.append(el_lengths, el_lengths[0])
    scaling = el_lengths[:-1] / el_lengths[1:]

    n = path.shape[0] - 1
    M = np.zeros((4 * n, 4 * n))
    bx = np.zeros(4 * n)
    by = np.zeros(4 * n)
    tmpl = np.array([[1., 0., 0., 0., 0., 0., 0., 0.],
                     [1., 1., 1., 1., 0., 0., 0., 0.],
                     [0., 1., 2., 3., 0., -1., 0., 0.],
                     [0., 0., 2., 6., 0., 0., -2., 0.]])
    for i in range(n):
        j = 4 * i
        if i < n - 1:
            M[j:j + 4, j:j + 8] = tmpl
            M[j + 2, j + 5] *= scaling[i]
            M[j + 3, j + 6] *= scaling[i] ** 2
        else:
            M[j, j:j + 4] = [1., 0., 0., 0.]
            M[j + 1, j:j + 4] = [1., 1., 1., 1.]
        bx[j], bx[j + 1] = path[i, 0], path[i + 1, 0]
        by[j], by[j + 1] = path[i, 1], path[i + 1, 1]

    if not closed:
        M[-2, 1] = 1.0
        bx[-2] = np.cos(psi_s + np.pi / 2) * el_lengths[0]
        by[-2] = np.sin(psi_s + np.pi / 2) * el_lengths[0]
        M[-1, -4:] = [0., 1., 2., 3.]
        bx[-1] = np.cos(psi_e + np.pi / 2) * el_lengths[-1]
        by[-1] = np.sin(psi_e + np.pi / 2) * el_lengths[-1]
    else:
        M[-2, 1] = scaling[-1]
        M[-2, -3:] = [-1., -2., -3.]
        M[-1, 2] = 2.0 * scaling[-1] ** 2
        M[-1, -2:] = [-2., -6.]

    cx = np.linalg.solve(M, bx).reshape(n, 4)
    cy = np.linalg.solve(M, by).reshape(n, 4)
    return cx, cy
