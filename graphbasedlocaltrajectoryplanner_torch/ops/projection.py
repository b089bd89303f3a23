"""Arc-length projection helpers (torch) — counterpart of the JAX package's
``ops/projection.py`` (reference ``closest_path_index.py`` /
``get_s_coord.py``), batched: a polyline ``(..., n, 2)`` and positions
``(..., 2)`` broadcast over their leading dims."""

from __future__ import annotations

import math

import torch


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...], :] for x (..., n, C) and idx (...,) (broadcast)."""
    lead = torch.broadcast_shapes(x.shape[:-2], idx.shape)
    x = x.expand(lead + x.shape[-2:])
    idx = idx.expand(lead)
    return torch.gather(x, -2, idx[..., None, None].expand(
        lead + (1, x.shape[-1])))[..., 0, :]


def closest_path_index(path: torch.Tensor, pos: torch.Tensor,
                       valid_mask: torch.Tensor = None):
    """Index of the closest point of ``path`` (..., n, 2) to ``pos``
    (..., 2) (first on ties), and the squared distances (..., n).
    ``valid_mask`` (..., n) excludes padded rows (their distance is inf)."""
    d2 = torch.sum((path - pos[..., None, :]) ** 2, dim=-1)
    if valid_mask is not None:
        d2 = torch.where(valid_mask, d2, math.inf)
    return torch.argmin(d2, dim=-1), d2


def _angle3pt(a, b, c):
    """Angle turning from a to c around b, wrapped to (-pi, pi]."""
    ang = torch.atan2(c[..., 1] - b[..., 1], c[..., 0] - b[..., 0]) \
        - torch.atan2(a[..., 1] - b[..., 1], a[..., 0] - b[..., 0])
    return torch.where(ang > math.pi, ang - 2 * math.pi,
                       torch.where(ang <= -math.pi, ang + 2 * math.pi, ang))


def get_s_coord(ref_line: torch.Tensor, pos: torch.Tensor,
                s_array: torch.Tensor = None, closed: bool = False,
                valid_mask: torch.Tensor = None):
    """Continuous s-coordinate of ``pos`` on a polyline: closest vertex, the
    neighbour whose 3-point angle at ``pos`` is larger holds the foot
    point, perpendicular drop onto that segment.

    :param ref_line: (..., n, 2); ``pos``: (..., 2); ``s_array``: (..., n),
        default the polyline's cumulative chord length; ``valid_mask``
        (..., n) excludes padded rows from the closest-vertex search.
    :returns: (s (...,), (idx_a, idx_b)) the ordered neighbouring indices
              enclosing the projection.
    """
    n = ref_line.shape[-2]
    idx_nb, _ = closest_path_index(ref_line, pos, valid_mask)
    if closed:
        idx1 = torch.remainder(idx_nb - 1, n)
        idx2 = torch.remainder(idx_nb + 1, n)
    else:
        idx1 = torch.clamp(idx_nb - 1, min=0)
        idx2 = torch.clamp(idx_nb + 1, max=n - 1)
    p_nb = _take(ref_line, idx_nb)
    ang1 = torch.abs(_angle3pt(p_nb, pos, _take(ref_line, idx1)))
    ang2 = torch.abs(_angle3pt(p_nb, pos, _take(ref_line, idx2)))
    use_prev = ang1 > ang2
    a_idx = torch.where(use_prev, idx1, idx_nb)
    b_idx = torch.where(use_prev, idx_nb, idx2)
    a_pos = _take(ref_line, a_idx)
    b_pos = _take(ref_line, b_idx)
    if s_array is None:
        d = torch.linalg.vector_norm(torch.diff(ref_line, dim=-2), dim=-1)
        s_array = torch.cat([torch.zeros_like(d[..., :1]),
                             torch.cumsum(d, dim=-1)], dim=-1)
    ab = b_pos - a_pos
    denom = torch.clamp(ab[..., 0] * ab[..., 0] + ab[..., 1] * ab[..., 1],
                        min=1e-12)
    d = pos - a_pos
    t = (d[..., 0] * ab[..., 0] + d[..., 1] * ab[..., 1]) / denom
    foot = a_pos + t[..., None] * ab
    fa = foot - a_pos
    ds = torch.sqrt(fa[..., 0] * fa[..., 0] + fa[..., 1] * fa[..., 1])
    s_lead = torch.broadcast_shapes(s_array.shape[:-1], a_idx.shape)
    s = torch.gather(s_array.expand(s_lead + s_array.shape[-1:]), -1,
                     a_idx.expand(s_lead)[..., None])[..., 0] + ds
    idx_a = torch.where(ang1 >= ang2, idx1, idx_nb)
    idx_b = torch.where(ang1 >= ang2, idx_nb, idx2)
    return s, (idx_a, idx_b)


def check_inside_bounds(bound1: torch.Tensor, bound2: torch.Tensor,
                        pos: torch.Tensor):
    """On-track check (reference check_inside_bounds.py:27-57): the bound
    pair interpolated around the closest centerline segment (50 steps, as
    ``np.linspace``), and the position no farther from either bound than
    the local track width.  ``bound1``/``bound2`` (n, 2) of a closed track,
    ``pos`` (..., 2) -> (...,) bool."""
    centerline = 0.5 * (bound1 + bound2)
    s_zero = torch.zeros(centerline.shape[:-1], dtype=pos.dtype,
                         device=pos.device)
    _, (ia, ib) = get_s_coord(centerline, pos, s_zero, closed=True)
    w = torch.linspace(0.0, 1.0, 50, dtype=pos.dtype,
                       device=pos.device)[:, None]

    def between(line):
        return line[ia][..., None, :] * (1 - w) + line[ib][..., None, :] * w
    b1, b2, cl = between(bound1), between(bound2), between(centerline)
    k = torch.argmin(torch.sum((cl - pos[..., None, :]) ** 2, dim=-1),
                     dim=-1)
    pick = k[..., None, None].expand(k.shape + (1, 2))
    b1k = torch.gather(b1, -2, pick)[..., 0, :]
    b2k = torch.gather(b2, -2, pick)[..., 0, :]
    d_track2 = torch.sum((b1k - b2k) ** 2, dim=-1)
    d1 = torch.sum((b1k - pos) ** 2, dim=-1)
    d2 = torch.sum((b2k - pos) ** 2, dim=-1)
    return ~((d1 > d_track2) | (d2 > d_track2))
