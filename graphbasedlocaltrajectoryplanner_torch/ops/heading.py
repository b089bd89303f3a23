"""Heading / curvature utilities (torch).

Heading ``psi`` is measured with ``0.0`` pointing north (+y axis), positive
counter-clockwise, wrapped to ``[-pi, pi)``; the direction vector of a
heading is ``(-sin psi, cos psi)``.  Counterpart of the JAX package's
``ops/heading.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


def normalize_psi(psi: torch.Tensor) -> torch.Tensor:
    """Wrap an angle tensor to the interval [-pi, pi) (floored modulo)."""
    return torch.remainder(psi + math.pi, TWO_PI) - math.pi


def heading_to_dir(psi: torch.Tensor) -> torch.Tensor:
    """Unit direction vector for heading ``psi``; shape ``psi.shape + (2,)``."""
    return torch.stack([-torch.sin(psi), torch.cos(psi)], dim=-1)


def dir_to_heading(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Heading (0 = north) of direction vector components."""
    return normalize_psi(torch.atan2(dy, dx) - math.pi / 2.0)


def calc_head_curv_num(path: torch.Tensor,
                       el_lengths: torch.Tensor,
                       is_closed: bool,
                       stepsize_psi_preview: float = 1.0,
                       stepsize_psi_review: float = 1.0,
                       stepsize_curv_preview: float = 2.0,
                       stepsize_curv_review: float = 2.0):
    """Numerical heading + curvature of a polyline (tph
    ``calc_head_curv_num`` semantics): the tangent at point ``i`` is the
    chord from ``i - review`` to ``i + preview`` steps, the step counts
    being ``max(round(stepsize / mean(el_lengths)), 1)``; curvature is the
    wrapped heading difference over the curvature window divided by the
    summed element lengths.  Computes in the dtype of ``path``.

    :param path:        (n, 2) points.
    :param el_lengths:  (n,) for closed paths (incl. the wrap segment) or
                        (n-1,) for unclosed paths.
    :returns: (psi, kappa), each (n,).
    """
    el_lengths = el_lengths.to(path.dtype)
    n = path.shape[0]
    avg_el = float(np.mean(el_lengths.cpu().numpy()))
    step_psi_prev = max(round(stepsize_psi_preview / avg_el), 1)
    step_psi_rev = max(round(stepsize_psi_review / avg_el), 1)
    step_curv_prev = max(round(stepsize_curv_preview / avg_el), 1)
    step_curv_rev = max(round(stepsize_curv_review / avg_el), 1)
    idx = torch.arange(n, device=path.device)

    if is_closed:
        tang = path[(idx + step_psi_prev) % n] - path[(idx - step_psi_rev) % n]
        psi = dir_to_heading(tang[:, 0], tang[:, 1])
        dpsi = normalize_psi(psi[(idx + step_curv_prev) % n]
                             - psi[(idx - step_curv_rev) % n])
        win = step_curv_prev + step_curv_rev
        csum = torch.cat([torch.zeros(1, dtype=path.dtype, device=path.device),
                          torch.cumsum(el_lengths.repeat(3), 0)])
        start = idx + n - step_curv_rev
        seg_len = csum[start + win] - csum[start]
    else:
        lo = torch.clamp(idx - step_psi_rev, min=0)
        hi = torch.clamp(idx + step_psi_prev, max=n - 1)
        tang = path[hi] - path[lo]
        psi = dir_to_heading(tang[:, 0], tang[:, 1])
        lo_c = torch.clamp(idx - step_curv_rev, min=0)
        hi_c = torch.clamp(idx + step_curv_prev, max=n - 1)
        dpsi = normalize_psi(psi[hi_c] - psi[lo_c])
        csum = torch.cat([torch.zeros(1, dtype=path.dtype, device=path.device),
                          torch.cumsum(el_lengths, 0)])
        seg_len = csum[hi_c] - csum[lo_c]
    kappa = dpsi / torch.clamp(seg_len, min=1e-12)
    return psi, kappa
