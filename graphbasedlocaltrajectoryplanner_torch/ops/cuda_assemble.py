"""Path assembly of node chains: the CUDA kernel ``csrc/assemble.cu`` and
its plain PyTorch version.  No Pallas counterpart: the JAX package runs
``pathgen.assemble_action_kernel`` in XLA.

Per row, from the packed edge table ``packed`` (L, N, N, 10)
(``pathgen.packed_edge_table``), the window layers ``win_layers``, the
node chain ``nodes`` (R, H+1) (-1 pad), the horizon ``h_eff`` (R,) in
[1, H] and the start heading ``psi_s`` (R,): the chain's stored edges
give the per-edge sample counts and element lengths; one clamped C2 spline
is fitted through the chain's node positions and resampled with the same
per-edge counts.  Outputs: ``path`` (R, p_max, 5) ``[x y psi kappa el]``,
``n_valid`` (R,) int64, ``node_idx`` (R, H+1) int32 and ``coeffs``
(R, H, 8) ``[x a0..a3, y a0..a3]``.

``win_layers`` is (R, H+1), or (R0, H+1) with R0 dividing R, where row r
reads row ``r // (R / R0)``: the fleet tick's four slots of a scenario,
and the facade's actions, share their scenario's window without a copy.
The kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
from graphbasedlocaltrajectoryplanner_torch.ops.heading import (
    heading_to_dir, dir_to_heading)


def _fit_clamped_chain_padded(points, el, psi_s, psi_e, n_seg, H):
    """Clamped C2 chain fit per row with a per-row segment count
    ``n_seg <= H``: equations at or beyond the true end pin the tangent to
    the end heading, keeping the tridiagonal system at static size.

    ``points`` (R, H+1, 2), ``el`` (R, H), ``psi_s``/``psi_e``/``n_seg``
    (R,).  Returns coefficients (R, H, 4, 2)."""
    seg_len = torch.clamp(el, min=1e-9)
    m0 = heading_to_dir(psi_s)                                  # (R, 2)
    mn = heading_to_dir(psi_e)
    lam = seg_len[:, :-1] / seg_len[:, 1:]                      # (R, H-1)
    dp_over_l = (points[:, 1:] - points[:, :-1]) / seg_len[..., None]
    rhs = 3.0 * (dp_over_l[:, :-1] + lam[..., None] * dp_over_l[:, 1:])
    rhs = torch.cat([(rhs[:, 0] + (-m0))[:, None], rhs[:, 1:]], dim=1)
    ones = torch.ones_like(lam)
    lower = torch.cat([ones[:, :1] * 0.0, ones[:, 1:]], dim=1)
    diag = 2.0 * (1.0 + lam)
    upper = lam
    j = torch.arange(lam.shape[1], device=lam.device)
    pin = j[None, :] >= (n_seg.long()[:, None] - 1)
    lower = torch.where(pin, 0.0, lower)
    diag = torch.where(pin, 1.0, diag)
    upper = torch.where(pin, 0.0, upper)
    rhs = torch.where(pin[..., None], mn[:, None, :], rhs)
    u = spl._thomas(lower.T, diag.T, upper.T,
                    rhs.transpose(0, 1)).transpose(0, 1)        # (R, H-1, 2)
    m = torch.cat([m0[:, None], u, mn[:, None]], dim=1)        # (R, H+1, 2)
    past = torch.arange(H + 1, device=lam.device)[None, :] \
        >= n_seg.long()[:, None]
    m = torch.where(past[..., None], mn[:, None, :], m)
    m = torch.cat([m0[:, None], m[:, 1:]], dim=1)
    return spl._coeffs_from_tangents(points, m, seg_len)


def assemble_path_plain(packed, win_layers, nodes, h_eff, psi_s,
                        p_max: int):
    """Plain version (the specification of the kernel): per-edge sample
    counts give the fused index layout (shared endpoints deduplicated),
    element lengths come from the pre-refit stored edges, and one
    curvature-continuous spline through the node positions (clamped
    headings, chord lengths = stored edge lengths) is re-sampled with the
    same per-segment counts for x, y, psi, kappa.  Arguments and outputs
    as the module docstring says."""
    H = nodes.shape[1] - 1
    dev = nodes.device
    R = nodes.shape[0]
    if win_layers.shape[0] != R:
        win_layers = win_layers.repeat_interleave(
            R // win_layers.shape[0], dim=0)
    rows = torch.arange(R, device=dev)
    h_eff = h_eff.long()
    nsafe = nodes.long().clamp(0, packed.shape[1] - 1)
    seg_active = torch.arange(H, device=dev)[None, :] < h_eff[:, None]

    m_all = nsafe[:, torch.clamp(torch.arange(H + 1, device=dev) + 1, 0, H)]
    rows_e = packed[win_layers.long(), nsafe, m_all]            # (R, H+1, 10)
    npts_e = torch.where(seg_active, rows_e[:, :H, 0].to(torch.int32), 1)
    len_e = torch.where(seg_active, rows_e[:, :H, 1], 1.0)
    ecoeffs = rows_e[..., 2:10]                                 # (R, H+1, 8)

    node_idx = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                          torch.cumsum(npts_e - 1, dim=1)], dim=1)
    n_valid = node_idx[rows, h_eff] + 1

    chain_pos = ecoeffs[..., 0:2]
    end_pos = chain_pos[rows, h_eff]
    chain_pos = torch.where(
        (torch.arange(H + 1, device=dev)[None, :] > h_eff[:, None])[..., None],
        end_pos[:, None, :], chain_pos)

    # end heading: analytic heading at t=1 of the last active edge
    c_last = ecoeffs[rows, h_eff - 1].reshape(R, 4, 2)
    psi_e, _ = spl.head_curv_an(c_last, 1.0)

    coeffs = _fit_clamped_chain_padded(chain_pos, len_e, psi_s, psi_e,
                                       h_eff, H)                # (R, H, 4, 2)

    # sample the refit chain with the per-segment point counts
    idxp = torch.arange(p_max, device=dev)
    seg_id = torch.sum(node_idx[:, None, 1:] <= idxp[None, :, None], dim=2)
    seg_id = torch.clamp(seg_id, 0, H - 1)                      # (R, p_max)
    table = torch.cat([coeffs.reshape(R, H, 8),
                       node_idx[:, :H, None].to(torch.float32),
                       npts_e[..., None].to(torch.float32),
                       ecoeffs[:, :H]], dim=-1)                  # (R, H, 18)
    rows_p = torch.gather(table, 1, seg_id[..., None].expand(R, p_max, 18))
    start_p = rows_p[..., 8].to(torch.int64)
    npts_p = rows_p[..., 9].to(torch.int64)

    within = (idxp[None, :] - start_p).to(torch.float32)
    den = torch.clamp(npts_p - 1, min=1)
    t = torch.clamp(within / den, 0.0, 1.0)
    ax0, ay0, ax1, ay1, ax2, ay2, ax3, ay3 = rows_p[..., :8].unbind(-1)
    px = ax0 + t * (ax1 + t * (ax2 + t * ax3))
    py = ay0 + t * (ay1 + t * (ay2 + t * ay3))
    dx = ax1 + t * (2.0 * ax2 + t * 3.0 * ax3)
    dy = ay1 + t * (2.0 * ay2 + t * 3.0 * ay3)
    ddx = 2.0 * ax2 + t * 6.0 * ax3
    ddy = 2.0 * ay2 + t * 6.0 * ay3
    psi = dir_to_heading(dx, dy)
    denom = torch.pow(dx ** 2 + dy ** 2, 1.5)
    kappa = (dx * ddy - dy * ddx) / torch.clamp(denom, min=1e-12)
    # per-point element length of the pre-refit stored edge, recomputed from
    # the edge coefficients with the offline table's formula
    t2 = torch.clamp((within + 1.0) / den, 0.0, 1.0)
    ex0, ey0, ex1, ey1, ex2, ey2, ex3, ey3 = rows_p[..., 10:18].unbind(-1)
    dxe = (ex0 + t2 * (ex1 + t2 * (ex2 + t2 * ex3))
           - (ex0 + t * (ex1 + t * (ex2 + t * ex3))))
    dye = (ey0 + t2 * (ey1 + t2 * (ey2 + t2 * ey3))
           - (ey0 + t * (ey1 + t * (ey2 + t * ey3))))
    el = torch.sqrt(dxe * dxe + dye * dye)
    tail = idxp[None, :] >= (n_valid[:, None] - 1)
    el = torch.where(tail, 0.0, el)
    path = torch.stack([px, py, psi, kappa, el], dim=-1)
    # final point: the refit's last real segment at t=1; padding rows
    # freeze at the same values
    c_fin = coeffs[rows, h_eff - 1]                              # (R, 4, 2)
    psi_f, kappa_f = spl.head_curv_an(c_fin, 1.0)
    pt_f = spl.eval_spline(c_fin, 1.0)
    fin = torch.stack([pt_f[:, 0], pt_f[:, 1], psi_f, kappa_f,
                       torch.zeros_like(psi_f)], dim=-1)
    path = torch.where(tail[..., None], fin[:, None, :], path)
    coeffs_flat = torch.cat([coeffs[..., 0], coeffs[..., 1]], dim=-1)
    return dict(path=path, n_valid=n_valid,
                node_idx=node_idx.to(torch.int32), coeffs=coeffs_flat)


def kernel_args(packed, win_layers, nodes, h_eff, psi_s, p_max: int):
    """``(c_args, out, keep)``: the checked arguments of the kernel's C
    entry point (all but the stream), the outputs it fills, and the inputs
    that must live until the launch is enqueued.  Raises on a wrong dtype,
    shape or layout before anything is launched."""
    if packed.dim() != 4 or packed.shape[1] != packed.shape[2] \
            or packed.shape[3] != 10:
        raise ValueError(f"packed: expected (L, N, N, 10), got "
                         f"{tuple(packed.shape)}")
    L, N = packed.shape[:2]
    if nodes.dim() != 2 or nodes.shape[1] < 3:
        raise ValueError(f"nodes: expected (R, H+1) with H >= 2, got "
                         f"{tuple(nodes.shape)}")
    R, Hp1 = nodes.shape
    if win_layers.dim() != 2 or win_layers.shape[1] != Hp1 \
            or win_layers.shape[0] == 0 or R % win_layers.shape[0]:
        raise ValueError(f"win_layers: expected (R0, {Hp1}) with R0 "
                         f"dividing {R}, got {tuple(win_layers.shape)}")
    if int(p_max) < 1:
        raise ValueError(f"p_max: expected at least 1, got {p_max}")
    R0 = win_layers.shape[0]
    p_max = int(p_max)
    cb.require(packed, torch.float32, tuple(packed.shape), "packed")
    win, w_win = cb.index_tensor(win_layers, (R0, Hp1), "win_layers")
    nod, w_nod = cb.index_tensor(nodes, (R, Hp1), "nodes")
    heff, w_heff = cb.index_tensor(h_eff, (R,), "h_eff")
    psi = psi_s.contiguous()
    cb.require(psi, torch.float32, (R,), "psi_s")
    dev = packed.device
    out = dict(
        path=torch.empty((R, p_max, 5), dtype=torch.float32, device=dev),
        n_valid=torch.empty((R,), dtype=torch.int64, device=dev),
        node_idx=torch.empty((R, Hp1), dtype=torch.int32, device=dev),
        coeffs=torch.empty((R, Hp1 - 1, 8), dtype=torch.float32,
                           device=dev))
    wide = w_win | w_nod << 1 | w_heff << 2
    c_args = (cb.ptr(packed), cb.ptr(win), cb.ptr(nod), cb.ptr(heff),
              cb.ptr(psi), cb.ptr(out["path"]), cb.ptr(out["n_valid"]),
              cb.ptr(out["node_idx"]), cb.ptr(out["coeffs"]),
              R, R // R0, Hp1 - 1, L, N, p_max, wide)
    return c_args, out, (packed, win, nod, heff, psi)


def assemble_path(packed, win_layers, nodes, h_eff, psi_s, p_max: int):
    """The assembled paths: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  ``win_layers``, ``nodes`` and ``h_eff`` go to
    the kernel as they are, int32 or int64."""
    if packed.device.type == "cpu":
        return assemble_path_plain(packed, win_layers, nodes, h_eff, psi_s,
                                   p_max)
    c_args, out, _keep = kernel_args(packed, win_layers, nodes, h_eff,
                                     psi_s, p_max)
    cb.check(cb.load("assemble")(*c_args, cb.stream()), "assemble")
    assemble_path.launches += 1
    return out


assemble_path.launches = 0
