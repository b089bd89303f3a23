"""Masked 4-slot min-plus window DP: the CUDA kernel ``csrc/window_dp.cu``
and its plain PyTorch version (counterpart of the JAX package's
``ops/pallas_window.py``).

Slots: 0 straight (object-blocked), 1 follow (zones only), 2 left and
3 right (object-blocked plus the overtake split at the obstacle layer).
Returns ``best`` (B, 4, H+1, N) float32 and ``bp`` (B, 4, H+1, N) int32;
row h = 0 is one-hot at the start node and its backpointers are -1.
"""

from __future__ import annotations

import ctypes

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops.search import INF, FEAS_THRESH

N_SLOTS = 4


def fused_window_dp_plain(w, zone_block, start_layer, start_node,
                          slab_layers, hit_slab, p_obs, in_win, obs_node,
                          last_nodes, w_last_factors, closed: bool,
                          h_max: int):
    """Plain version: the batched scan step of
    ``planner/pathgen.plan_window_kernel``.

    :param w: (L, N, N) offline costs; ``zone_block`` (L, N) shared or
        (B, L, N) per scenario; ``start_layer``, ``start_node``, ``p_obs``,
        ``obs_node`` (B,) int; ``in_win`` (B,) bool; ``slab_layers``
        (B, O, 2); ``hit_slab`` (B, O, 2, N, N) bool; ``last_nodes``
        (B, n_last); ``w_last_factors`` (n_last - 1,).
    """
    L, N, _ = w.shape
    B = start_layer.shape[0]
    H = h_max
    dev = w.device
    n_last = last_nodes.shape[1]
    bidx = torch.arange(B, device=dev)
    node_ids = torch.arange(N, device=dev)
    sl = start_layer.long()
    slab = slab_layers.long()
    last = last_nodes.long()
    p_obs = p_obs.long()
    zb = zone_block if zone_block.dim() == 3 else zone_block[None].expand(
        B, L, N)
    blk_left = node_ids[None, :] >= obs_node.long()[:, None]      # (B, N)
    blk_right = ~blk_left

    best = torch.full((B, N_SLOTS, N), INF, dtype=w.dtype, device=dev)
    best[bidx, :, start_node.long()] = 0.0
    bests = [best]
    bps = [torch.full((B, N_SLOTS, N), -1, dtype=torch.int32, device=dev)]
    for h in range(H):
        layer = torch.remainder(sl + h, L)
        nxt = torch.remainder(layer + 1, L)
        wl = w[layer]                                              # (B,N,N)
        if not closed:
            wl = torch.where((sl + h >= L - 1)[:, None, None], INF, wl)
        wl = torch.where(zb[bidx, layer][:, :, None]
                         | zb[bidx, nxt][:, None, :], INF, wl)
        if n_last >= 2 and h < n_last - 1:
            a, b = last[:, h], last[:, h + 1]
            at_ab = (node_ids[None, :, None] == a[:, None, None]) \
                & (node_ids[None, None, :] == b[:, None, None]) \
                & ((a >= 0) & (b >= 0))[:, None, None]
            wl = torch.where(at_ab & (wl < FEAS_THRESH),
                             wl * w_last_factors[h], wl)
        is_m1 = (slab[:, :, 0] == layer[:, None])[:, :, None, None]
        is_0 = (slab[:, :, 1] == layer[:, None])[:, :, None, None]
        blocked = torch.any((is_m1 & hit_slab[:, :, 0])
                            | (is_0 & hit_slab[:, :, 1]), dim=1)
        w_def = torch.where(blocked, INF, wl)
        into = (in_win & (p_obs - 1 == h))[:, None, None]
        outof = (in_win & (p_obs == h))[:, None, None]
        w_left = torch.where((into & blk_left[:, None, :])
                             | (outof & blk_left[:, :, None]), INF, w_def)
        w_right = torch.where((into & blk_right[:, None, :])
                              | (outof & blk_right[:, :, None]), INF, w_def)
        w4 = torch.stack([w_def, wl, w_left, w_right], dim=1)   # (B,4,N,N)
        tot = best[:, :, :, None] + w4
        best = torch.clamp(torch.amin(tot, dim=2), max=INF)
        bests.append(best)
        bps.append(torch.argmin(tot, dim=2).to(torch.int32))
    return torch.stack(bests, dim=2), torch.stack(bps, dim=2)


def kernel_args(w, zone_block, start_layer, start_node, slab_layers,
                hit_slab, p_obs, in_win, obs_node, last_nodes,
                w_last_factors, closed: bool, h_max: int):
    """``(c_args, best, bp, keep)``: the checked arguments of the kernel's
    C entry point (all but the stream), the two output tensors it fills,
    and the converted inputs, which must live until the launch is
    enqueued."""
    L, N, _ = w.shape
    B = start_layer.shape[0]
    O = slab_layers.shape[1]
    n_last = last_nodes.shape[1]
    H = int(h_max)
    i32 = torch.int32
    zone = zone_block.contiguous()
    zone_bstride = L * N if zone.dim() == 3 else 0
    # the index tensors go as they are, int32 or int64 (bit i of ``wide``)
    index = dict(start_layer=(start_layer, (B,)),
                 start_node=(start_node, (B,)),
                 slab_layers=(slab_layers, (B, O, 2)), p_obs=(p_obs, (B,)),
                 obs_node=(obs_node, (B,)),
                 last_nodes=(last_nodes, (B, n_last)))
    a, wide = {}, 0
    for i, (k, (t, shape)) in enumerate(index.items()):
        a[k], is_wide = cb.index_arg(t)
        wide |= is_wide << i
        cb.require(a[k], torch.int64 if is_wide else i32, shape, k)
    a.update(hit_slab=hit_slab.contiguous(), in_win=in_win.contiguous(),
             w_fac=w_last_factors.to(torch.float32).contiguous())
    cb.require(w, torch.float32, (L, N, N), "w")
    cb.require(zone, torch.bool, (B, L, N) if zone.dim() == 3 else (L, N),
               "zone_block")
    cb.require(a["in_win"], torch.bool, (B,), "in_win")
    cb.require(a["hit_slab"], torch.bool, (B, O, 2, N, N), "hit_slab")
    cb.require(a["w_fac"], torch.float32, (max(n_last - 1, 0),),
               "w_last_factors")
    if H < 1 or O < 1:
        raise ValueError(f"window_dp: h_max {H} and O {O} must be >= 1")
    best = torch.empty((B, N_SLOTS, H + 1, N), dtype=torch.float32,
                       device=w.device)
    bp = torch.empty((B, N_SLOTS, H + 1, N), dtype=i32, device=w.device)
    c_args = (
        cb.ptr(w), cb.ptr(zone), ctypes.c_longlong(zone_bstride),
        cb.ptr(a["start_layer"]), cb.ptr(a["start_node"]),
        cb.ptr(a["slab_layers"]), cb.ptr(a["hit_slab"]), cb.ptr(a["p_obs"]),
        cb.ptr(a["in_win"]), cb.ptr(a["obs_node"]), cb.ptr(a["last_nodes"]),
        cb.ptr(a["w_fac"]), cb.ptr(best), cb.ptr(bp), B, L, N, O, H, n_last,
        int(bool(closed)), wide)
    return c_args, best, bp, (zone, *a.values())


def fused_window_dp(w, zone_block, start_layer, start_node, slab_layers,
                    hit_slab, p_obs, in_win, obs_node, last_nodes,
                    w_last_factors, closed: bool, h_max: int):
    """Batched window DP: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors (arguments as :func:`fused_window_dp_plain`)."""
    if w.device.type == "cpu":
        return fused_window_dp_plain(
            w, zone_block, start_layer, start_node, slab_layers, hit_slab,
            p_obs, in_win, obs_node, last_nodes, w_last_factors, closed,
            h_max)
    c_args, best, bp, _keep = kernel_args(
        w, zone_block, start_layer, start_node, slab_layers, hit_slab, p_obs,
        in_win, obs_node, last_nodes, w_last_factors, closed, h_max)
    cb.check(cb.load("window_dp")(*c_args, cb.stream()), "window_dp")
    fused_window_dp.launches += 1
    return best, bp


fused_window_dp.launches = 0
