"""Per-tick path generation (torch, batched over scenarios) — counterpart
of the JAX package's ``planner/pathgen.py``.

For all four action slots (straight / follow / left / right) of every
scenario: the masked window DP (zones for every slot, object-blocked edges
for straight/left/right, overtake splits for left/right, the
``w_last_edges`` discount), the virtual-goal vectors, the backtrace and the
C2-refit path assembly.  Every function takes a leading scenario (or row)
dimension instead of being vmapped.  With ``kernels`` (the default) the
window DP, the backtrace, the path assembly and the dense window's
min-plus sweep go through the CUDA kernels' wrappers, which take their plain versions on CPU
tensors; ``kernels=False`` takes the plain versions on any device.
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.models.lattice import Lattice
from graphbasedlocaltrajectoryplanner_torch.ops import collision as col
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch
from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_assemble
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_backtrace
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_collision
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_minplus
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_window
from graphbasedlocaltrajectoryplanner_torch.ops.search import INF

# action slot order (fixed)
SLOT_STRAIGHT, SLOT_FOLLOW, SLOT_LEFT, SLOT_RIGHT = 0, 1, 2, 3
N_SLOTS = 4


def window_meta(lat: Lattice, start_layer, obj_pos, obj_radius, obj_active,
                obs_layer, obs_node, obs_found):
    """Per-scenario window metadata: object applicability + inflated radii
    for the hit test, slab layers {obj_layer-1, obj_layer}, the overtake
    split position, window layers.  Scenario tensors carry a leading B."""
    L, H = lat.L, lat.H_max
    dev = lat.device
    sl = start_layer.long()
    h_goal = lat.h_goal_for_start[sl]
    win_layers = torch.remainder(
        sl[:, None] + torch.arange(H + 1, device=dev), L)
    obj_layer = col.object_layers(lat.refline, obj_pos)            # (B, O)
    fwd = col.layer_dist_mod(sl[:, None], obj_layer, L)
    in_range = (fwd <= h_goal.long()[:, None] + 1) | (fwd >= L - 1)
    obj_app = obj_active & in_range
    ref2 = (obj_radius + lat.veh_width / 2.0) ** 2 \
        + lat.sampled_resolution ** 2 / 4.0
    slab_layers = torch.stack([torch.remainder(obj_layer - 1, L),
                               obj_layer], dim=-1)                  # (B,O,2)
    p_obs = torch.remainder(obs_layer.long() - sl, L)
    in_win = obs_found & (p_obs <= H)
    return dict(h_goal=h_goal, win_layers=win_layers,
                slab_layers=slab_layers, obj_app=obj_app, ref2=ref2,
                p_obs=p_obs, in_win=in_win)


def window_prelude(lat: Lattice, start_layer, obj_pos, obj_radius,
                   obj_active, obs_layer, obs_node, obs_found):
    """:func:`window_meta` plus the slab hit masks (B, O, 2, N, N) by the
    plain formulation."""
    pre = window_meta(lat, start_layer, obj_pos, obj_radius, obj_active,
                      obs_layer, obs_node, obs_found)
    pre["hit_slab"] = cuda_collision.hit_slab_plain(
        lat.samples_xy, pre["slab_layers"], obj_pos, pre["ref2"],
        pre["obj_app"])
    return pre


def window_vg(lat: Lattice, win_layers, zone_block, p_obs, in_win, obs_node):
    """Per-slot virtual-goal vectors (B, 4, H+1, N): zone- and
    overtake-blocked nodes cannot be goals."""
    N, H = lat.N, lat.H_max
    dev = lat.device
    B = win_layers.shape[0]
    node_ids = torch.arange(N, device=dev)
    blk_left = node_ids[None, :] >= obs_node.long()[:, None]        # (B, N)
    blk_right = ~blk_left
    if zone_block.dim() == 3:
        zb_win = zone_block[torch.arange(B, device=dev)[:, None], win_layers]
    else:
        zb_win = zone_block[win_layers]                             # (B,H+1,N)
    vg_win = torch.where(zb_win, INF, lat.vg_cost[win_layers])
    at_obs = in_win[:, None, None] \
        & (torch.arange(H + 1, device=dev)[None, :] == p_obs[:, None])[..., None]
    return torch.stack([vg_win, vg_win,
                        torch.where(at_obs & blk_left[:, None, :], INF, vg_win),
                        torch.where(at_obs & blk_right[:, None, :], INF,
                                    vg_win)], dim=1)


def _check_n_last(last_nodes, n_last):
    if n_last is not None and n_last != last_nodes.shape[-1]:
        raise ValueError(f"n_last={n_last} but last_nodes holds "
                         f"{last_nodes.shape[-1]} nodes a scenario")


def plan_window_kernel(lat: Lattice, start_layer, start_node, zone_block,
                       obj_pos, obj_radius, obj_active, obs_layer, obs_node,
                       obs_found, last_nodes, w_last_factors,
                       n_last: int = None, kernels: bool = True):
    """Masked 4-slot DP for a batch of scenarios: the slab hit masks and
    the window DP (kernels 1 and 2 on the card, in the profiler ranges
    ``gltpl.hit_slab`` and ``gltpl.window_dp``), then the virtual-goal
    vectors.

    :param n_last: the length of ``last_nodes``' chains (default
        ``last_nodes.shape[-1]``; another value raises).
    :returns: dict with ``best``/``bp``/``vg`` (B, 4, H+1, N),
        ``win_layers`` (B, H+1), ``h_goal`` (B,).
    """
    _check_n_last(last_nodes, n_last)
    pre = window_meta(lat, start_layer, obj_pos, obj_radius, obj_active,
                      obs_layer, obs_node, obs_found)
    with cuda_graph.span("gltpl.hit_slab"):
        hit = (cuda_collision.hit_slab if kernels
               else cuda_collision.hit_slab_plain)(
            lat.samples_xy, pre["slab_layers"], obj_pos, pre["ref2"],
            pre["obj_app"])
    with cuda_graph.span("gltpl.window_dp"):
        best, bp = (cuda_window.fused_window_dp if kernels
                    else cuda_window.fused_window_dp_plain)(
            lat.w, zone_block, start_layer, start_node, pre["slab_layers"],
            hit, pre["p_obs"], pre["in_win"], obs_node, last_nodes,
            w_last_factors, closed=bool(lat.closed), h_max=int(lat.H_max))
    vg = window_vg(lat, pre["win_layers"], zone_block, pre["p_obs"],
                   pre["in_win"], obs_node)
    return dict(best=best, bp=bp, vg=vg, win_layers=pre["win_layers"],
                h_goal=pre["h_goal"])


# the compiled dense window of each card (plan_window_dense.compiled)
_DENSE = {}


def plan_window_dense(lat: Lattice, start_layer, start_node, zone_block,
                      obj_pos, obj_radius, obj_active, obs_layer, obs_node,
                      obs_found, last_nodes, w_last_factors,
                      n_last: int = None, kernels: bool = True):
    """Dense (materialized-window) variant of :func:`plan_window_kernel`:
    the masked ``w_all (B, 4, H, N, N)`` is built in full, the object
    blocks by :func:`ops.collision.edge_block_mask` over every window
    sample, and the four slots run through the plain min-plus sweep
    (kernel 6 on the card).  Arguments as :func:`plan_window_kernel`, with
    a shared ``(L, N)`` zone mask.

    On the card with the kernels each call runs one CUDA graph per input
    signature (``ops/cuda_graph.capture``, as the JAX package jits this
    function): the lattice is an argument of the graph, so its tensors'
    shapes and its static fields are part of the signature and its tensors
    are copied in like the scenarios'.  The graphs of a card are
    ``plan_window_dense.compiled[device].graphs``; the graph's pool holds
    ``w_all`` and the window's samples.  ``__wrapped__`` is the eager
    function, which the CPU, ``kernels=False`` and
    ``cuda_graph.disabled()`` run.

    :returns: dict with ``best``/``bp``/``vg`` (B, 4, H+1, N),
        ``win_layers`` (B, H+1), ``blocked`` (B, H, N, N), ``obj_layer``
        (B, O), ``h_goal`` (B,) and ``w_all``.
    """
    args = (lat, start_layer, start_node, zone_block, obj_pos, obj_radius,
            obj_active, obs_layer, obs_node, obs_found, last_nodes,
            w_last_factors, n_last, kernels)
    if not kernels or lat.device.type != "cuda":
        return _plan_window_dense(*args)
    fn = _DENSE.get(lat.device)
    if fn is None:
        fn = _DENSE[lat.device] = cuda_graph.capture(_plan_window_dense,
                                                     lat.device)
    return fn(*args)


def _plan_window_dense(lat: Lattice, start_layer, start_node, zone_block,
                       obj_pos, obj_radius, obj_active, obs_layer, obs_node,
                       obs_found, last_nodes, w_last_factors,
                       n_last: int = None, kernels: bool = True):
    """The eager :func:`plan_window_dense`."""
    _check_n_last(last_nodes, n_last)
    L, N, H = lat.L, lat.N, lat.H_max
    dev = lat.device
    B = start_layer.shape[0]
    bidx = torch.arange(B, device=dev)
    sl = start_layer.long()
    h_goal = lat.h_goal_for_start[sl]
    win_layers = torch.remainder(
        sl[:, None] + torch.arange(H + 1, device=dev), L)           # (B, H+1)
    w_win = lat.w[win_layers[:, :H]]                                # (B,H,N,N)
    if not lat.closed:
        invalid = (sl[:, None] + torch.arange(H, device=dev)) >= (L - 1)
        w_win = torch.where(invalid[..., None, None], INF, w_win)

    # zone node blocking (every slot)
    zb_win = zone_block[win_layers]                                 # (B,H+1,N)
    w_base = torch.where(zb_win[:, :H, :, None], INF, w_win)
    w_base = torch.where(zb_win[:, 1:, None, :], INF, w_base)

    # previous-solution discount on the shared base
    last = last_nodes.long()
    for i in range(last.shape[1] - 1):
        a, b = last[:, i], last[:, i + 1]
        ok = (a >= 0) & (b >= 0)
        cur = w_base[bidx, i, a.clamp(min=0), b.clamp(min=0)]
        w_base[bidx, i, a.clamp(min=0), b.clamp(min=0)] = torch.where(
            ok & (cur < srch.FEAS_THRESH), cur * w_last_factors[i], cur)

    # object edge blocking (straight/left/right)
    obj_layer = col.object_layers(lat.refline, obj_pos)             # (B, O)
    blocked = col.edge_block_mask(
        lat.samples_xy[win_layers[:, :H]], win_layers[:, :H], obj_pos,
        obj_radius, obj_layer, obj_active, sl, h_goal, L, lat.veh_width,
        lat.sampled_resolution)
    w_default = torch.where(blocked, INF, w_base)

    # overtake splits at the obstacle layer: left keeps nodes < obs_node,
    # right keeps nodes >= obs_node
    p_obs = torch.remainder(obs_layer.long() - sl, L)
    in_win = obs_found & (p_obs <= H)
    node_ids = torch.arange(N, device=dev)
    at_obs = (torch.arange(H + 1, device=dev)[None, :] == p_obs[:, None]) \
        & in_win[:, None]                                           # (B, H+1)
    block_left = at_obs[..., None] \
        & (node_ids[None, None, :] >= obs_node.long()[:, None, None])
    block_right = at_obs[..., None] \
        & (node_ids[None, None, :] < obs_node.long()[:, None, None])

    def node_block(w, nb):
        w = torch.where(nb[:, :H, :, None], INF, w)
        return torch.where(nb[:, 1:, None, :], INF, w)

    w_all = torch.stack([w_default, w_base, node_block(w_default, block_left),
                         node_block(w_default, block_right)], dim=1)
    vg_win = torch.where(zb_win, INF, lat.vg_cost[win_layers])     # (B,H+1,N)
    vg = torch.stack([vg_win, vg_win,
                      torch.where(block_left, INF, vg_win),
                      torch.where(block_right, INF, vg_win)], dim=1)
    scan = cuda_minplus.minplus_scan if kernels \
        else cuda_minplus.minplus_scan_plain
    best, bp = scan(w_all, start_node.long()[:, None].expand(B, N_SLOTS))
    return dict(best=best, bp=bp, vg=vg, win_layers=win_layers,
                blocked=blocked, obj_layer=obj_layer, h_goal=h_goal,
                w_all=w_all)


plan_window_dense.__wrapped__ = _plan_window_dense
plan_window_dense.compiled = _DENSE


def feasibility_vectors(best, vg):
    """Per-slot feasibility of ending at window layer h (any goal node)."""
    return torch.amin(best + vg, dim=-1) < srch.FEAS_THRESH


def backtrace_slot(best, bp, vg, h_eff, kernels: bool = True, slot=None,
                   slot_range=None):
    """Goal argmin + backtrace per row at a fixed horizon: ``best``/``bp``/
    ``vg`` (R, H+1, N), ``h_eff`` (R,) -> (nodes (R, H+1) int32, cost
    (R,)).  With ``slot`` (R,), ``best``/``bp``/``vg`` are the window DP's
    unselected (R0, S, H+1, N) outputs and row r takes slot ``slot[r]`` of
    table row ``r // (R / R0)``; no slot's table is copied out, and
    ``slot_range`` are the slots' bounds where the caller knows them
    (``cuda_backtrace.slot_layout``).  The walk is kernel 3 on the card (the batched form of the JAX package's
    ``make_backtrace_goal``)."""
    R = h_eff.shape[0]
    rows = torch.arange(R, device=best.device)
    h = h_eff.long()
    if slot is None:
        goal_tot = best[rows, h] + vg[rows, h]
    else:
        t, s = rows // max(R // best.shape[0], 1), slot.long()
        goal_tot = best[t, s, h] + vg[t, s, h]
    goal_node = torch.argmin(goal_tot, dim=-1)
    walk = (cuda_backtrace.backtrace_walk if kernels
            else cuda_backtrace.backtrace_walk_plain)
    nodes = walk(bp, goal_node, h_eff, slot, slot_range=slot_range)
    return nodes, goal_tot[rows, goal_node]


# ---------------------------------------------------------------------------
# path assembly: fuse edge samples, C2 re-fit through nodes, resample
# ---------------------------------------------------------------------------

def packed_edge_table(lat: Lattice):
    """Per-edge assembly data packed into one ``(L, N, N, 10)`` table:
    ``[npts, len, coeffs_0..7]`` (raceline edges reuse the periodic
    raceline spline; the ``a0`` column is the exact start-node position)."""
    L, N = lat.L, lat.N
    dev = lat.device
    l2 = torch.remainder(torch.arange(L, device=dev) + 1, L)
    her = spl.fit_hermite(
        lat.node_pos[:, :, None, :].expand(L, N, N, 2),
        lat.node_pos[l2][:, None, :, :].expand(L, N, N, 2),
        lat.node_psi[:, :, None].expand(L, N, N),
        lat.node_psi[l2][:, None, :].expand(L, N, N))
    ar = torch.arange(N, device=dev)
    rl = lat.rl_idx.long()
    is_rl = (ar[None, :, None] == rl[:, None, None]) \
        & (ar[None, None, :] == rl[l2][:, None, None])
    coeffs = torch.where(is_rl[..., None, None],
                         lat.raceline_coeffs[:, None, None], her)
    return torch.cat([lat.edge_npts[..., None].to(torch.float32),
                      lat.edge_len[..., None],
                      coeffs.reshape(L, N, N, 8)], dim=-1)


def assemble_action_kernel(lat: Lattice, win_layers, nodes, h_eff, psi_s,
                           p_max: int, *, packed=None, kernels: bool = True):
    """Fuse each row's node chain into one C2 path (fixed size).

    Per-edge sample counts give the fused index layout (shared endpoints
    deduplicated), element lengths come from the pre-refit stored edges,
    and one curvature-continuous spline through the node positions
    (clamped headings, chord lengths = stored edge lengths) is re-sampled
    with the same per-segment counts for x, y, psi, kappa.  With
    ``kernels`` the rows go through the assembly kernel's wrapper
    (``ops/cuda_assemble.assemble_path``: one launch on the card, the
    plain version on CPU tensors); ``kernels=False`` takes the plain
    version on any device.

    :param packed: :func:`packed_edge_table` of ``lat`` (built here when
        not given; a caller that assembles every tick passes its own).
    :param win_layers: (R, H+1), or (R0, H+1) with R0 dividing R, row r
        taking row ``r // (R / R0)``; ``nodes`` (R, H+1) window node chains
        (-1 pad); ``h_eff`` (R,) in [1, H]; ``psi_s`` (R,) start headings.
    :returns: dict(path (R, p_max, 5) [x y psi kappa el], n_valid (R,),
        node_idx (R, H+1) int32 path row of each chain node, coeffs
        (R, H, 8) refit coefficients [x a0..a3, y a0..a3])
    """
    if packed is None:
        packed = packed_edge_table(lat)
    fn = (cuda_assemble.assemble_path if kernels
          else cuda_assemble.assemble_path_plain)
    return fn(packed, win_layers, nodes, h_eff, psi_s, p_max)
