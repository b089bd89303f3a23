"""Layer-sharded window DP over a mesh axis — counterpart of the JAX
package's ``parallel/spatial.py``, batched over this rank's scenarios.

The masked window DP is associative along the window steps:
``best_{h+1} = best_h (min-plus) M_h`` with ``M_h`` the masked (N, N) slab
of step h.  So the steps split over the ``D`` ranks of a mesh axis into
contiguous chunks of ``ceil(H / D)``:

  phase 1  each rank builds the masked 4-slot slabs of its chunk (zones,
           object hits, overtake splits, the ``w_last`` discount; steps at
           or past H are the min-plus identity) and composes them into one
           (4, N, N) transfer matrix a scenario;
  phase 2  one exchange of the transfer matrices over the axis, the prefix
           composition of the frontier entering this rank's chunk, and the
           re-run of the chunk's steps from it for costs and backpointers;
           the chunks' tables are then exchanged so that every rank of the
           axis holds the full tables of ``pathgen.plan_window_kernel``.

Composition re-associates the edge-cost additions, so ``best`` can differ
from the sequential scan's by float re-association (about 1e-4 relative);
the JAX package's own tables are reproduced, and the node chains equal the
sequential scan's on the test lattices.

On the card two steps go through kernels that compute exactly what they
do: the slab hits through ``cuda_collision.hit_slab`` (kernel 1), and the
re-run through ``cuda_minplus.minplus_scan`` (kernel 6): one step ``W0``,
whose row ``s0`` is the entering frontier ``f`` and every other row INF,
is put in front of the chunk and the scan starts at ``s0``, so step 1
gives ``min(0 + f, INF) = f`` bit for bit and every later step is the
re-run.  Phase 1, a product over N start rows, stays plain torch.
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.models.lattice import Lattice
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_collision
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_minplus
from graphbasedlocaltrajectoryplanner_torch.ops.search import (
    INF, FEAS_THRESH)
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg


def _local_masked_slabs(lat: Lattice, hs, start_layer, zone_block,
                        slab_layers, hit_slab, p_obs, in_win, obs_node,
                        last_nodes, w_last_factors, n_last: int):
    """Masked 4-slot cost slabs of window steps ``hs`` (Hd,) for every
    scenario: (B, 4, Hd, N, N), slots [straight, follow, left, right]."""
    L, N = lat.L, lat.N
    dev = lat.device
    B = start_layer.shape[0]
    node_ids = torch.arange(N, device=dev)
    step = start_layer.long()[:, None] + hs[None, :]              # (B, Hd)
    layers = torch.remainder(step, L)
    nxts = torch.remainder(layers + 1, L)

    w = lat.w[layers]                                             # (B,Hd,N,N)
    if not lat.closed:
        w = torch.where((step >= L - 1)[..., None, None], INF, w)
    if zone_block.dim() == 3:
        rows = torch.arange(B, device=dev)[:, None]
        z_from, z_to = zone_block[rows, layers], zone_block[rows, nxts]
    else:
        z_from, z_to = zone_block[layers], zone_block[nxts]       # (B, Hd, N)
    w = torch.where(z_from[..., :, None] | z_to[..., None, :], INF, w)
    # previous-solution discount
    last = last_nodes.long()
    a = last[:, torch.clamp(hs, 0, n_last - 1)]                   # (B, Hd)
    b = last[:, torch.clamp(hs + 1, 0, n_last - 1)]
    fac = w_last_factors[torch.clamp(hs, 0, n_last - 2)]          # (Hd,)
    apply = (hs < n_last - 1)[None, :] & (a >= 0) & (b >= 0)
    at_ab = (node_ids[:, None] == a[..., None, None]) \
        & (node_ids[None, :] == b[..., None, None])               # (B,Hd,N,N)
    w = torch.where(at_ab & apply[..., None, None] & (w < FEAS_THRESH),
                    w * fac[None, :, None, None], w)
    # object slab blocking (straight / left / right slots)
    sl = slab_layers.long()
    is_m1 = sl[:, None, :, 0] == layers[..., None]                # (B, Hd, O)
    is_0 = sl[:, None, :, 1] == layers[..., None]
    blocked = torch.any(
        (is_m1[..., None, None] & hit_slab[:, None, :, 0])
        | (is_0[..., None, None] & hit_slab[:, None, :, 1]), dim=2)
    w_def = torch.where(blocked, INF, w)
    # overtake splits at the obstacle layer
    blk_left = (node_ids[None, :] >= obs_node.long()[:, None])[:, None]
    blk_right = ~blk_left                                         # (B, 1, N)
    p = p_obs.long()[:, None]
    into = (in_win[:, None] & (hs[None, :] == p - 1))[..., None, None]
    outof = (in_win[:, None] & (hs[None, :] == p))[..., None, None]
    w_left = torch.where((into & blk_left[..., None, :])
                         | (outof & blk_left[..., :, None]), INF, w_def)
    w_right = torch.where((into & blk_right[..., None, :])
                          | (outof & blk_right[..., :, None]), INF, w_def)
    return torch.stack([w_def, w, w_left, w_right], dim=1)


def _minplus_mm(a, b):
    """(..., N, N) min-plus matrix product, saturated at INF."""
    return torch.clamp(torch.amin(a[..., :, :, None] + b[..., None, :, :],
                                  dim=-2), max=INF)


def rerun_from_frontier(f, w4, kernels: bool = True):
    """The chunk's steps re-run from the frontier ``f`` (..., N) over
    ``w4`` (..., Hd, N, N): ``best``/``bp`` (..., Hd, N) after each step,
    through the min-plus scan (kernel 6 on the card) behind the step
    ``W0`` of the module docstring."""
    *lead, Hd, N, _ = w4.shape
    w0 = torch.full((*lead, 1, N, N), INF, dtype=w4.dtype, device=w4.device)
    w0[..., 0, 0, :] = f
    scan = cuda_minplus.minplus_scan if kernels \
        else cuda_minplus.minplus_scan_plain
    start = torch.zeros(lead, dtype=torch.int32, device=w4.device)
    best, bp = scan(torch.cat([w0, w4], dim=-3), start)
    return best[..., 2:, :], bp[..., 2:, :]


def _stage_a(lat: Lattice, i: int, D: int, start_layer, zone_block,
             obj_pos, obj_radius, obj_active, obs_layer, obs_node,
             obs_found, last_nodes, w_last_factors, n_last: int,
             kernels: bool):
    """Phase 1 on rank ``i`` of ``D``: the window metadata, the slab hits,
    the masked slabs of the rank's chunk of steps and their product.
    Returns ``(meta, w4, P)``: the metadata that stage C reads, the slabs
    (B, 4, Hd, N, N) and the chunk's transfer matrix (B, 4, N, N)."""
    N, H = lat.N, lat.H_max
    dev = lat.device
    B = start_layer.shape[0]
    Hd = -(-H // D)
    pre = pg.window_meta(lat, start_layer, obj_pos, obj_radius, obj_active,
                         obs_layer, obs_node, obs_found)
    with cuda_graph.span("gltpl.hit_slab"):
        hit = (cuda_collision.hit_slab if kernels
               else cuda_collision.hit_slab_plain)(
            lat.samples_xy, pre["slab_layers"], obj_pos, pre["ref2"],
            pre["obj_app"])
    with cuda_graph.span("gltpl.window_dp"):
        hs = i * Hd + torch.arange(Hd, device=dev)
        w4 = _local_masked_slabs(
            lat, hs, start_layer, zone_block, pre["slab_layers"], hit,
            pre["p_obs"], pre["in_win"], obs_node, last_nodes,
            w_last_factors, n_last)                           # (B,4,Hd,N,N)
        # steps past H: the min-plus identity (0 on the diagonal, else INF)
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        ident = torch.where(eye, 0.0, INF).to(torch.float32)
        w4 = torch.where((hs >= H)[:, None, None], ident, w4)
        P = ident.expand(B, 4, N, N)
        for k in range(Hd):
            P = _minplus_mm(P, w4[:, :, k])
    meta = {k: pre[k] for k in ("win_layers", "h_goal", "p_obs", "in_win")}
    return meta, w4, P


def _stage_b(i: int, start_node, w4, Pg, kernels: bool):
    """Phase 2 on rank ``i``: the frontier entering its chunk, composed
    from the gathered transfer matrices ``Pg`` of the ranks before it, and
    the chunk's re-run from it.  Returns ``best`` and ``bp``'s bits (as
    float32) stacked, (2, B, 4, Hd, N), for one exchange."""
    B, _, _, N, _ = w4.shape
    with cuda_graph.span("gltpl.window_dp"):
        f = torch.where(torch.arange(N, device=w4.device)[None, :]
                        == start_node.long()[:, None], 0.0, INF)
        f = f.to(torch.float32)[:, None, :].expand(B, 4, N)
        for j in range(i):
            f = torch.clamp(torch.amin(f[..., :, None] + Pg[j], dim=-2),
                            max=INF)
        best_t, bp_t = rerun_from_frontier(f, w4, kernels)   # (B,4,Hd,N)
        return torch.stack([best_t, bp_t.view(torch.float32)])


def _stage_c(lat: Lattice, start_node, zone_block, meta, obs_node, parts):
    """The full tables from the gathered chunks ``parts`` (in step order)
    and the virtual-goal vectors: the dict of
    ``pathgen.plan_window_kernel``."""
    N, H = lat.N, lat.H_max
    dev = lat.device
    B = start_node.shape[0]
    with cuda_graph.span("gltpl.window_dp"):
        full = torch.cat(parts, dim=-2)[..., :H, :]          # (2,B,4,H,N)
        # 0 at the start node, INF elsewhere (a where, not an indexed
        # store of a Python number: a capture refuses its host copy)
        best0 = torch.where(torch.arange(N, device=dev)[None, :]
                            == start_node.long()[:, None], 0.0, INF)
        best0 = best0.to(torch.float32)[:, None, None, :].expand(B, 4, 1, N)
        best = torch.cat([best0, full[0]], dim=2)
        bp = torch.cat([torch.full((B, 4, 1, N), -1, dtype=torch.int32,
                                   device=dev),
                        full[1].contiguous().view(torch.int32)], dim=2)
    vg = pg.window_vg(lat, meta["win_layers"], zone_block, meta["p_obs"],
                      meta["in_win"], obs_node)
    return dict(best=best, bp=bp, vg=vg, win_layers=meta["win_layers"],
                h_goal=meta["h_goal"])


def spatial_dp_shard(lat: Lattice, start_layer, start_node, zone_block,
                     obj_pos, obj_radius, obj_active, obs_layer, obs_node,
                     obs_found, last_nodes, w_last_factors, n_last: int = 4,
                     axis_name: str = "mp", D: int = None, *, mesh,
                     kernels: bool = True):
    """The two-phase window DP of this rank's scenarios (leading B) over
    mesh axis ``axis_name``, called by every rank of the axis on the same
    scenarios.  Returns the full tables, equal on every rank of the axis:
    dict(best, bp, vg (B, 4, H+1, N), win_layers (B, H+1), h_goal (B,)),
    as ``pathgen.plan_window_kernel``.

    Three collective-free stages with the two exchanges between them:
    A (:func:`_stage_a`, phase 1), the gather of the transfer matrices,
    B (:func:`_stage_b`, the entering frontier and the re-run), the gather
    of the chunks' tables, C (:func:`_stage_c`, the full tables); the
    compiled sharded tick captures each stage on its own where the mesh's
    collectives cannot be captured (``scenario.compile_sharded_tick``).

    :param D: the axis' size, as the JAX package's body is told it; given,
        it must equal ``mesh.shape[axis_name]``.
    :param mesh: the ``distributed.DistMesh`` whose ranks call this (the
        JAX package's ``shard_map`` mesh).
    """
    if D is not None and D != mesh.shape[axis_name]:
        raise ValueError(f"D={D} but the mesh's axis {axis_name!r} holds "
                         f"{mesh.shape[axis_name]} ranks")
    D = mesh.shape[axis_name]
    i = mesh.coords[axis_name]
    meta, w4, P = _stage_a(lat, i, D, start_layer, zone_block, obj_pos,
                           obj_radius, obj_active, obs_layer, obs_node,
                           obs_found, last_nodes, w_last_factors, n_last,
                           kernels)
    with cuda_graph.span("gltpl.window_dp"):
        Pg = mesh.all_gather(P, axis_name)                   # D x (B,4,N,N)
    chunk = _stage_b(i, start_node, w4, Pg, kernels)
    with cuda_graph.span("gltpl.window_dp"):
        parts = mesh.all_gather(chunk, axis_name)
    return _stage_c(lat, start_node, zone_block, meta, obs_node, parts)


def spatial_window_dp(lat: Lattice, mesh, start_layer, start_node,
                      zone_block, obj_pos, obj_radius, obj_active, obs_layer,
                      obs_node, obs_found, last_nodes, w_last_factors,
                      n_last: int = 4, kernels: bool = True):
    """The window DP of a batch of scenarios with its steps sharded over
    the mesh's ``mp`` axis; inputs and outputs as
    ``pathgen.plan_window_kernel`` (scenario tensors with a leading B,
    ``zone_block`` (L, N) or (B, L, N)).  Every rank of the axis passes
    the same scenarios; ``make_sharded_tick(spatial_axis=...)`` composes
    it with scenario sharding over the other axes."""
    if "mp" not in mesh.shape:
        raise ValueError("mesh has no axis 'mp'")
    return spatial_dp_shard(lat, start_layer, start_node, zone_block,
                            obj_pos, obj_radius, obj_active, obs_layer,
                            obs_node, obs_found, last_nodes, w_last_factors,
                            n_last=n_last, axis_name="mp", mesh=mesh,
                            kernels=kernels)
