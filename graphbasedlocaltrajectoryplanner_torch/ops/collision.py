"""Object-vs-lattice helpers (torch) — counterpart of the JAX package's
``ops/collision.py``, batched over leading axes."""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph


def object_layers(refline: torch.Tensor, obj_pos: torch.Tensor):
    """Closest refline layer per object: refline (L, 2), obj_pos (..., 2)
    -> (...,) int64 (first layer on ties)."""
    d2 = torch.sum((refline - obj_pos[..., None, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=-1)


def layer_dist_mod(from_layer, to_layer, num_layers: int):
    """(to - from) mod L — forward layer distance with lap wrap (floored)."""
    return torch.remainder(to_layer - from_layer, num_layers)


def edge_block_mask(window_samples_xy, window_layers, obj_pos, obj_radius,
                    obj_layer, obj_active, start_layer, h_goal,
                    num_layers: int, veh_width: float,
                    sampled_resolution: float):
    """Blocked-edge mask over materialized planning windows, per scenario.

    :param window_samples_xy: (B, H, N, N, S, 2) sampled points of the edge
        from node n of window step h to node m of step h+1.
    :param window_layers: (B, H) layer of each window step.
    :param obj_pos: (B, O, 2); ``obj_radius``, ``obj_layer``,
        ``obj_active`` (B, O); ``start_layer``, ``h_goal`` (B,).
    :returns: blocked (B, H, N, N) bool — an edge is blocked when an
        applicable object (active, within the horizon +-1 layer) lies in its
        slab {obj_layer-1, obj_layer} and one of its samples comes within
        the inflated radius.
    """
    fwd = layer_dist_mod(start_layer.long()[:, None], obj_layer.long(),
                         num_layers)                               # (B, O)
    in_range = (fwd <= h_goal.long()[:, None] + 1) | (fwd >= num_layers - 1)
    applicable = obj_active & in_range
    rel = torch.remainder(window_layers.long()[:, None, :]
                          - (obj_layer.long()[:, :, None] - 1),
                          num_layers)                              # (B, O, H)
    oa = applicable[:, :, None] & (rel <= 1)
    ref2 = (obj_radius + veh_width / 2.0) ** 2 \
        + sampled_resolution ** 2 / 4.0
    B, H, N = window_samples_xy.shape[:3]
    blocked = torch.zeros((B, H, N, N), dtype=torch.bool,
                          device=window_samples_xy.device)
    # one object at a time keeps the (B, H, N, N, S) distance table the
    # largest intermediate
    for o in range(obj_pos.shape[1]):
        d2 = torch.sum((window_samples_xy
                        - obj_pos[:, o, None, None, None, None, :]) ** 2,
                       dim=-1)
        hit = torch.amin(d2, dim=-1) <= ref2[:, o, None, None, None]
        blocked |= hit & oa[:, o, :, None, None]
    return blocked


def closest_object(obj_layer, obj_active, start_layer, h_goal,
                   num_layers: int):
    """Index and forward layer distance of the closest active object within
    the horizon (gen_local_node_template.py:191-213): ``obj_layer``,
    ``obj_active`` (..., O); ``start_layer``, ``h_goal`` scalars or (...,).
    Returns (idx (...,) int32, layer_dist (...,), found (...,)); ``idx`` is
    the first object on ties and arbitrary when nothing is found."""
    dev = obj_layer.device
    start = cuda_graph.as_tensor(start_layer, device=dev).long()[..., None]
    h_goal = cuda_graph.as_tensor(h_goal, device=dev).long()[..., None]
    fwd = layer_dist_mod(start, obj_layer.long(), num_layers)
    ok = obj_active & (fwd <= h_goal)
    fwd_masked = torch.where(ok, fwd, num_layers + 1)
    idx = torch.argmin(fwd_masked, dim=-1)
    return (idx.to(torch.int32),
            torch.gather(fwd_masked, -1, idx[..., None])[..., 0],
            torch.any(ok, dim=-1))


def path_hits_objects(path_xy, path_valid, obj_pos, obj_radius, obj_active,
                      veh_width: float):
    """Per-object flag: does the polyline ``path_xy`` (..., P, 2) (rows
    where ``path_valid`` (..., P)) come within ``obj_radius + veh_width /
    2`` of the object (the constant-path-segment check,
    main_online_path_gen.py:117-122, no discretization inflation)?
    ``obj_pos`` (..., O, 2), ``obj_radius``/``obj_active`` (..., O) ->
    (..., O) bool."""
    d2 = torch.sum((path_xy[..., None, :, :] - obj_pos[..., :, None, :])
                   ** 2, dim=-1)                                # (..., O, P)
    d2 = torch.where(path_valid[..., None, :], d2, torch.inf)
    ref2 = (obj_radius + veh_width / 2.0) ** 2
    return obj_active & torch.any(d2 <= ref2[..., None], dim=-1)
