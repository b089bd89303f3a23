"""Seeded raw inputs for the window-DP and the slab-hit kernels
(``ops/cuda_window.fused_window_dp``, ``ops/cuda_collision.hit_slab``) at
shapes and contents the planner's own calls do not reach.  No lattice is
needed: a case is a dictionary of numpy arrays, keyed by the wrappers'
argument names, so the same case can go through the JAX package, the plain
PyTorch version and the CUDA kernel.

Window DP: batch sizes around a warp and beyond, node counts that are no
multiple of anything, horizons longer than the track (a closed track wraps
around), open tracks that start near their end, obstacle steps at 0, 1, H
and beyond, obstacle nodes at 0 and N, chains of last nodes with holes, slab
layers that coincide between objects or lie outside the window, and costs
with INF entries and exact ties between predecessors.

Slab hits: all objects inactive, every scenario on one layer, slab layers
of -1 and L (clipped), and objects exactly at their radius (``<=``).
"""

from __future__ import annotations

import numpy as np

INF = np.float32(1e30)

WINDOW_ARGS = ("w", "zone_block", "start_layer", "start_node", "slab_layers",
               "hit_slab", "p_obs", "in_win", "obs_node", "last_nodes",
               "w_last_factors")
HIT_ARGS = ("samples_xy", "slab_layers", "obj_pos", "ref2", "obj_app")

# (B, N, H, O, n_last, L, closed, zone per scenario)
WINDOW_CASES = (
    (1, 24, 27, 16, 4, 61, True, False),    # the facade's shape
    (7, 24, 27, 4, 4, 61, True, True),
    (130, 24, 27, 4, 4, 61, True, False),
    (7, 32, 19, 4, 4, 34, False, False),    # open: unclosed Monteblanco
    (130, 32, 19, 1, 1, 34, False, True),
    (1, 1, 1, 1, 0, 5, True, False),
    (7, 1, 2, 4, 1, 3, False, True),
    (1, 3, 1, 1, 4, 7, True, True),
    (7, 3, 27, 16, 0, 5, True, False),      # the window wraps 5 times
    (130, 3, 2, 4, 4, 2, True, False),
    (1, 40, 19, 4, 4, 12, True, False),     # L < H
    (7, 40, 2, 1, 1, 50, False, False),
    (1, 32, 27, 16, 4, 9, False, True),     # open and shorter than H
    (7, 24, 19, 16, 0, 19, True, True),     # L == H
    (130, 24, 1, 1, 4, 61, False, False),
    (1, 24, 2, 4, 1, 61, True, True),
    (7, 32, 27, 4, 4, 28, True, False),     # L == H + 1
    (130, 40, 27, 4, 4, 30, True, True),
    (1, 3, 19, 4, 4, 100, False, False),
    (7, 24, 27, 1, 4, 13, True, False),
)

# (B, O, S, N, L, kind)
HIT_CASES = (
    (1, 16, 14, 24, 61, "mixed"),           # the facade's shape
    (5, 4, 14, 24, 61, "mixed"),
    (257, 4, 14, 24, 61, "mixed"),
    (257, 1, 14, 32, 34, "one_layer"),
    (5, 16, 14, 32, 34, "mixed"),
    (1, 1, 1, 3, 4, "mixed"),
    (5, 4, 1, 3, 1, "mixed"),               # a single layer
    (257, 16, 1, 3, 7, "one_layer"),
    (5, 4, 14, 24, 61, "all_inactive"),
    (257, 4, 1, 32, 5, "all_inactive"),
    (1, 4, 14, 3, 9, "one_layer"),
    (5, 1, 14, 24, 2, "mixed"),
)


def window_case(seed: int, B: int, N: int, H: int, O: int, n_last: int,
                L: int, closed: bool, zone_per_scenario: bool) -> dict:
    """One call's inputs of ``fused_window_dp`` (``WINDOW_ARGS``) plus
    ``closed`` and ``h_max``."""
    rng = np.random.default_rng(seed)
    # even layers: a few small multiples of 0.5, so that sums are exact and
    # predecessors tie; odd layers: continuous costs
    w = rng.uniform(0.5, 30.0, (L, N, N)).astype(np.float32)
    w[::2] = (rng.integers(1, 5, w[::2].shape) * 0.5).astype(np.float32)
    w[rng.random((L, N, N)) < 0.12] = INF
    zshape = (B, L, N) if zone_per_scenario else (L, N)
    zone = rng.random(zshape) < 0.08
    start_layer = rng.integers(0, L, B).astype(np.int32)
    if not closed:                          # near and at the track end
        start_layer[::2] = np.maximum(L - 1 - np.arange(len(
            start_layer[::2])) % 4, 0)
    start_node = rng.integers(0, N, B).astype(np.int32)
    # object layers from -1 to L: slabs outside the track and the window,
    # and, with more objects than layers, slabs that coincide
    obj_layer = rng.integers(-1, L + 1, (B, O))
    near = rng.random((B, O)) < 0.6         # most of them inside the window
    obj_layer = np.where(near, (start_layer[:, None]
                                + rng.integers(0, H + 1, (B, O))) % L,
                         obj_layer)
    if O >= 2:
        obj_layer[:, 1] = obj_layer[:, 0]   # two objects on one layer
    slab_layers = np.stack([obj_layer - 1, obj_layer], axis=2) \
        .astype(np.int32)
    hit_slab = rng.random((B, O, 2, N, N)) < 0.15
    hit_slab[rng.random((B, O)) < 0.3] = False  # objects that block nothing
    p_obs = rng.integers(0, H + 4, B).astype(np.int32)
    p_obs[: min(B, 4)] = np.array([0, 1, H, H + 3], np.int32)[: min(B, 4)]
    in_win = rng.random(B) < 0.7
    in_win[: min(B, 4)] = True
    obs_node = rng.integers(0, N + 1, B).astype(np.int32)
    obs_node[0] = 0
    if B >= 2:
        obs_node[1] = N
    last_nodes = rng.integers(0, N, (B, n_last)).astype(np.int32)
    last_nodes[rng.random((B, n_last)) < 0.2] = -1
    if n_last:                              # most chains start at the start
        last_nodes[::2, 0] = start_node[::2]
    w_fac = np.array([0.0, 0.5, 0.8, 0.9], np.float32)[: max(n_last - 1, 0)]
    return dict(w=w, zone_block=zone, start_layer=start_layer,
                start_node=start_node, slab_layers=slab_layers,
                hit_slab=hit_slab, p_obs=p_obs, in_win=in_win,
                obs_node=obs_node, last_nodes=last_nodes,
                w_last_factors=w_fac, closed=bool(closed), h_max=int(H))


def hit_case(seed: int, B: int, O: int, S: int, N: int, L: int,
             kind: str) -> dict:
    """One call's inputs of ``hit_slab`` (``HIT_ARGS``).  Even layers hold
    samples on a half-metre grid, where squared distances are exact in
    float32 whatever the order of the arithmetic, and every fourth object
    there sits exactly at its radius from the nearest sample of one edge."""
    rng = np.random.default_rng(seed)
    samples = rng.uniform(-40.0, 40.0, (L, N, N, S, 2)).astype(np.float32)
    samples[::2] = (rng.integers(-80, 81, samples[::2].shape) * 0.5) \
        .astype(np.float32)
    obj_layer = rng.integers(-1, L + 1, (B, O))
    if kind == "one_layer":
        obj_layer[:] = L // 2
    slab_layers = np.stack([obj_layer - 1, obj_layer], axis=2) \
        .astype(np.int32)
    obj_pos = (rng.integers(-80, 81, (B, O, 2)) * 0.5).astype(np.float32)
    ref2 = rng.uniform(4.0, 60.0, (B, O)).astype(np.float32)
    at_edge = (np.arange(B * O).reshape(B, O) % 4 == 0) \
        & (np.clip(obj_layer, 0, L - 1) % 2 == 0)
    for b, o in zip(*np.nonzero(at_edge)):
        lay = samples[np.clip(obj_layer[b, o], 0, L - 1)]
        edge = lay[rng.integers(0, N), rng.integers(0, N)]      # (S, 2)
        d = (edge - obj_pos[b, o]).astype(np.float32)
        ref2[b, o] = np.min(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    obj_app = rng.random((B, O)) < (0.0 if kind == "all_inactive" else 0.5)
    if kind != "all_inactive":
        obj_app[0, 0] = True
    return dict(samples_xy=samples, slab_layers=slab_layers,
                obj_pos=obj_pos, ref2=ref2, obj_app=obj_app)


def window_cases():
    """``(label, case)`` for every entry of ``WINDOW_CASES``."""
    for i, c in enumerate(WINDOW_CASES):
        B, N, H, O, n_last, L, closed, zps = c
        yield (f"B{B}-N{N}-H{H}-O{O}-last{n_last}-L{L}-"
               f"{'closed' if closed else 'open'}-"
               f"{'zoneB' if zps else 'zone'}", window_case(2000 + i, *c))


def hit_cases():
    """``(label, case)`` for every entry of ``HIT_CASES``."""
    for i, c in enumerate(HIT_CASES):
        B, O, S, N, L, kind = c
        yield f"B{B}-O{O}-S{S}-N{N}-L{L}-{kind}", hit_case(3000 + i, *c)
