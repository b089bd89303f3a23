"""Object-vs-lattice helpers (torch) — counterpart of the JAX package's
``ops/collision.py`` (the parts the batched fleet tick uses)."""

from __future__ import annotations

import torch


def object_layers(refline: torch.Tensor, obj_pos: torch.Tensor):
    """Closest refline layer per object: refline (L, 2), obj_pos (..., 2)
    -> (...,) int64 (first layer on ties)."""
    d2 = torch.sum((refline - obj_pos[..., None, :]) ** 2, dim=-1)
    return torch.argmin(d2, dim=-1)


def layer_dist_mod(from_layer, to_layer, num_layers: int):
    """(to - from) mod L — forward layer distance with lap wrap (floored)."""
    return torch.remainder(to_layer - from_layer, num_layers)
