"""Object -> edge slab hit masks: the CUDA kernel ``csrc/hit_slab.cu`` and
its plain PyTorch version (counterpart of the JAX package's
``ops/pallas_collision.py``).

Per scenario b, object o, slab j (layer ``slab_layers[b, o, j]``, i.e.
obj_layer-1 or obj_layer) and edge n->m: the minimum over the edge's S
samples of the squared distance to the object, ``<= ref2``, and
``obj_app``.  Output (B, O, 2, N, N) bool.
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb


def hit_slab_plain(samples_xy, slab_layers, obj_pos, ref2, obj_app):
    """Plain version: ``samples_xy`` (L, N, N, S, 2), ``slab_layers``
    (B, O, 2), ``obj_pos`` (B, O, 2), ``ref2``/``obj_app`` (B, O)."""
    L = samples_xy.shape[0]
    slab = samples_xy[slab_layers.long().clamp(0, L - 1)]  # (B,O,2,N,N,S,2)
    d2 = torch.sum((slab - obj_pos[:, :, None, None, None, None, :]) ** 2,
                   dim=-1)
    return (torch.amin(d2, dim=-1) <= ref2[:, :, None, None, None]) \
        & obj_app[:, :, None, None, None]


def kernel_args(samples_xy, slab_layers, obj_pos, ref2, obj_app):
    """``(c_args, out, keep)``: the checked arguments of the kernel's C
    entry point (all but the stream), the output tensor it fills, and the
    converted inputs, which must live until the launch is enqueued."""
    L, N, _, S, _ = samples_xy.shape
    B, O, _ = slab_layers.shape
    slab_layers, wide = cb.index_arg(slab_layers)     # int32 or int64
    obj_pos = obj_pos.contiguous()
    ref2 = ref2.contiguous()
    obj_app = obj_app.contiguous()
    cb.require(samples_xy, torch.float32, (L, N, N, S, 2), "samples_xy")
    cb.require(slab_layers, torch.int64 if wide else torch.int32, (B, O, 2),
               "slab_layers")
    cb.require(obj_pos, torch.float32, (B, O, 2), "obj_pos")
    cb.require(ref2, torch.float32, (B, O), "ref2")
    cb.require(obj_app, torch.bool, (B, O), "obj_app")
    out = torch.empty((B, O, 2, N, N), dtype=torch.bool,
                      device=samples_xy.device)
    c_args = (cb.ptr(samples_xy), cb.ptr(slab_layers), cb.ptr(obj_pos),
              cb.ptr(ref2), cb.ptr(obj_app), cb.ptr(out), B, O, L, N, S, wide)
    return c_args, out, (slab_layers, obj_pos, ref2, obj_app)


def hit_slab(samples_xy, slab_layers, obj_pos, ref2, obj_app):
    """Slab hit masks: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if samples_xy.device.type == "cpu":
        return hit_slab_plain(samples_xy, slab_layers, obj_pos, ref2, obj_app)
    c_args, out, _keep = kernel_args(samples_xy, slab_layers, obj_pos, ref2,
                                     obj_app)
    cb.check(cb.load("hit_slab")(*c_args, cb.stream()), "hit_slab")
    hit_slab.launches += 1
    return out


hit_slab.launches = 0
