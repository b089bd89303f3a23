"""Seeded velocity-QP batches at ragged shapes for the ADMM kernel
(``csrc/admm_vel.cu``): point counts around a warp, the block and the
kernel's points-per-thread steps (2 .. 1024), 1 to more than 4,096 rows,
iteration counts from 0 to the planner's 150; the edges of the warp design
(n around 64, 96 and its limit 128, row counts that fill no block of
rows), the facade's call, and penalties outside the window of
``csrc/ieee_fast.cuh`` on a few points, where the kernel divides by the
plain operator.

Each case is the output of ``ops/qp._vel_qp_data`` for seeded planner-like
windows — curvature waves, per-point gg, padded segments (inactive
dynamics rows), pinned starts, pointwise caps and
warm starts — so the kernel sees the value ranges of the main path.
``chip_smoke.py`` holds the kernel against its plain version on each.
"""

from __future__ import annotations

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.ops import qp

MACHINES = np.array([[0.0, 5.0], [30.0, 4.0], [70.0, 2.5]], np.float32)

# (n points, R rows, iterations[, "tiny_rho": penalties scaled by TINY_RHO])
CASES = [
    (2, 1, 150), (3, 5, 150), (31, 33, 7), (32, 2, 150), (33, 9, 150),
    (64, 64, 150), (115, 1, 150), (115, 5120, 150), (115, 4099, 1),
    (115, 3, 0), (127, 17, 150), (128, 40, 150), (129, 6, 60),
    (200, 11, 150), (256, 3, 150), (257, 4, 150), (300, 2, 150),
    (513, 3, 40), (1024, 2, 25),
    # the warp design's edges: 2, 3 and 4 points a lane, rows that fill no
    # block of 2, 4 or 8 rows
    (63, 7, 150), (65, 9, 150), (96, 5, 150), (97, 3, 150), (128, 13, 150),
    (115, 4, 150),                          # the facade's call
    (115, 6, 150, "tiny_rho"),
]
# a few penalties a row scaled by this factor, below ieee_fast's window
# [2^-60, 2^60]
TINY_RHO = 2.0 ** -70


def case(i: int, device="cpu"):
    """``(d, iters)`` of case ``i``: the QP data (float32 tensors on
    ``device``, rows in one batch) and the iteration count."""
    n, R, iters = CASES[i][:3]
    rng = np.random.default_rng(1000 + i)
    idx = np.arange(n)
    phase = rng.uniform(0, 2 * np.pi, (R, 1))
    amp = rng.uniform(0.0, 0.04, (R, 1))
    kappa = (amp * np.sin(2 * np.pi * rng.integers(1, 5, (R, 1)) * idx / n
                          + phase)).astype(np.float32)
    el = rng.uniform(2.0, 3.0, (R, n)).astype(np.float32)
    # padded tails (zero element lengths: inactive dynamics rows)
    tail = rng.integers(0, max(n // 3, 1) + 1, R)
    el[idx[None, :] >= n - 1 - tail[:, None]] = 0.0
    el[:, -1] = 0.0
    gg = np.stack([rng.uniform(4.0, 11.0, (R, n)),
                   rng.uniform(4.0, 11.0, (R, n))], -1).astype(np.float32)
    v_start = rng.uniform(0.0, 45.0, R).astype(np.float32)
    # pointwise caps on a third of the rows (a follow-like step down)
    vmax = np.full((R, n), 40.0, np.float32)
    step = rng.integers(0, n, R)
    cap = rng.uniform(5.0, 30.0, R).astype(np.float32)
    follow = rng.random(R) < 1 / 3
    vmax[follow] = np.where(idx[None, :] < step[follow, None], 40.0,
                            cap[follow, None])
    x0 = (v_start[:, None] + rng.uniform(-5.0, 5.0, (R, n))).clip(0.0)
    pin = rng.integers(0, min(4, n), R)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    d = qp._vel_qp_data(
        t(kappa), t(el), t(gg), t(MACHINES), t(vmax), t(v_start),
        v_end=t(rng.uniform(3.0, 8.0, R).astype(np.float32)),
        end_idx=n, pin_idx=t(pin), v_max_scale=40.0,
        x0_v=t(x0.astype(np.float32)))
    if CASES[i][3:] == ("tiny_rho",):
        for k, m in (("rho_box", n), ("rho_acc", n - 1), ("rho_dec", n - 1)):
            pts = rng.integers(0, m, (R, 3))
            scale = np.ones((R, m), np.float32)
            np.put_along_axis(scale, pts, np.float32(TINY_RHO), axis=1)
            d[k] = d[k] * t(scale)
    return d, iters


def label(i: int) -> str:
    n, R, iters = CASES[i][:3]
    return f"n={n} R={R} iters={iters}" + "".join(
        f" {k}" for k in CASES[i][3:])

