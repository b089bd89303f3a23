"""Seeded inputs for the stacked velocity recurrences
(``ops/velocity.stacked_vel_scan``) at shapes and mixes the planner's own
calls do not reach: any R and T, the three modes in an irregular order,
machine tables of any length with velocities below, inside and above them,
zero-length tails and rows without a velocity limit.  Plain numpy, so the
same case can go through the JAX package, the plain PyTorch version and the
CUDA kernel.
"""

from __future__ import annotations

import numpy as np

# shapes the kernel's tiling is sensitive to: rows around one and two warps
# and one ragged large count; steps around one chunk and the planner's own
RAGGED_R = (1, 5, 31, 33, 1000)


def ragged_t(chunk: int) -> tuple:
    return (1, 2, chunk - 1, chunk, chunk + 1, 127, 319, 447)


def machine_table(M: int) -> np.ndarray:
    """(M, 2) rows ``[v, ax]``: knots from 5 to 60 m/s (one doubled when
    M >= 4, a zero-width interval), the limit falling from 6 to 1.5."""
    xp = np.linspace(5.0, 60.0, M)
    if M >= 4:
        xp[2] = xp[1]
    fp = np.linspace(6.0, 1.5, M) + 0.2 * np.cos(np.arange(M))
    return np.stack([xp, fp], axis=1).astype(np.float32)


def vel_case(seed: int, R: int, T: int, M: int = 2) -> dict:
    """One call's inputs: per-step ``k1, axm1, aym1, k2, axm2, aym2, ds,
    v_lim`` (R, T), per-row ``v_init, mode`` (R,), ``machines`` (M, 2)."""
    rng = np.random.default_rng(seed)
    mode = rng.integers(0, 3, R).astype(np.int32)
    if R >= 3:                      # every mode present, wherever it falls
        mode[rng.permutation(R)[:3]] = (0, 1, 2)
    f32 = np.float32
    k1 = np.abs(rng.normal(0, 0.02, (R, T))).astype(f32)
    k2 = np.abs(rng.normal(0, 0.02, (R, T))).astype(f32)
    gg = rng.uniform(8, 12, (4, R, T)).astype(f32)
    ds = np.where(rng.random((R, T)) < 0.9, 2.5, 0.0).astype(f32)
    v_lim = np.clip(rng.normal(40, 15, (R, T)), 3, 80).astype(f32)
    # zero-length tails of any length (padded steps: only v_lim acts there)
    tail = rng.integers(0, T + 1, R)
    ds[np.arange(T)[None, :] >= (T - tail)[:, None]] = 0.0
    # a quarter of the rows without a limit, and every BRAKE row
    v_lim[(rng.random(R) < 0.25) | (mode == 1)] = np.inf
    v_init = np.clip(rng.normal(30, 15, R), 1, 75).astype(f32)
    return dict(k1=k1, axm1=gg[0], aym1=gg[1], k2=k2, axm2=gg[2],
                aym2=gg[3], ds=ds, v_lim=v_lim, v_init=v_init, mode=mode,
                machines=machine_table(M))


# (dyn_model_exp, machine-table rows), dealt over the ragged shapes
RAGGED_VARIANTS = ((1.0, 2), (1.5, 16), (1.0, 23), (1.5, 2))


def ragged_case(ri: int, ti: int, const_gg: bool, chunk: int):
    """The case of shape ``(RAGGED_R[ri], ragged_t(chunk)[ti])`` for one of
    the kernel's instances: ``(case, R, T, dyn_model_exp)``."""
    R, T = RAGGED_R[ri], ragged_t(chunk)[ti]
    exp, M = RAGGED_VARIANTS[(ri + ti + const_gg) % len(RAGGED_VARIANTS)]
    return vel_case(1000 + 8 * ri + ti, R, T, M), R, T, exp


GENERAL_ARGS = ("k1", "axm1", "aym1", "k2", "axm2", "aym2", "ds", "v_lim",
                "v_init", "mode", "machines")
CGG_ARGS = ("k1", "k2", "ds", "v_lim", "v_init", "mode", "machines")
