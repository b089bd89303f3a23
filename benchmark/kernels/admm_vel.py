"""The banded ADMM on velocity QPs (kernel-table row 7):
``ops/cuda_admm.admm_vel``, kernels ``admm_vel_warp_kernel`` (one warp a
row, n <= 128: every call of the planner) and ``admm_vel_kernel`` (one
block a row) of ``csrc/admm_vel.cu``.  A call reads its eleven input rows
(six of n-1 points, five of n) once and writes ``x``, both residuals and,
when asked for them, the duals once.

Operations: 53 + 4 L float32 operations a point and step (L = ceil(log2
n) PCR levels; a division, a maximum or a minimum counts one), the band
and its factor (12 + 8 L a point) and the residuals (20 a point) once:
7.21e9 for the SQP fleet tick's call at B=1024 (5,120 rows x 115 points,
150 steps), where the operations bound the call."""

from benchmark.work import bound_args, nbytes

MODULE = "cuda_admm"
ATTR = "admm_vel"
PATTERN = "admm_vel"
ARGS = ("d", "iters", "sigma", "alpha", "w_smooth", "with_y")
INPUTS = ("e", "f", "rho_acc", "rho_dec", "u_acc", "u_dec", "rho_box", "q",
          "x0", "l_box", "u_box")
ITERS = 60                       # the wrapper's default step count
STEP_OPS, STEP_LEVEL_OPS = 53, 4
ONCE_OPS, ONCE_LEVEL_OPS, RESIDUAL_OPS = 12, 8, 20


def count(args, kwargs, out):
    a = bound_args(ARGS, args, kwargs)
    d, iters = a["d"], a.get("iters", ITERS)
    x, res = out
    n = d["q"].shape[-1]
    levels = max(n - 1, 1).bit_length()
    nb = nbytes(*(d[k] for k in INPUTS), x, res["r_prim"], res["r_dual"],
                res.get("y"))
    ops = d["q"].numel() * (iters * (STEP_OPS + STEP_LEVEL_OPS * levels)
                            + ONCE_OPS + ONCE_LEVEL_OPS * levels
                            + RESIDUAL_OPS)
    return nb, ops
