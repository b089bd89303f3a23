"""The velocity scan's constant-gg instance (kernel-table row 4):
``ops/cuda_velocity.vel_scan_cgg``, kernel ``vel_scan_kernel<true, ...>``
of ``csrc/vel_scan.cu``.  A call reads each row's ``k``/``ds``/``v_lim``
streams once for its mode, ``v_init`` and ``mode`` once, and writes the
output once; a step costs its mode's operations."""

from benchmark.work import bound_args, nbytes

MODULE = "cuda_velocity"
ATTR = "vel_scan_cgg"
PATTERN = "vel_scan_kernel<true"
ARGS = ("k1", "k2", "ds", "v_lim", "v_init", "mode")

# operations and streams a step reads, by mode: forward, brake, backward
_MODE_OPS = {0: 24, 1: 13, 2: 28}
_MODE_STREAMS = {0: 3, 1: 2, 2: 4}


def count(args, kwargs, out):
    a = bound_args(ARGS, args, kwargs)
    k1, mode = a["k1"], a["mode"]
    T = k1.shape[1]
    counts = {m: int((mode == m).sum()) for m in (0, 1, 2)}
    nb = sum(c * T * 4 * _MODE_STREAMS[m] for m, c in counts.items())
    nb += k1.shape[0] * 8 + nbytes(out)
    ops = sum(c * T * _MODE_OPS[m] for m, c in counts.items())
    return nb, ops
