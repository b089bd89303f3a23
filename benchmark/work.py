"""The work a kernel call needs, counted from its arguments' shapes and
mode counts, and the card's published peaks: a frozen copy of the
program's kernel-table arithmetic, so that a later change to the program
cannot move the yardstick.

A kernel's roofline share is the least time the card could take for the
work, the larger of its bytes at the HBM rate and its float32 operations
at the rate outside the tensor cores, over the kernel's device time.
"""

from __future__ import annotations

import contextlib
import importlib

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# operations and streams a velocity-scan step reads, by mode: forward,
# brake, backward
_MODE_OPS = {0: 24, 1: 13, 2: 28}
_MODE_STREAMS = {0: 3, 1: 2, 2: 4}


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts
                   if t is not None))


def vel_scan_cgg(args, out):
    """(bytes, operations) of one constant-gg velocity scan: each row's
    ``k``/``ds``/``v_lim`` streams read once for its mode, ``v_init`` and
    ``mode`` read once, the output written once."""
    k1, mode = args[0], args[5]
    T = k1.shape[1]
    counts = {m: int((mode == m).sum()) for m in (0, 1, 2)}
    nb = sum(c * T * 4 * _MODE_STREAMS[m] for m, c in counts.items())
    nb += k1.shape[0] * 8 + nbytes(out)
    ops = sum(c * T * _MODE_OPS[m] for m, c in counts.items())
    return nb, ops


def bound_ms(nb: int, ops: int) -> float:
    return max(nb / PEAK_BYTES_S, ops / PEAK_F32_OPS_S) * 1e3


# each counted kernel: the program's wrapper (module under ops/, name) and
# the pattern of its device kernel's name in a trace
KERNELS = {
    "vel_scan_cgg": ("cuda_velocity", "vel_scan_cgg", "vel_scan_kernel<true"),
}


@contextlib.contextmanager
def recorded(program: str, work: dict):
    """Inside the block every call of a counted kernel's wrapper adds its
    (bytes, operations) to ``work[name]``; the wrappers are restored
    after.  Only an eager call runs the wrappers."""
    saved = []
    try:
        for name, (mod, attr, _) in KERNELS.items():
            m = importlib.import_module(f"{program}.ops.{mod}")
            fn = getattr(m, attr)
            saved.append((m, attr, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                nb, ops = vel_scan_cgg(a, out)
                b0, o0, c0 = work.get(_name, (0, 0, 0))
                work[_name] = (b0 + nb, o0 + ops, c0 + 1)
                return out
            # the wrapper counts its launches on the module's name, which
            # is this function while the block lasts
            wrapped.launches = getattr(fn, "launches", 0)
            setattr(m, attr, wrapped)
        yield work
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)


def roofline_pct(ctx: dict, name: str):
    """A counted kernel's share of its roofline in a fleet trace, or None
    where the trace holds no such kernel or no counted call."""
    pattern = KERNELS[name][2]
    ms = sum(v for k, v in ctx.get("kernel_ms", {}).items() if pattern in k)
    w = ctx.get("work", {}).get(name)
    if not ms or not w:
        return None
    nb, ops, _calls = w
    return 100.0 * bound_ms(nb, ops) / ms
