"""The work a kernel call needs, and the card's published peaks.

Each counted kernel is a file ``benchmark/kernels/<name>.py`` that gives
``MODULE``, the program's wrapper module under ``ops/``; ``ATTR``, the
wrapper's name in it; ``PATTERN``, a part of the device kernel's name in
a trace; and ``count(args, kwargs, out) -> (bytes, f32 operations)`` of
one wrapper call, a frozen copy of the program's kernel-table arithmetic,
so that a later change to the program cannot move the yardstick.  A
kernel is added by its file alone.

A kernel's roofline share is the least time the card could take for the
work, the larger of its bytes at the HBM rate and its float32 operations
at the rate outside the tensor cores, over the kernel's device time.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os

# published peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

KERNELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernels")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts
                   if t is not None))


def bound_args(names, args, kwargs) -> dict:
    """A wrapper call's arguments by name (``names`` its parameters in
    order)."""
    return dict(zip(names, args), **kwargs)


def bound_ms(nb: int, ops: int) -> float:
    return max(nb / PEAK_BYTES_S, ops / PEAK_F32_OPS_S) * 1e3


def kernel(name: str):
    """The counted kernel ``name``: its file's module."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.kernels._{name}", os.path.join(KERNELS_DIR,
                                                   f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels() -> dict:
    """Every counted kernel by name."""
    return {f[:-3]: kernel(f[:-3]) for f in sorted(os.listdir(KERNELS_DIR))
            if f.endswith(".py")}


def _wrapper(program: str, k):
    """The program's module and wrapper of kernel ``k``, or None where
    the program has no such wrapper (a kernel taken off the path: its
    roofline goes silent)."""
    full = f"{program}.ops.{k.MODULE}"
    try:
        m = importlib.import_module(full)
    except ModuleNotFoundError as exc:
        if exc.name != full:
            raise
        return None
    fn = getattr(m, k.ATTR, None)
    return None if fn is None else (m, fn)


def _counting(fn, name: str, count, work: dict):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        nb, ops = count(a, kw, out)
        b0, o0, c0 = work.get(name, (0, 0, 0))
        work[name] = (b0 + nb, o0 + ops, c0 + 1)
        return out
    # the wrapper counts its launches on the module's name, which is this
    # function while the block lasts
    wrapped.launches = getattr(fn, "launches", 0)
    return wrapped


@contextlib.contextmanager
def recorded(program: str, work: dict):
    """Inside the block every call of a counted kernel's wrapper adds its
    (bytes, operations, 1), by the kernel's own ``count``, to
    ``work[name]``; the wrappers are restored after.  Only an eager call
    runs the wrappers."""
    saved = []
    try:
        for name, k in kernels().items():
            found = _wrapper(program, k)
            if found is None:
                continue
            m, fn = found
            saved.append((m, k.ATTR, fn))
            setattr(m, k.ATTR, _counting(fn, name, k.count, work))
        yield work
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)


def roofline_pct(ctx: dict, name: str):
    """A counted kernel's share of its roofline in a fleet trace, or None
    where the trace holds no such kernel or no counted call."""
    pattern = kernel(name).PATTERN
    ms = sum(v for k, v in ctx.get("kernel_ms", {}).items() if pattern in k)
    w = ctx.get("work", {}).get(name)
    if not ms or not w:
        return None
    nb, ops, _calls = w
    return 100.0 * bound_ms(nb, ops) / ms
