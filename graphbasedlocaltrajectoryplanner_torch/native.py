"""ctypes bindings for the port's native host library
(``native/ltpl_native.cpp``, the port's own copy of the JAX package's) —
counterpart of the JAX package's ``native.py``.

The library is built with ``g++`` at first use into ``_build/`` inside the
package (listed in ``.gitignore``), with the flags of the JAX package's
``native/Makefile``: ``-march=native`` lets g++ contract multiply-adds into
FMAs, so other flags would round ``fb_profile`` differently from the JAX
package's library.  Its name is keyed by a hash of the source, the flags
and the host CPU (code built for one CPU may not run on another).
Concurrent builds (several test workers) each write a temporary file and
move it into place.  A failed build or load raises
with the compiler's output; nothing falls back to another implementation.

Provides: fast track-CSV loading, the variable-step-size walk, and scalar
oracles (min-plus DP, fb velocity solver) used as independent goldens.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "ltpl_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]

_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    """The CPU's feature flags (Linux), else the machine's name."""
    try:
        with open("/proc/cpuinfo") as fh:
            for ln in fh:
                if ln.startswith("flags"):
                    return ln.encode()
    except OSError:
        pass
    return platform.machine().encode()


def build(cxx: str = CXX, build_dir: Path = BUILD_DIR) -> Path:
    """The library's path, compiled first with ``cxx`` if it is missing.
    Raises RuntimeError with the compiler's output when the build fails."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _host_cpu()).hexdigest()[:12]
    out = Path(build_dir) / f"ltpl_native-{key}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native build: cannot run {cxx!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({cxx}, exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.ltpl_load_csv.restype = ctypes.c_int
        lib.ltpl_load_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int]
        lib.ltpl_variable_step_size.restype = ctypes.c_int
        lib.ltpl_variable_step_size.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, np.ctypeslib.ndpointer(np.int32, flags="C")]
        lib.ltpl_minplus_dp.restype = ctypes.c_int
        lib.ltpl_minplus_dp.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C"),
            np.ctypeslib.ndpointer(np.float32, flags="C"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.POINTER(ctypes.c_float)]
        lib.ltpl_fb_profile.restype = None
        lib.ltpl_fb_profile.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            np.ctypeslib.ndpointer(np.float64, flags="C")]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built (or builds now) and loads; False when
    it cannot be built, in which case every entry point raises."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def load_csv(path: str, n_cols: int = 12, max_rows: int = 100000):
    """Native CSV parse (``;``-separated, ``#`` comments); returns the
    (rows, n_cols) float64 array.  Raises OSError if the file cannot be
    opened."""
    out = np.empty((max_rows, n_cols), np.float64)
    n = _load().ltpl_load_csv(os.fsencode(path), n_cols, out, max_rows)
    if n < 0:
        raise OSError(f"native load_csv: cannot open {path}")
    return out[:n].copy()


def variable_step_size(kappa, dist, d_curve, d_straight, curve_th,
                       force_last=False):
    """The reference's variable layer-spacing walk; returns the selected
    indices as a list."""
    kappa = np.ascontiguousarray(kappa, np.float64)
    dist = np.ascontiguousarray(dist, np.float64)
    if dist.shape != kappa.shape:
        raise ValueError(f"dist {dist.shape} != kappa {kappa.shape}")
    out = np.empty((len(kappa) + 1,), np.int32)
    n = _load().ltpl_variable_step_size(kappa, dist, len(kappa), d_curve,
                                        d_straight, curve_th,
                                        int(force_last), out)
    return list(out[:n])


def minplus_dp(w, vg, start, h_goal, shrink=True, inf_thresh=1e29):
    """Scalar DP oracle over one (H, N, N) window: returns (h_eff,
    nodes (H+1,), cost)."""
    w = np.ascontiguousarray(w, np.float32)
    vg = np.ascontiguousarray(vg, np.float32)
    H, N, _ = w.shape
    if w.shape != (H, N, N) or vg.shape != (H + 1, N):
        raise ValueError(f"w {w.shape} / vg {vg.shape}: expected (H, N, N) "
                         "and (H+1, N)")
    if not (0 <= int(start) < N and 1 <= int(h_goal) <= H):
        raise ValueError(f"start {start} / h_goal {h_goal} out of range")
    nodes = np.empty((H + 1,), np.int32)
    cost = ctypes.c_float()
    h_eff = _load().ltpl_minplus_dp(w, vg, H, N, int(start), int(h_goal),
                                    int(shrink), np.float32(inf_thresh),
                                    nodes, ctypes.byref(cost))
    return h_eff, nodes, float(cost.value)


def fb_profile(kappa, el, gg, machines, v_max, v_start, v_end=None,
               dyn_exp=1.0, drag=0.85, mass=1000.0):
    """Scalar fb velocity-profile oracle; returns the (P,) profile."""
    kappa = np.ascontiguousarray(kappa, np.float64)
    el = np.ascontiguousarray(el, np.float64)
    gg = np.ascontiguousarray(gg, np.float64)
    machines = np.ascontiguousarray(machines, np.float64)
    P = len(kappa)
    if el.shape != (P,) or gg.shape != (P, 2) or machines.ndim != 2 \
            or machines.shape[1] != 2:
        raise ValueError(f"kappa {kappa.shape} el {el.shape} gg {gg.shape} "
                         f"machines {machines.shape}")
    out = np.empty_like(kappa)
    _load().ltpl_fb_profile(kappa, el, gg, P, machines, machines.shape[0],
                            float(v_max), float(v_start),
                            float(v_end if v_end is not None else 0.0),
                            int(v_end is not None), float(dyn_exp),
                            float(drag), float(mass), out)
    return out
