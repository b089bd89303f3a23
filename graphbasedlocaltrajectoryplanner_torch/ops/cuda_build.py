"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled on its own by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, into ``_build/`` inside
the package (listed in ``.gitignore``), keyed by a hash of the source, the headers
(``csrc/*.cuh``) and the flags; :func:`build_all` starts every missing build at once.

Flags: ``sm_90a``, ``-O3``, and ``-fmad=false`` without fast math, so
every product rounds on its own as in the plain PyTorch versions (an FMA
would round ``dx*dx + dy*dy`` differently and flip boundary comparisons).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("hit_slab", "window_dp", "backtrace", "vel_scan", "minplus",
           "admm_vel", "assemble")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):     # shared by the sources
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every listed source whose library is missing, all ``nvcc``
    processes started together.  Returns ``{name: (seconds, ptxas log)}``
    for the sources built now; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (secs, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C entry point and argument types of each source
_ENTRY = {
    "hit_slab": ("hit_slab_launch", [_P] * 6 + [_I] * 6 + [_P]),
    "window_dp": ("window_dp_launch",
                  [_P, _P, _LL] + [_P] * 11 + [_I] * 8 + [_P]),
    "backtrace": ("backtrace_launch", [_P] * 5 + [_I] * 6 + [_P]),
    "vel_scan": ("vel_scan_launch",
                 [_P] * 11 + [_I, _P, _I, _I, _I] + [_F] * 7 + [_P]),
    "minplus": ("minplus_launch", [_P] * 4 + [_I] * 5 + [_P]),
    "admm_vel": ("admm_vel_launch", [_P] * 15 + [_I] * 3 + [_F] * 4 + [_P]),
    "assemble": ("assemble_launch", [_P] * 9 + [_I] * 7 + [_P]),
}


def load(name: str):
    """The C entry point of one source (argument and return types set),
    its library built first if needed."""
    fn = _LIBS.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        entry, argtypes = _ENTRY[name]
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


# each kernel's name and its wrapper (module and function under ops/), whose
# ``launches`` the wrapper moves where it launches the kernel
KERNEL_WRAPPERS = dict(
    hit_slab="cuda_collision.hit_slab",
    window_dp="cuda_window.fused_window_dp",
    backtrace="cuda_backtrace.backtrace_walk",
    vel_scan_cgg="cuda_velocity.vel_scan_cgg",
    vel_scan="cuda_velocity.vel_scan",
    minplus="cuda_minplus.minplus_scan",
    admm_vel="cuda_admm.admm_vel",
    assemble="cuda_assemble.assemble_path")


def wrappers() -> dict:
    """Each kernel's wrapper by name (:data:`KERNEL_WRAPPERS`)."""
    import importlib
    out = {}
    for name, path in KERNEL_WRAPPERS.items():
        mod, fn = path.split(".")
        out[name] = getattr(importlib.import_module(
            f"{__package__}.{mod}"), fn)
    return out


def counted(fn, dev):
    """``fn()`` with every kernel's launch count set to 0 just before it
    and read just after (synchronised on the card):
    ``(out, {name: launches})``."""
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    out = fn()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return out, {name: w.launches for name, w in ws.items()}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# the index types the kernels read as they come
INDEX_DTYPES = (torch.int32, torch.int64)


def index_arg(t: torch.Tensor):
    """An index tensor as a kernel that reads int32 or int64 takes it:
    ``(tensor, wide)``, converted to int32 only from another type."""
    if t.dtype not in INDEX_DTYPES:
        t = t.to(torch.int32)
    return t.contiguous(), int(t.dtype == torch.int64)


def index_tensor(t: torch.Tensor, shape: tuple, what: str):
    """``(tensor, wide)`` of an index tensor that must already be int32 or
    int64 (no conversion kernel); raises on another type or shape."""
    t = t.contiguous()
    require(t, INDEX_DTYPES, shape, what)
    return t, int(t.dtype == torch.int64)


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, name: str) -> None:
    if rc == -1:
        raise ValueError(f"CUDA kernel {name}: the shape needs more threads "
                         "or shared memory than a block has (or an input "
                         "is not aligned)")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def require(t: torch.Tensor, dtype, shape: tuple, what: str):
    """Raise unless ``t`` is a contiguous CUDA tensor of this shape and of
    this dtype (or of one of a tuple of dtypes)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: expected "
                         f"{' or '.join(str(d) for d in dtypes)}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
