"""The branch-free division and square root of ``csrc/ieee_fast.cuh`` (the
velocity scans') against ``/`` and ``sqrtf``, bit for bit, on 2^32 operands
a case:

    python3 -m graphbasedlocaltrajectoryplanner_torch.testing_tools.ieee_fast_check

Run it on one NVIDIA GPU with nvcc.  It builds
``testing_tools/ieee_fast_check.cu`` with the kernels' flags, prints one
line a case and raises on a single differing bit.  ``chip_smoke.py`` runs
it after building the kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch


def build(cuda_build):
    """Compile ``ieee_fast_check.cu``; returns its launcher
    ``check_ieee_fast(kind, y_fixed, res, stream)``."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ieee_fast_check.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "ieee_fast_check.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), src], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.check_ieee_fast.argtypes = [ctypes.c_int, ctypes.c_float,
                                    ctypes.c_void_p, ctypes.c_void_p]
    dll.check_ieee_fast.restype = ctypes.c_int
    return dll.check_ieee_fast


def check_ieee_fast(check, cuda_build):
    """``csrc/ieee_fast.cuh`` against ``/`` and ``sqrtf``, bit for bit, on
    2^32 operands per case; raises on a single difference."""
    cases = [("sqrt, every float32", 0, 0.0)]
    cases += [(f"x / {y!r}, every float32 x", 1, y)
              for y in (1000.0, 1160.0, 9.0, 1e-9, 100.0, 3.7, -12.5)]
    cases += [("x / y, random bits", 2, 0.0),
              ("x / y, random operands across the window", 3, 0.0)]
    for label, kind, y in cases:
        res = torch.zeros(2, dtype=torch.int64, device="cuda")
        cuda_build.check(check(kind, y, ctypes.c_void_p(res.data_ptr()),
                               cuda_build.stream()), "check_ieee_fast")
        accepted, wrong = res.tolist()
        print(f"ieee_fast {label}: {accepted} operands accepted, "
              f"{wrong} differ from the plain operator", flush=True)
        if wrong or not accepted:
            raise RuntimeError(f"ieee_fast {label}: {wrong} of {accepted}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ieee_fast_check: no CUDA device")
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build
    check_ieee_fast(build(cuda_build), cuda_build)


if __name__ == "__main__":
    main()
