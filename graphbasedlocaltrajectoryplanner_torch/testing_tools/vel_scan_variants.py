"""Where does a step of the velocity-scan kernel spend its time?

    python3 -m graphbasedlocaltrajectoryplanner_torch.testing_tools.vel_scan_variants [--sass FILE]

Run it from the root of the repository, on one NVIDIA GPU with nvcc.  It
builds ``csrc/vel_scan.cu`` and ``testing_tools/vel_scan_variants.cu``, then

1. holds the branch-free division and square root of ``csrc/ieee_fast.cuh``
   against ``/`` and ``sqrtf``, bit for bit, on 2^32 operands a case;
2. checks the kernel bit-equal to the plain version on the ragged seeded
   cases of ``chip_smoke.ragged_vel_scans``;
3. records the velocity-scan calls of one fleet tick (default oval, batch
   1024, one opponent) and of facade tick 15 (oval drive with an opponent
   and a zone) and prints, for each call, the device time of one launch
   (``chip_smoke._device_ms``: launches captured in a CUDA graph, replayed
   between two CUDA events) of the kernel and of every variant: the
   one-thread-per-row baseline; the baseline with rows regrouped by mode;
   the baseline's arithmetic on inputs staged through shared memory; the
   baseline's arithmetic alone on constant inputs, without and with zero
   guards around its divisions and roots; the kernel's own step alone where
   all rows of a call run one mode.  A variant that writes the full output
   is first held bit-equal to the plain version;
4. forces one mode on all rows of a fleet call, and runs 32 synthetic rows
   of one mode and one kind of operands (constant v, a straight, a row at
   standstill ...), to read each mode's latency per step.

``--sass FILE`` writes the kernel's machine code (``cuobjdump -sass``) to FILE.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VARIANTS = ("baseline", "regrouped", "staged_mixed", "arith_only",
            "arith_guarded")
MODE_NAMES = {0: "FWD", 1: "BRAKE", 2: "BWD"}


def build_variants(cuda_build):
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "vel_scan_variants.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "vel_scan_variants.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), src], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.vel_variant_launch.argtypes = ([I] + [P] * 12 + [I, P, I, I, I]
                                       + [F] * 5 + [P])
    dll.vel_variant_launch.restype = ctypes.c_int
    dll.check_ieee_fast.argtypes = [I, F, P, P]
    dll.check_ieee_fast.restype = ctypes.c_int
    return dll.vel_variant_launch, dll.check_ieee_fast


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
    import chip_smoke as cs
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_build,
                                                            cuda_velocity)
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    if not torch.cuda.is_available():
        raise SystemExit("vel_scan_variants: no CUDA device")
    card = cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"device: {card}", flush=True)
    built = cuda_build.build_all(["vel_scan"])
    for name, (secs, log) in built.items():
        print(f"{name}: nvcc {secs:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())
    variant_launch, check = build_variants(cuda_build)
    check_ieee_fast(check, cuda_build)
    if "--sass" in sys.argv:        # the kernel's machine code, to read
        path = sys.argv[sys.argv.index("--sass") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        with open(path, "w") as fh:
            subprocess.run([dump, "-sass",
                            str(cuda_build._lib_path("vel_scan"))],
                           stdout=fh, check=True)

    n = cs.ragged_vel_scans(cuda_velocity.CHUNK)
    print(f"ragged shapes: kernel bit-equal to plain on {n} calls", flush=True)

    # ---- the calls to time -------------------------------------------------
    oval = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval").to("cuda")
    scen = sc.random_scenarios(oval, cs.B, seed=0, n_objects=1,
                               device="cuda")
    # the eager body: a graph replay passes no call through a recorder
    tick = sc.make_batched_tick(oval, device="cuda").__wrapped__
    targets = {"vel_scan_cgg": (cuda_velocity, "vel_scan_cgg"),
               "vel_scan": (cuda_velocity, "vel_scan")}
    with cs.Recorder(targets) as rec:
        tick(scen)
    torch.cuda.synchronize()
    calls = [(f"fleet cgg {i}", True, a)
             for i, (a, _) in enumerate(rec.calls["vel_scan_cgg"])]
    calls += [(f"fleet general {i}", False, a)
              for i, (a, _) in enumerate(rec.calls["vel_scan"])]
    calls += [(f"facade tick 15 call {i}", False, a) for i, (a, _) in
              enumerate(facade_calls(cs, targets, ("vel_scan",))["vel_scan"])]

    def as_general(cgg, a):
        """(k1, a1, y1, k2, a2, y2, ds, v_lim, v_init, mode, machines,
        exp, drag, m_veh, gg or None) of a recorded call."""
        if cgg:
            k1, k2, ds, vl, vi, md, mach, exp, drag, m, gx, gy = a
            return (k1, None, None, k2, None, None, ds, vl, vi, md, mach,
                    exp, drag, m, (gx, gy))
        return (*a, None)

    def run_variant(v, g, out, perm):
        k1, a1, y1, k2, a2, y2, ds, vl, vi, md, mach, exp, drag, m, gg = g
        assert float(exp) == 1.0
        R, T = k1.shape
        p = lambda x: ctypes.c_void_p(0 if x is None else x.data_ptr())
        f = ctypes.c_float
        gx, gy = gg if gg is not None else (0.0, 0.0)
        rc = variant_launch(
            v, p(k1), p(a1), p(y1), p(k2), p(a2), p(y2), p(ds), p(vl),
            p(vi), p(md), p(perm), p(mach), mach.shape[0], p(out), R, T,
            int(gg is not None), f(gx), f(gy), f(drag), f(m),
            f(velops._INTERP_EPS), cuda_build.stream())
        cuda_build.check(rc, f"variant {v}")

    def time_call(label, cgg, a, compare=True):
        g = as_general(cgg, a)
        g = tuple(x.contiguous() if torch.is_tensor(x) else x for x in g)
        k1, md = g[0], g[9].to(torch.int32)
        g = g[:9] + (md,) + g[10:]
        R, T = k1.shape
        perm = torch.argsort(md, stable=True).to(torch.int32)
        kern = cuda_velocity.vel_scan_cgg if cgg else cuda_velocity.vel_scan
        plain = ((lambda *x: velops.stacked_vel_scan_cgg_auto(
            *x, kernels=False)) if cgg else velops.stacked_vel_scan)
        ref = plain(*a) if compare else None
        out = torch.empty((R, T + 1), dtype=torch.float32, device="cuda")
        ms = {}
        for v, name in enumerate(VARIANTS):
            run_variant(v, g, out, perm)
            torch.cuda.synchronize()
            if compare and not name.startswith("arith"):
                cs._check(torch.equal(out, ref), f"{label}: variant {name} "
                          "is not bit-equal to the plain version")
            ms[name] = cs._device_ms(lambda: run_variant(v, g, out, perm))
        modes = set(md.tolist())
        if len(modes) == 1:         # the kernel's own step alone
            v = 5 + min(modes.pop(), 2)
            ms["step_only"] = cs._device_ms(
                lambda: run_variant(v, g, out, perm))
        if compare:
            cs._check(torch.equal(kern(*a), ref),
                      f"{label}: kernel not bit-equal")
        ms["kernel"] = cs._device_ms(lambda: kern(*a))
        counts = {MODE_NAMES[m]: int((md == m).sum()) for m in (0, 1, 2)
                  if int((md == m).sum())}
        print(f"variants {label} [{R}x{T}] {counts} on {card}: "
              + " | ".join(f"{k} {t:.4f} ms" for k, t in ms.items()),
              flush=True)
        return ms

    def per_step(ms, T):
        return ", ".join(f"{k} {ms[k] * 1e6 / T:.1f} ns a step" for k in
                         ("arith_only", "arith_guarded", "step_only",
                          "kernel"))

    for label, cgg, a in calls:
        time_call(label, cgg, a)

    # ---- the chain latency of each mode ------------------------------------
    for src in ("fleet cgg 2", "fleet general 1"):
        label, cgg, a = next(c for c in calls if c[0] == src)
        T = a[0].shape[1]
        mi = 5 if cgg else 9
        for m in (0, 1, 2):
            forced = list(a)
            forced[mi] = torch.full_like(a[mi], m)
            ms = time_call(f"{label} forced {MODE_NAMES[m]}", cgg,
                           tuple(forced), compare=False)
            print(f"chain {MODE_NAMES[m]} ({'const gg' if cgg else 'general'}"
                  f", T={T}): " + per_step(ms, T), flush=True)
    # ---- the chain on inputs of one kind ------------------------------------
    # 32 rows of one mode, 447 equal steps: which operands make a step slow?
    T = 447
    kinds = {"BRAKE, v constant (ds = 0)": (1, 30.0, 0.01, 0.0),
             "BRAKE, v constant, straight (kappa = 0)": (1, 30.0, 0.0, 0.0),
             "BRAKE, braking slowly, never stops": (1, 60.0, 0.001, 0.01),
             "BRAKE, brakes to a stop, then v = 0": (1, 30.0, 0.01, 2.5),
             "BRAKE, v = 0 throughout": (1, 0.0, 0.01, 2.5),
             "FWD, v constant (ds = 0)": (0, 30.0, 0.01, 0.0),
             "FWD, accelerating to v_lim = 70": (0, 5.0, 0.0, 2.5),
             "BWD, v constant (ds = 0)": (2, 30.0, 0.01, 0.0),
             "BWD, rising to v_lim = 70": (2, 5.0, 0.0, 2.5)}
    mach = calls[0][2][6]
    for kind, (m, v0, kap, d) in kinds.items():
        full = lambda x: torch.full((32, T), x, dtype=torch.float32,
                                    device="cuda")
        a = (full(kap), full(kap), full(d),
             full(float("inf") if m == 1 else 70.0),
             torch.full((32,), v0, dtype=torch.float32, device="cuda"),
             torch.full((32,), m, dtype=torch.int32, device="cuda"), mach,
             1.0, 0.85, 1000.0, 10.0, 9.0)
        ms = time_call(f"synthetic {kind}", True, a)
        print(f"chain synthetic {kind}: " + per_step(ms, T), flush=True)
    print("done")


def facade_calls(cs, targets, names):
    """The calls ``(args, kwargs)`` of the named kernels in tick 15 of the
    facade's oval drive, by name."""
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    store = os.path.join(ROOT, "artifacts", "chip_smoke")
    os.makedirs(store, exist_ok=True)
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": os.path.join(store, "oval.npz"),
          "ltpl_offline_param_path": os.path.join(
              ROOT, "params/ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              ROOT, "params/ltpl_config_online.ini"),
          "graph_log_id": "oval", "log_path": os.path.join(store, "logs")}
    ltpl = GraphLTPL(pd, device="cuda", log_to_file=False)
    ltpl.graph_init()
    h = ltpl._oth
    pos, heading = cl.start_pose(h.np_refline, 0)
    rec = cs.Recorder({name: targets[name] for name in names})
    rec.on = False

    def on_tick(tick):
        rec.on = (tick + 1) == 15
    with rec:
        cl.drive(ltpl, 16, pos, heading,
                 cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl),
                 cl.left_half_zone(h.np_nodes_in_layer), on_tick=on_tick)
    torch.cuda.synchronize()
    return rec.calls


if __name__ == "__main__":
    main()
