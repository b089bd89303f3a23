"""Where does a solve of the ADMM kernel spend its time?

    python3 -m \
        graphbasedlocaltrajectoryplanner_torch.testing_tools.admm_variants \
        [--sass DIR]

Run it from the root of the repository, on one NVIDIA GPU with nvcc.  It
builds ``csrc/admm_vel.cu`` and ``testing_tools/admm_variants.cu``, then

1. checks the kernel bit-equal to its plain version (``ops/qp.admm_vel_qp``)
   on the seeded cases of ``chip_smoke.ragged_admm``;
2. records the ADMM calls of the SQP fleet tick (default oval, batch 1024,
   one opponent: 5,120 rows of 115 points), of the SQP facade's tick 15
   (oval drive with an opponent and a zone: 4 rows) and of the SQP backup
   ladder (unclosed Monteblanco into its end: 1 row);
3. prints, for each call, the device time of one launch
   (``chip_smoke._device_ms``: launches captured in a CUDA graph, replayed
   between two CUDA events) of the kernel and of every variant of
   ``admm_variants.cu``: the block design (``baseline``), the warp
   design in both layouts (cyclic, blocked) and both placements of the PCR
   tables (registers, shared memory), and ``chain_only`` (the steps'
   exchanges and sweeps without the projection); at the fleet and facade
   calls also each warp variant at 1, 2, 4 and 8 rows a block.  A variant
   that writes the full output is first held bit-equal to the plain
   version, on output memory spoiled beforehand;
4. the chain floor: the kernel on one row of the facade call at 150 and
   at 600 steps; the slope over 450 steps, scaled to 150, is one row's
   chain of steps without the launch and the factor.  Beside it the kernel
   on that one row alone and on the facade's four rows alone.

``--sass DIR`` writes the kernel's machine code (``cuobjdump -sass``) there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# variant numbers of admm_variants.cu
VARIANTS = {"baseline": 0, "warp_cyclic_regs": 1, "warp_cyclic_smem": 2,
            "warp_blocked_regs": 3, "warp_blocked_smem": 4, "chain_only": 5}
FULL_OUTPUT = ("baseline", "warp_cyclic_regs", "warp_cyclic_smem",
               "warp_blocked_regs", "warp_blocked_smem")
ROWS = (1, 2, 4, 8)
# the steps of the chain-floor reading: the planner's, and four times them
STEPS = 150


def start_build(cuda_build):
    """Start nvcc on ``admm_variants.cu``; the handle goes to
    :func:`load_variants`."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "admm_variants.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "admm_variants.so"
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                             "-o", str(lib), src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load_variants(handle):
    """``(admm_variant_launch, ptxas log)`` once the build is done."""
    proc, lib = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + log)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.admm_variant_launch.argtypes = ([I, I] + [P] * 15 + [I] * 3
                                        + [F] * 4 + [P])
    dll.admm_variant_launch.restype = I
    return dll.admm_variant_launch, log


def ptxas_lines(log):
    """The register, stack and spill lines of a ptxas log."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def variant_fn(launch, cuda_build, name, d, kw, rows, with_y=False):
    """``(call, outputs)``: one launch of a variant on call ``(d, kw)``
    into fresh outputs, and those outputs ``(x, r_prim, r_dual, y)``."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    c_args, outs, keep = cuda_admm.kernel_args(
        d, kw.get("iters", 60), w_smooth=kw.get("w_smooth", 1e-4),
        with_y=with_y)

    def call(_keep=keep):
        cuda_build.check(launch(VARIANTS[name], rows, *c_args,
                                cuda_build.stream()), f"admm {name}")
    return call, outs


def held(cs, launch, cuda_build, name, d, kw, rows, label):
    """A variant's x, r_prim, r_dual and y bit-equal to the plain version
    on spoiled output memory; raises where one differs."""
    from graphbasedlocaltrajectoryplanner_torch.ops import qp
    px, pr = qp.admm_vel_qp(d, iters=kw.get("iters", 60),
                            w_smooth=kw.get("w_smooth", 1e-4))
    R = px.numel() // px.shape[-1]
    plain = (px.reshape(R, -1), pr["r_prim"].reshape(R),
             pr["r_dual"].reshape(R), pr["y"].reshape(R, -1))
    for t in plain:
        cs._spoil(t.shape, t.dtype)
    call, outs = variant_fn(launch, cuda_build, name, d, kw, rows, True)
    call()
    torch.cuda.synchronize()
    for what, a, b in zip(("x", "r_prim", "r_dual", "y"), outs, plain):
        cs._check(torch.equal(a, b), f"admm {name} {label}: {what} is not "
                  f"bit-equal to the plain version: "
                  f"{int((a != b).sum())} of {a.numel()} differ")


def variant_ms(device_ms, launch, cuda_build, name, d, kw, rows):
    """A variant's time on call ``(d, kw)``, timed by ``device_ms``."""
    call, _ = variant_fn(launch, cuda_build, name, d, kw, rows)
    return device_ms(call)


def rows_of(d, rows):
    """The kernel's inputs of the listed rows of ``d``, in one batch
    axis."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    R = d["q"].numel() // d["q"].shape[-1]
    return {k: d[k].reshape(R, d[k].shape[-1])[rows].contiguous()
            for k in cuda_admm._LONG + cuda_admm._SHORT}


def chain_floor(device_ms, d, kw):
    """``(floor, one_row, four_rows)`` in ms: the slope of the kernel on
    the first row of ``d`` between ``STEPS`` and ``4 STEPS`` steps, scaled
    to ``STEPS`` steps; the kernel on that row alone and on the first four
    rows alone, at ``kw``'s steps; all timed by ``device_ms``."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    w = kw.get("w_smooth", 1e-4)
    one = rows_of(d, [0])
    t = {s: device_ms(lambda s=s: cuda_admm.admm_vel(
        one, iters=s, w_smooth=w)) for s in (STEPS, 4 * STEPS)}
    floor = (t[4 * STEPS] - t[STEPS]) / 3
    R = d["q"].numel() // d["q"].shape[-1]
    four = rows_of(d, list(range(min(4, R))))
    it = kw.get("iters", 60)
    one_ms = device_ms(lambda: cuda_admm.admm_vel(one, iters=it,
                                                      w_smooth=w))
    four_ms = device_ms(lambda: cuda_admm.admm_vel(four, iters=it,
                                                       w_smooth=w))
    return floor, one_ms, four_ms


def record_sqp_calls(cs):
    """``[(label, d, kw)]``: the ADMM call of the SQP fleet tick (default
    oval, B=1024, 1 opponent), of the SQP facade's tick 15 on the oval and
    the first SQP ladder call into the unclosed Monteblanco end, as
    ``chip_smoke.py`` drives them."""
    import numpy as np
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        closed_loop as cl)
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    target = {"admm_vel": (cuda_admm, "admm_vel")}
    oval = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval").to("cuda")
    res = float(oval.sampled_resolution)
    scen = sc.random_scenarios(oval, cs.B, seed=0, n_objects=1,
                               device="cuda")
    # the eager body: a graph replay passes no call through a recorder
    tick = sc.make_batched_tick(
        oval, device="cuda", vp_backend="sqp", sqp_m=115, sqp_step=res,
        tire_end_idx=int(np.ceil(0.1 * 50 / res)),
        tire_end_mps2=10.0).__wrapped__
    with cs.Recorder(target) as rec:
        tick(scen)
    calls = [("fleet call", rec.calls["admm_vel"][0][0][0],
              rec.calls["admm_vel"][0][1])]
    store = os.path.join(ROOT, "artifacts", "chip_smoke")
    os.makedirs(store, exist_ok=True)
    ltpl = GraphLTPL(cs._sqp_pd(store, "oval", "oval"), device="cuda",
                     log_to_file=False)
    ltpl.graph_init()
    h = ltpl._oth
    pos, heading = cl.start_pose(h.np_refline)
    rec = cs.Recorder(target)
    rec.on = False

    def on_tick(tick):
        rec.on = (tick + 1) == 15
    with rec:
        cl.drive(ltpl, 16, pos, heading,
                 cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl),
                 cl.left_half_zone(h.np_nodes_in_layer), on_tick=on_tick)
    calls.append(("facade tick 15 call", rec.calls["admm_vel"][0][0][0],
                  rec.calls["admm_vel"][0][1]))
    ltpl_u = GraphLTPL(cs._sqp_pd(store, "unclosed_monteblanco", os.path.join(
        ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv")),
        device="cuda", log_to_file=False)
    ltpl_u.graph_init()
    pos, heading = cl.start_pose(ltpl_u._oth.np_refline,
                                 cs.SQP_START_LAYER_UNCLOSED)
    with cs.Recorder(target) as rec:
        cl.drive(ltpl_u, cs.SQP_TICKS_UNCLOSED, pos, heading)
    lad = [(a, kw) for a, kw in rec.calls["admm_vel"]
           if a[0]["q"].dim() == 1]
    cs._check(lad, "no SQP ladder call recorded")
    calls.append(("ladder call", lad[0][0][0], lad[0][1]))
    torch.cuda.synchronize()
    return calls


def main():
    import chip_smoke as cs
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_admm,
                                                            cuda_build)
    if not torch.cuda.is_available():
        raise SystemExit("admm_variants: no CUDA device")
    card = cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"device: {card}", flush=True)
    handle = start_build(cuda_build)
    for name, (secs, log) in cuda_build.build_all(["admm_vel"]).items():
        print(f"{name}: nvcc {secs:.1f} s")
        for ln in ptxas_lines(log):
            print("  ptxas:", ln)
    launch, log = load_variants(handle)
    print("admm_variants.cu:")
    for ln in ptxas_lines(log):
        print("  ptxas:", ln)
    if "--sass" in sys.argv:        # the kernel's machine code, to read
        out_dir = sys.argv[sys.argv.index("--sass") + 1]
        os.makedirs(out_dir, exist_ok=True)
        dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        with open(os.path.join(out_dir, "admm_vel.sass"), "w") as fh:
            subprocess.run([dump, "-sass",
                            str(cuda_build._lib_path("admm_vel"))],
                           stdout=fh, check=True)

    n = cs.ragged_admm()
    print(f"ragged shapes: admm_vel bit-equal to plain on {n} calls",
          flush=True)

    calls = record_sqp_calls(cs)
    for label, d, kw in calls:
        n_pts = d["q"].shape[-1]
        R = d["q"].numel() // n_pts
        iters = kw.get("iters", 60)
        for name in FULL_OUTPUT:
            held(cs, launch, cuda_build, name, d, kw, cuda_admm.WARP_ROWS,
                 label)
        ms = {"kernel": cs._device_ms(lambda: cuda_admm.admm_vel(
            d, iters=iters, w_smooth=kw.get("w_smooth", 1e-4)))}
        for name in VARIANTS:
            ms[name] = variant_ms(cs._device_ms, launch, cuda_build, name,
                                  d, kw, cuda_admm.WARP_ROWS)
        _, ops = cs._cost_admm(d, iters, ())
        print(f"variants admm_vel {label} [{R} rows x {n_pts} points, "
              f"{iters} steps] on {card}: "
              + " | ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
              + f"; bound {ops / cs.PEAK_F32_OPS_S * 1e3:.5f} ms at 67 "
              f"TFLOP/s, {ops / cs.PEAK_F32_NOFMA_OPS_S * 1e3:.5f} ms at "
              f"one operation a lane and cycle ({ops} ops); kernel faster "
              f"than baseline: {ms['kernel'] < ms['baseline']}", flush=True)
        if R > 1:
            sweep = {f"{name}_{rows}": variant_ms(
                cs._device_ms, launch, cuda_build, name, d, kw, rows)
                for name in FULL_OUTPUT[1:] for rows in ROWS}
            print(f"rows a block admm_vel {label} on {card}: "
                  + " | ".join(f"{k} {t:.4f}" for k, t in sweep.items()),
                  flush=True)
    label, d, kw = calls[1]
    floor, one_ms, four_ms = chain_floor(cs._device_ms, d, kw)
    print(f"chain admm_vel {label} on {card}: one row's {STEPS} steps "
          f"{floor:.5f} ms (slope between {STEPS} and {4 * STEPS} steps); "
          f"kernel on 1 row {one_ms:.4f} ms, on 4 rows {four_ms:.4f} ms",
          flush=True)
    print("done")


if __name__ == "__main__":
    main()
