"""Where does a launch of the backpointer walk and of the min-plus scan
spend its time?

    python3 -m \
        graphbasedlocaltrajectoryplanner_torch.testing_tools.walk_variants \
        [--sass DIR]

Run it from the root of the repository, on one NVIDIA GPU with nvcc.  It
builds ``csrc/backtrace.cu``, ``csrc/minplus.cu`` and
``testing_tools/walk_variants.cu``, then

1. checks both kernels bit-equal to their plain versions on the seeded
   cases of ``chip_smoke.ragged_walk_kernels``;
2. records the walk's call of one fleet tick at batch 1024 in three mixes
   (default oval with 1 opponent, with 3 opponents in 16 slots, unclosed
   Monteblanco), of facade tick 15 (oval drive with an opponent and a
   zone) and of the dense-window search at batch 1024, and the dense
   window's min-plus call;
3. prints, for each call, the device time of one launch
   (``chip_smoke._device_ms``: launches captured in a CUDA graph, replayed
   between two CUDA events) of the kernel and of every variant of
   ``walk_variants.cu``.  Walk: the first design behind the gather of the
   chosen slots' tables and the int32 conversions of its index tensors, as
   its callers and wrapper made it (``baseline``), the first design alone,
   the new kernel behind the same gather and conversions, and the walk
   alone on a table already on chip (``walk_only``; the slope between 1
   and 4 walks is one walk's chain, the chain floor).  Min-plus: the first
   design behind its wrapper's int32 conversion (``baseline``), the window
   streamed through the rings without the DP (``stream_only``, the bytes
   floor), the relax steps alone on slabs in shared memory
   (``relax_only``), the kernel's 4-byte ``cp.async`` path, and the kernel
   behind an int32 conversion of its start nodes; then the kernel and
   ``stream_only`` at other ring shapes.  A variant that writes the full
   output is first held bit-equal to the plain version, on output memory
   spoiled beforehand.

``--sass DIR`` writes both kernels' machine code (``cuobjdump -sass``) there.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# walks a walk_only launch makes for the slope (its chain floor)
REPS = 4
# min-plus rings timed: (steps a stage, stages)
RINGS = ((1, 4), (2, 4), (2, 3), (4, 3), (4, 2), (8, 2))


def start_build(cuda_build):
    """Start nvcc on ``walk_variants.cu``; the handle goes to
    :func:`load_variants`."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "walk_variants.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "walk_variants.so"
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                             "-o", str(lib), src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load_variants(handle):
    """``(bt_variant_launch, mp_variant_launch)`` once the build is done."""
    proc, lib = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + log)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.bt_variant_launch.argtypes = [I, I] + [P] * 5 + [I] * 6 + [P]
    dll.bt_variant_launch.restype = I
    dll.mp_variant_launch.argtypes = [I] + [P] * 4 + [I] * 5 + [P]
    dll.mp_variant_launch.restype = I
    dll.mp_blocks_per_sm.argtypes = [I] * 3
    dll.mp_blocks_per_sm.restype = I
    load_variants.blocks_per_sm = dll.mp_blocks_per_sm
    return dll.bt_variant_launch, dll.mp_variant_launch


def walk_chain(device_ms, cuda_build, bt_variant, a, kw):
    """(one walk, one launch) in ms of ``walk_only`` on call ``(a, kw)``,
    timed by ``device_ms``: the slope between launches of 1 and ``REPS``
    walks, and the launch of 1 walk."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_backtrace
    c_args, _, keep = cuda_backtrace.kernel_args(*a, **kw)
    ms = {}
    for reps in (1, REPS):
        ms[reps] = device_ms(lambda reps=reps: cuda_build.check(
            bt_variant(1, reps, *c_args, cuda_build.stream()),
            "walk_only"))
    return (ms[REPS] - ms[1]) / (REPS - 1), ms[1]


def gathered(a):
    """The call as its callers and wrapper made it before the slot form:
    the chosen slots' tables copied out, int64 indices converted to int32
    (a kernel each)."""
    bp, goal, heff, *slot = a
    if slot:
        R = goal.shape[0]
        rows = torch.arange(R, device=bp.device) // (R // bp.shape[0])
        bp = bp[rows, slot[0].long()]
    return (bp, goal.to(torch.int32), heff.to(torch.int32))


def main():
    import chip_smoke as cs
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_backtrace, cuda_build, cuda_minplus)
    from graphbasedlocaltrajectoryplanner_torch.ops import search as srch
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        vel_scan_variants as vv)
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    if not torch.cuda.is_available():
        raise SystemExit("walk_variants: no CUDA device")
    card = cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"device: {card}", flush=True)
    handle = start_build(cuda_build)
    built = cuda_build.build_all(["backtrace", "minplus"])
    for name, (secs, log) in built.items():
        print(f"{name}: nvcc {secs:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())
    bt_variant, mp_variant = load_variants(handle)
    if "--sass" in sys.argv:        # the kernels' machine code, to read
        out_dir = sys.argv[sys.argv.index("--sass") + 1]
        os.makedirs(out_dir, exist_ok=True)
        dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        for name in ("backtrace", "minplus"):
            with open(os.path.join(out_dir, f"{name}.sass"), "w") as fh:
                subprocess.run([dump, "-sass",
                                str(cuda_build._lib_path(name))],
                               stdout=fh, check=True)

    n_w, n_m = cs.ragged_walk_kernels()
    print(f"ragged shapes: backtrace bit-equal to plain on {n_w} calls, "
          f"minplus on {n_m}", flush=True)

    # ---- the calls to time -------------------------------------------------
    oval = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval").to("cuda")
    mb = tl.build_lattice(
        tt.import_globtraj_csv(os.path.join(
            ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv")),
        OfflineConfig(), md5_params="mb_open").to("cuda")
    target = {"backtrace": (cuda_backtrace, "backtrace_walk")}
    walks = []
    for mix, lat, skw in (
            ("oval_1opp", oval, dict(n_objects=1)),
            ("oval_3opp_o16", oval, dict(n_objects=3, o_pad=sc.O_PAD)),
            ("unclosed_monteblanco_1opp", mb, dict(n_objects=1))):
        scen = sc.random_scenarios(lat, cs.B, seed=0, device="cuda", **skw)
        # the eager body: a graph replay passes no call through a recorder
        with cs.Recorder(target) as rec:
            sc.make_batched_tick(lat, device="cuda").__wrapped__(scen)
        walks += [(f"fleet {mix}", *c) for c in rec.calls["backtrace"]]
    walks += [("facade tick 15", *c) for c in vv.facade_calls(
        cs, target, ("backtrace",))["backtrace"]]
    scen = sc.random_scenarios(oval, cs.B, seed=0, n_objects=1,
                               device="cuda")
    win_args, start4, shrink4 = cs.dense_window_inputs(oval, scen)
    dense = pg.plan_window_dense(*win_args)
    with cs.Recorder(target) as rec:
        srch.search_window(dense["w_all"], start4, dense["vg"],
                           dense["h_goal"].long()[:, None].expand(cs.B, 4),
                           shrink4)
    walks += [("dense window", *c) for c in rec.calls["backtrace"]]
    torch.cuda.synchronize()

    def line(kind, label, shape, ms):
        print(f"variants {kind} {label} [{shape}] on {card}: "
              + " | ".join(f"{k} {t:.4f} ms" for k, t in ms.items()),
              flush=True)

    def held(what, label, out, ref, run):
        out.fill_(-7)
        run()
        torch.cuda.synchronize()
        cs._check(torch.equal(out, ref), f"{label}: {what} is not "
                  f"bit-equal to the plain version: "
                  f"{int((out != ref).sum())} entries differ")

    # ---- walk ---------------------------------------------------------------
    for label, a, kw in walks:
        ref = cuda_backtrace.backtrace_walk_plain(*a, **kw)
        ms = {}
        c_args, out, keep = cuda_backtrace.kernel_args(*gathered(a))

        def old_call(out=out):
            """The first design behind the gather and the conversions."""
            bp, goal, heff = gathered(a)
            R, Hp1, N = bp.shape
            cuda_build.check(bt_variant(
                0, 1, cuda_build.ptr(bp), cuda_build.ptr(goal),
                cuda_build.ptr(heff), None, cuda_build.ptr(out), R, Hp1, N,
                1, 1, 0, cuda_build.stream()), "walk baseline")
        held("baseline", label, out, ref, old_call)
        ms["baseline"] = cs._device_ms(old_call)
        ms["baseline_kernel_alone"] = cs._device_ms(
            lambda: cuda_build.check(bt_variant(
                0, 1, *c_args, cuda_build.stream()), "walk baseline"))
        ms["kernel_behind_gather"] = cs._device_ms(
            lambda: cuda_backtrace.backtrace_walk(*gathered(a)))
        c_args, out, keep = cuda_backtrace.kernel_args(*a, **kw)
        held("walk_only", label, out, ref, lambda: cuda_build.check(
            bt_variant(1, 1, *c_args, cuda_build.stream()), "walk_only"))
        cs._check(torch.equal(cuda_backtrace.backtrace_walk(*a, **kw), ref),
                  f"{label}: backtrace kernel not bit-equal")
        ms["kernel"] = cs._device_ms(
            lambda: cuda_backtrace.backtrace_walk(*a, **kw))
        chain, ms["walk_only"] = walk_chain(cs._device_ms, cuda_build,
                                            bt_variant, a, kw)
        bp, goal = a[0], a[1]
        line("backtrace", label, f"R={goal.shape[0]} bp {list(bp.shape)} "
             f"{'slot form' if len(a) > 3 else ''}", ms)
        Hp1 = bp.shape[-2]
        print(f"chain backtrace {label}: one walk of H+1={Hp1} layers "
              f"{chain:.5f} ms ({chain / Hp1 * 1e6:.1f} ns a step); kernel "
              f"faster than baseline: {ms['kernel'] < ms['baseline']}",
              flush=True)

    # ---- min-plus -----------------------------------------------------------
    w_all = dense["w_all"]
    ref = cuda_minplus.minplus_scan_plain(w_all, start4)
    R = start4.numel()
    ms = {}

    def mp_run(v, c_args):
        cuda_build.check(mp_variant(v, *c_args, cuda_build.stream()),
                         f"minplus variant {v}")

    def mp_held(what, best, bp, run):
        best.fill_(float("nan"))
        bp.fill_(-7)
        run()
        torch.cuda.synchronize()
        cs._check(torch.equal(best, ref[0].reshape(best.shape))
                  and torch.equal(bp, ref[1].reshape(bp.shape)),
                  f"dense window: minplus {what} is not bit-equal")

    c32, best, bp, keep = cuda_minplus.kernel_args(
        w_all, start4.to(torch.int32).reshape(R))

    def old_call():
        """The first design behind its wrapper's int32 conversion."""
        s32 = start4.to(torch.int32).reshape(R)
        mp_run(0, (c32[0], cuda_build.ptr(s32), *c32[2:]))
    mp_held("baseline", best, bp, old_call)
    ms["baseline"] = cs._device_ms(old_call)
    c_args, best, bp, keep = cuda_minplus.kernel_args(w_all, start4)
    ms["stream_only"] = cs._device_ms(lambda: mp_run(1, c_args))
    ms["relax_only"] = cs._device_ms(lambda: mp_run(2, c_args))
    mp_held("cp.async path", best, bp, lambda: mp_run(3, c_args))
    ms["cp_async_path"] = cs._device_ms(lambda: mp_run(3, c_args))
    ko = cuda_minplus.minplus_scan(w_all, start4)
    cs._check(torch.equal(ko[0], ref[0]) and torch.equal(ko[1], ref[1]),
              "dense window: minplus kernel not bit-equal")
    ms["kernel"] = cs._device_ms(
        lambda: cuda_minplus.minplus_scan(w_all, start4))
    ms["kernel_after_int32_conversion"] = cs._device_ms(
        lambda: cuda_minplus.minplus_scan(w_all, start4.to(torch.int32)))
    line("minplus", "dense window", "x".join(map(str, w_all.shape)), ms)
    # the ring's shape: steps a stage (one bulk copy) and stages a ring
    ring = {}
    for k, s in RINGS:
        mp_held(f"ring {k}x{s}", best, bp,
                lambda k=k, s=s: mp_run(100 + 10 * k + s, c_args))
        ring[f"kernel_{k}x{s}"] = cs._device_ms(
            lambda k=k, s=s: mp_run(100 + 10 * k + s, c_args))
        ring[f"stream_only_{k}x{s}"] = cs._device_ms(
            lambda k=k, s=s: mp_run(200 + 10 * k + s, c_args))
        ring[f"blocks_an_sm_{k}x{s}"] = load_variants.blocks_per_sm(
            w_all.shape[-1], k, s)
    print(f"ring minplus dense window (steps a stage x stages) on {card}: "
          + " | ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                       f"{k} {v}" for k, v in ring.items()), flush=True)
    # the relax step alone: the slope between windows of H and 4 H steps
    # (relax_only reads only its first slabs; the window is zeros)
    B, _, H, N, _ = w_all.shape
    w4 = torch.zeros((B, 4, 4 * H, N, N), device="cuda")
    c4, *keep4 = cuda_minplus.kernel_args(w4, start4)
    relax4 = cs._device_ms(lambda: mp_run(2, c4))
    step = (relax4 - ms["relax_only"]) / (3 * H)
    print(f"chain minplus dense window: relax_only over 4 H steps "
          f"{relax4:.4f} ms; a step {step * 1e6:.1f} ns, H steps "
          f"{step * H:.4f} ms", flush=True)
    del w4
    nw = w_all.numel() * w_all.element_size()
    nb = nw + sum(t.numel() * t.element_size() for t in ko)
    print(f"bytes minplus dense window: window {nw} B, with the outputs "
          f"{nb} B; stream_only reads the window at "
          f"{nw / ms['stream_only'] / 1e9:.3f} TB/s, the kernel moves all "
          f"at {nb / ms['kernel'] / 1e9:.3f} TB/s; bound "
          f"{nb / cs.PEAK_BYTES_S * 1e3:.4f} ms; kernel faster than "
          f"baseline: {ms['kernel'] < ms['baseline']}", flush=True)
    print("done")


if __name__ == "__main__":
    main()
