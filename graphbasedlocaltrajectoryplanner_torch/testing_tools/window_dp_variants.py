"""Where does a launch of the window-DP and of the slab-hit kernel spend
its time?

    python3 -m \
        graphbasedlocaltrajectoryplanner_torch.testing_tools.window_dp_variants \
        [--sass DIR]

Run it from the root of the repository, on one NVIDIA GPU with nvcc.  It
builds ``csrc/window_dp.cu``, ``csrc/hit_slab.cu`` and
``testing_tools/window_dp_variants.cu``, then

1. checks both kernels bit-equal to their plain versions on the ragged
   seeded cases of ``chip_smoke.ragged_window_kernels``;
2. records the two kernels' calls of one fleet tick at batch 1024 in three
   mixes (default oval with 1 opponent, with 3 opponents in 16 slots,
   unclosed Monteblanco) and of facade tick 15 (oval drive with an opponent
   and a zone; batch 1, 16 slots), and makes one more slab-hit call from the
   first mix with every scenario's opponent on one layer;
3. prints, for each call, the device time of one launch
   (``chip_smoke._device_ms``: launches captured in a CUDA graph, replayed
   between two CUDA events) of the kernel and of every variant of
   ``window_dp_variants.cu``: the first designs (``baseline``), one
   intermediate step each, the window DP's relax step alone on slabs that
   lie in shared memory (``relax_only``) and its variant that keeps the
   output rows in shared memory, the slab-hit kernel at other numbers of
   entries per block and without the help for crowded layers, and both
   kernels behind the int32 conversions of their int64 index tensors.  A
   variant that writes the full output is first held bit-equal to the
   plain version, on output memory spoiled beforehand;
4. runs the window DP and ``relax_only`` once more over a window of 4 H
   steps: the difference to H steps, over 3 H, is the time of one step
   without the launch and the prologue, and H times the step of
   ``relax_only`` is the chain floor.

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

WDP_VARIANTS = ("baseline", "prefetch_old_relax", "relax_only",
                "rows_in_smem")
# slab hits: (entries a block scans, KB of a layer's samples per block)
HS_SETTINGS = ((1024, 16), (2048, 16), (256, 32), (512, 32), (1024, 32),
               (2048, 32), (2048, 72))


def build_variants(cuda_build):
    """``(wdp_variant_launch, hs_variant_launch)`` of the variants' library,
    built now."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "window_dp_variants.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "window_dp_variants.so"
    done = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(lib), src], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + done.stdout + done.stderr)
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.wdp_variant_launch.argtypes = ([I, P, P, LL] + [P] * 11 + [I] * 8
                                       + [P])
    dll.wdp_variant_launch.restype = ctypes.c_int
    dll.hs_variant_launch.argtypes = [I, I, I] + [P] * 6 + [I] * 6 + [P]
    dll.hs_variant_launch.restype = ctypes.c_int
    return dll.wdp_variant_launch, dll.hs_variant_launch


def main():
    import chip_smoke as cs
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_build, cuda_collision, cuda_window)
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
        vel_scan_variants as vv)
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    if not torch.cuda.is_available():
        raise SystemExit("window_dp_variants: no CUDA device")
    card = cs._sh(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(f"device: {card}", flush=True)
    built = cuda_build.build_all(["window_dp", "hit_slab"])
    for name, (secs, log) in built.items():
        print(f"{name}: nvcc {secs:.1f} s")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print("  ptxas:", ln.strip())
    wdp_variant, hs_variant = build_variants(cuda_build)
    if "--sass" in sys.argv:        # the kernels' machine code, to read
        out_dir = sys.argv[sys.argv.index("--sass") + 1]
        os.makedirs(out_dir, exist_ok=True)
        dump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
        for name in ("window_dp", "hit_slab"):
            with open(os.path.join(out_dir, f"{name}.sass"), "w") as fh:
                subprocess.run([dump, "-sass",
                                str(cuda_build._lib_path(name))],
                               stdout=fh, check=True)

    n_w, n_h = cs.ragged_window_kernels()
    print(f"ragged shapes: window_dp bit-equal to plain on {n_w} calls, "
          f"hit_slab on {n_h}", flush=True)

    # ---- the calls to time -------------------------------------------------
    oval = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval").to("cuda")
    mb = tl.build_lattice(
        tt.import_globtraj_csv(os.path.join(
            ROOT, "parity/fixtures/traj_ltpl_unclosed_monteblanco.csv")),
        OfflineConfig(), md5_params="mb_open").to("cuda")
    targets = {"hit_slab": (cuda_collision, "hit_slab"),
               "window_dp": (cuda_window, "fused_window_dp")}
    calls = {"hit_slab": [], "window_dp": []}
    for mix, lat, skw in (
            ("oval_1opp", oval, dict(n_objects=1)),
            ("oval_3opp_o16", oval, dict(n_objects=3, o_pad=sc.O_PAD)),
            ("unclosed_monteblanco_1opp", mb, dict(n_objects=1))):
        scen = sc.random_scenarios(lat, cs.B, seed=0, device="cuda", **skw)
        # the eager body: a graph replay passes no call through a recorder
        tick = sc.make_batched_tick(lat, device="cuda").__wrapped__
        with cs.Recorder(targets) as rec:
            tick(scen)
        torch.cuda.synchronize()
        for name in calls:
            calls[name] += [(f"fleet {mix}", a, kw)
                            for a, kw in rec.calls[name]]
    for name, recs in vv.facade_calls(cs, targets, tuple(calls)).items():
        calls[name] += [("facade tick 15", a, kw) for a, kw in recs]
    # the whole fleet on one layer: every block of that layer has work
    _, a, kw = calls["hit_slab"][0]
    one = list(a)
    one[1] = torch.stack([torch.full_like(a[1][..., 0], 29),
                          torch.full_like(a[1][..., 1], 30)], dim=-1)
    calls["hit_slab"].append(("fleet oval_1opp, all on layers 29/30",
                              tuple(one), kw))

    def as_int32(a):
        """The call as a wrapper that knew int32 only would have made it:
        every int64 index tensor converted first, a kernel each."""
        return [t.to(torch.int32) if t.dtype == torch.int64 else t for t in a]

    def line(kind, label, shape, ms):
        print(f"variants {kind} {label} [{shape}] on {card}: "
              + " | ".join(f"{k} {t:.4f} ms" for k, t in ms.items()),
              flush=True)

    # ---- window DP ----------------------------------------------------------
    for label, a, kw in calls["window_dp"]:
        ref = cuda_window.fused_window_dp_plain(*a, **kw)
        H = int(kw["h_max"])
        ms = {}
        for v, name in enumerate(WDP_VARIANTS):
            c_args, best, bp, keep = cuda_window.kernel_args(*a, **kw)

            def run(v=v, c_args=c_args):
                cuda_build.check(wdp_variant(v, *c_args, cuda_build.stream()),
                                 f"window_dp variant {v}")
            best.fill_(float("nan"))    # what a variant leaves out shows
            bp.fill_(-7)
            run()
            torch.cuda.synchronize()
            if name != "relax_only":
                cs._check(torch.equal(best, ref[0])
                          and torch.equal(bp, ref[1]),
                          f"{label}: window_dp variant {name} is not "
                          "bit-equal to the plain version")
            ms[name] = cs._device_ms(run)
        out = cuda_window.fused_window_dp(*a, **kw)
        cs._check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
                  f"{label}: window_dp kernel not bit-equal")
        ms["kernel"] = cs._device_ms(
            lambda: cuda_window.fused_window_dp(*a, **kw))
        ms["kernel_after_int32_conversions"] = cs._device_ms(
            lambda: cuda_window.fused_window_dp(*as_int32(a), **kw))
        B, O = a[4].shape[:2]
        line("window_dp", label, f"B={B} N={a[0].shape[1]} H={H} O={O}", ms)
        # the step alone: the slope between windows of H and 4 H steps
        kw4 = dict(kw, h_max=4 * H)
        c_args4, *keep4 = cuda_window.kernel_args(*a, **kw4)
        relax4 = cs._device_ms(lambda: cuda_build.check(
            wdp_variant(WDP_VARIANTS.index("relax_only"), *c_args4,
                        cuda_build.stream()), "window_dp relax_only"))
        kernel4 = cs._device_ms(
            lambda: cuda_window.fused_window_dp(*a, **kw4))
        step_relax = (relax4 - ms["relax_only"]) / (3 * H)
        step_kernel = (kernel4 - ms["kernel"]) / (3 * H)
        print(f"chain window_dp {label}: over 4 H steps relax_only "
              f"{relax4:.4f} ms, kernel {kernel4:.4f} ms; a step of "
              f"relax_only {step_relax * 1e6:.1f} ns, of the kernel "
              f"{step_kernel * 1e6:.1f} ns; chain floor (H steps of "
              f"relax_only) {step_relax * H:.4f} ms; launch and prologue of "
              f"the kernel {ms['kernel'] - step_kernel * H:.4f} ms",
              flush=True)

    # ---- slab hits ----------------------------------------------------------
    for label, a, kw in calls["hit_slab"]:
        ref = cuda_collision.hit_slab_plain(*a, **kw)
        ms = {}
        todo = [("baseline", 0, 0, 0), ("block_per_entry", 1, 0, 0)]
        todo += [(f"range_{r}_part_{k}k", 2, r, k) for r, k in HS_SETTINGS]
        todo += [(f"range_{r}_part_{k}k_no_help", 3, r, k)
                 for r, k in ((256, 32), (2048, 32))]
        for name, v, rng, kb in todo:
            c_args, out, keep = cuda_collision.kernel_args(*a, **kw)

            def run(v=v, rng=rng, kb=kb, c_args=c_args):
                cuda_build.check(
                    hs_variant(v, rng, kb * 1024, *c_args,
                               cuda_build.stream()),
                    f"hit_slab variant {v}")
            out.view(torch.uint8).fill_(0x5A)   # neither False nor True
            run()
            torch.cuda.synchronize()
            got, want = out.view(torch.uint8), ref.view(torch.uint8)
            cs._check(torch.equal(got, want),
                      f"{label}: hit_slab variant {name} is not bit-equal "
                      f"to the plain version: {int((got != want).sum())} "
                      f"bytes differ, {int((got == 0x5A).sum())} unwritten")
            ms[name] = cs._device_ms(run)
        cs._check(torch.equal(cuda_collision.hit_slab(*a, **kw), ref),
                  f"{label}: hit_slab kernel not bit-equal")
        ms["kernel"] = cs._device_ms(lambda: cuda_collision.hit_slab(*a, **kw))
        ms["kernel_after_int32_conversions"] = cs._device_ms(
            lambda: cuda_collision.hit_slab(*as_int32(a), **kw))
        B, O = a[1].shape[:2]
        L, N, _, S, _ = a[0].shape
        line("hit_slab", label, f"B={B} O={O} L={L} N={N} S={S} active "
             f"{int(a[4].sum())}", ms)
    print("done")


if __name__ == "__main__":
    main()
