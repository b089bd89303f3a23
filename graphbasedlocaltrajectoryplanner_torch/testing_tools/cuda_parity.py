"""On-card parity gate: every hand-written CUDA kernel against its plain
PyTorch version, and the compiled card tick against a CPU oracle — the
port's counterpart of the root ``tools/pallas_parity.py``.

    python -m graphbasedlocaltrajectoryplanner_torch.testing_tools.cuda_parity \\
        [--batch 128] [--cpu] [--out artifacts]

The tests on the CPU run only the plain versions; this gate runs the
kernels on the card, on the inputs the production entry points give them,
and writes ``<out>/CUDA_PARITY.json``.  ``bench.py`` runs it on every run,
on its lattice; alone it takes the bench's default, the oval.

Kernel gates, each ``torch.equal`` (bit-equal) to the plain version:
  * ``hit_slab`` and ``window_dp`` on ``random_scenarios(lat, batch,
    seed=11, n_objects=2)`` through ``scenario._select_obstacle`` and
    ``pathgen.window_prelude`` (its plain slab hits), the window DP against
    ``pathgen.plan_window_kernel(kernels=False)``;
  * ``vel_scan`` and ``vel_scan_cgg`` on the seeded R=16, T=447 case of
    ``pallas_parity.check_velocity`` (three-row machine table, every mode,
    +inf limits on the brake rows) through ``velocity.stacked_vel_scan_auto``
    and ``stacked_vel_scan_cgg_auto``;
  * ``backtrace`` on the seeded R=16, H+1=30, N=32 case of
    ``pallas_parity.check_backtrace`` through ``pathgen.backtrace_slot``
    (goal argmin and walk);
  * ``minplus`` on the dense window of the same scenarios
    (``pathgen.plan_window_dense``), and ``admm_vel`` on the QP rows and
    ``assemble`` on the path assembly (``ops/cuda_assemble``) of a sqp
    fleet tick at ``batch`` (``vp_backend="sqp"``, ``sqp_m=115``), which
    the JAX gate leaves out (no production path there runs a Pallas kernel
    for them).

End-to-end gates: the compiled card tick (``make_batched_tick`` on the
card) against the port's plain tick on the CPU in this process, on the
caller's lattice moved to the CPU, at batch 8, seed 42, one opponent:
``valid`` and ``n_valid`` equal, every valid trajectory within 2 mm and
0.02 m/s (fb) or 2 mm and 0.05 m/s (sqp, ``sqp_m=115``), the bars of
``pallas_parity.check_end_to_end``.  This is the gate that sees a change
in card-only precision (TF32, a reduced-precision select); a kernel held
against its plain version on one card cannot.

Without a card ``run`` raises, unless the caller asks for the CPU
(``device="cpu"``, ``--cpu``): then every wrapper takes its plain version,
each kernel gate holds the plain version against itself, and the report
says so (``vacuous``): a rehearsal of the gate's inputs, not a check.
``main`` exits 0 only if every gate holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPORT = "CUDA_PARITY.json"
KERNELS = tuple(cuda_build.KERNEL_WRAPPERS)
# the end-to-end bars of tools/pallas_parity.py: (max |d x,y| m, max |d v|
# m/s) for the fb and the sqp tick
E2E_FB = (2e-3, 2e-2)
E2E_SQP = (2e-3, 5e-2)
SQP = dict(vp_backend="sqp", sqp_m=115)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _spoil(shapes, dev):
    """On the card, leave the allocator freed blocks of the kernel outputs'
    sizes filled with a pattern that is neither a result nor zeros, so
    that an element a kernel does not write shows in the comparison."""
    if dev.type != "cuda":
        return
    for shape, dtype in shapes:
        t = torch.empty(shape, dtype=dtype, device=dev)
        t.reshape(-1).view(torch.uint8).fill_(0xA5)
        del t


def _held(name, run_kernel, plain_out, dev) -> dict:
    """One kernel gate: ``run_kernel()`` (through the kernel's wrapper, its
    launches counted) against ``plain_out``, every output ``torch.equal``;
    on the card the kernel must have launched."""
    plain_t = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    _spoil([(x.shape, x.dtype) for x in plain_t], dev)
    w = cuda_build.wrappers()[name]
    before = w.launches
    out = run_kernel()
    _sync(dev)
    launches = w.launches - before
    out_t = out if isinstance(out, tuple) else (out,)
    equal = all(x.shape == y.shape and x.dtype == y.dtype
                and torch.equal(x, y) for x, y in zip(out_t, plain_t))
    mism = sum(int((x != y).sum()) for x, y in zip(out_t, plain_t)
               if x.shape == y.shape)
    diff = max(float((x.double() - y.double()).abs().nan_to_num(
        posinf=0.0).max()) if x.numel() and x.shape == y.shape else 0.0
        for x, y in zip(out_t, plain_t))
    return dict(equal=bool(equal), mismatches=mism, max_abs_diff=diff,
                n=sum(x.numel() for x in plain_t), launches=launches,
                shapes=[list(x.shape) for x in out_t],
                ok=bool(equal and (launches > 0 or dev.type != "cuda")))


def _clone(x):
    """``x`` with every tensor in it (also in a dict) cloned."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _recorded_calls(fn, targets):
    """``fn()`` with each wrapper ``(module, name)`` of ``targets``
    recording its arguments (tensors cloned) while it runs; returns
    ``{name: [(args, kwargs), ...]}``."""
    saved, calls = [], {}
    for mod, name in targets:
        orig, calls[name] = getattr(mod, name), []

        def rec(*a, _orig=orig, _calls=calls[name], **kw):
            _calls.append((_clone(list(a)), _clone(kw)))
            return _orig(*a, **kw)
        # the wrapper counts through its module's name, which is ``rec``
        # while it is in place: the recorded run's launches stay on ``rec``
        rec.launches = 0
        saved.append((mod, name, orig))
        setattr(mod, name, rec)
    try:
        fn()
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return calls


def _outputs(res):
    """An assembly's outputs as a tuple in a fixed order."""
    return tuple(res[k] for k in ("path", "n_valid", "node_idx", "coeffs"))


def check_window_kernels(lat, batch: int, dev) -> dict:
    """``hit_slab``, ``window_dp``, ``minplus``, ``admm_vel`` and
    ``assemble`` on one seeded batch (seed 11, two opponents)."""
    from graphbasedlocaltrajectoryplanner_torch.ops import (
        cuda_admm, cuda_assemble, cuda_collision, cuda_minplus, cuda_window,
        cuda_graph, qp)
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg

    scen = sc.random_scenarios(lat, batch, seed=11, n_objects=2, device=dev)
    obs = sc._select_obstacle(lat, scen)
    pre = pg.window_prelude(lat, scen.start_layer, scen.obj_pos,
                            scen.obj_radius, scen.obj_active,
                            obs["obs_layer"], obs["obs_node"],
                            obs["obs_found"])
    rep = {}
    rep["hit_slab"] = _held("hit_slab", lambda: cuda_collision.hit_slab(
        lat.samples_xy, pre["slab_layers"], scen.obj_pos, pre["ref2"],
        pre["obj_app"]), pre["hit_slab"], dev)

    zone = torch.zeros((lat.L, lat.N), dtype=torch.bool, device=dev)
    wlf = torch.tensor(sc.W_LAST_FACTORS, dtype=torch.float32, device=dev)
    win_args = (lat, scen.start_layer, scen.start_node, zone, scen.obj_pos,
                scen.obj_radius, scen.obj_active, obs["obs_layer"],
                obs["obs_node"], obs["obs_found"], scen.last_nodes, wlf)
    ref = pg.plan_window_kernel(*win_args, kernels=False)
    rep["window_dp"] = _held("window_dp", lambda: cuda_window.fused_window_dp(
        lat.w, zone, scen.start_layer, scen.start_node, pre["slab_layers"],
        pre["hit_slab"], pre["p_obs"], pre["in_win"], obs["obs_node"],
        scen.last_nodes, wlf, closed=bool(lat.closed),
        h_max=int(lat.H_max)), (ref["best"], ref["bp"]), dev)

    # the dense window's min-plus sweep (eager: a capture would hold its
    # w_all and window samples in a graph pool)
    dense = pg.plan_window_dense.__wrapped__(*win_args, kernels=False)
    start4 = scen.start_node.long()[:, None].expand(batch, 4)
    rep["minplus"] = _held("minplus", lambda: cuda_minplus.minplus_scan(
        dense["w_all"], start4), (dense["best"], dense["bp"]), dev)

    # the QP rows and the path assembly of a sqp fleet tick (its eager
    # body: a replay passes no call through Python)
    tick = cuda_graph.eager(sc.make_batched_tick(lat, device=dev, **SQP))
    calls = _recorded_calls(lambda: tick(scen),
                            [(cuda_admm, "admm_vel"),
                             (cuda_assemble, "assemble_path")])
    for name, got in calls.items():
        if not got:
            raise RuntimeError(f"the sqp tick made no {name} call")
    (d,), kw = calls["admm_vel"][0]
    def solve(admm, **extra):
        x, r = admm(d, **kw, **extra)
        return x, r["r_prim"], r["r_dual"], r["y"]
    rep["admm_vel"] = _held(
        "admm_vel", lambda: solve(cuda_admm.admm_vel, with_y=True),
        solve(qp.admm_vel_qp), dev)
    rep["admm_vel"]["calls_in_tick"] = len(calls["admm_vel"])
    a, kw = calls["assemble_path"][0]
    rep["assemble"] = _held(
        "assemble", lambda: _outputs(cuda_assemble.assemble_path(*a, **kw)),
        _outputs(cuda_assemble.assemble_path_plain(*a, **kw)), dev)
    rep["assemble"]["calls_in_tick"] = len(calls["assemble_path"])
    return rep


def velocity_case(dev):
    """The seeded R=16, T=447 case of ``pallas_parity.check_velocity``:
    curvature, constant gg 10 m/s^2, 2.5 m steps (10 % zero), limits, start
    speeds, modes 0/1/2 in turn (+inf limits on the brake rows) and the
    three-row machine table."""
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    from graphbasedlocaltrajectoryplanner_torch.ops.cuda_velocity import (
        kernel_machines)
    rng = np.random.default_rng(5)
    R, T = 16, 447
    modes = np.resize([0, 1, 2], R)
    kappa = np.abs(rng.normal(0, 0.02, (R, T))).astype(np.float32)
    ds = np.where(rng.random((R, T)) < 0.9, 2.5, 0.0).astype(np.float32)
    vlim = np.clip(rng.normal(40, 15, (R, T)), 3, 70).astype(np.float32)
    vlim = np.where(modes[:, None] == velops.MODE_BRAKE, np.inf,
                    vlim).astype(np.float32)
    vinit = np.clip(rng.normal(30, 10, R), 1, 60).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)
    machines = kernel_machines(t(np.array(
        [[0.0, 5.0], [30.0, 4.0], [70.0, 2.0]], np.float32)))
    return dict(kappa=t(kappa), gg=t(np.full((R, T), 10.0, np.float32)),
                ds=t(ds), vlim=t(vlim), vinit=t(vinit),
                modes=t(modes.astype(np.int32)), machines=machines)


def check_velocity(dev) -> dict:
    """Both velocity-scan instances on :func:`velocity_case`."""
    from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops
    c = velocity_case(dev)
    k, g = c["kappa"], c["gg"]
    gen = (k, g, g, k, g, g, c["ds"], c["vlim"], c["vinit"], c["modes"],
           c["machines"], 1.0, 0.85, 1000.0)
    cgg = (k, k, c["ds"], c["vlim"], c["vinit"], c["modes"], c["machines"],
           1.0, 0.85, 1000.0, 10.0, 10.0)
    return dict(
        vel_scan=_held("vel_scan", lambda: velops.stacked_vel_scan_auto(
            *gen), velops.stacked_vel_scan_auto(*gen, kernels=False), dev),
        vel_scan_cgg=_held("vel_scan_cgg",
                           lambda: velops.stacked_vel_scan_cgg_auto(*cgg),
                           velops.stacked_vel_scan_cgg_auto(
                               *cgg, kernels=False), dev))


def check_backtrace(dev) -> dict:
    """Goal argmin and walk on the seeded case of
    ``pallas_parity.check_backtrace`` (R=16 rows, H+1=30 layers, N=32)."""
    from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
    rng = np.random.default_rng(7)
    R, Hp1, N = 16, 30, 32
    best = rng.uniform(0, 100, (R, Hp1, N)).astype(np.float32)
    bp = rng.integers(0, N, (R, Hp1, N)).astype(np.int32)
    bp[:, 0, :] = -1
    vg = rng.uniform(0, 10, (R, Hp1, N)).astype(np.float32)
    h_eff = rng.integers(1, Hp1, (R,)).astype(np.int32)
    a = [torch.as_tensor(x, device=dev) for x in (best, bp, vg, h_eff)]
    return dict(backtrace=_held(
        "backtrace", lambda: pg.backtrace_slot(*a),
        pg.backtrace_slot(*a, kernels=False), dev))


def compare_end_to_end(trajs, valid, n_valid, ref_trajs, ref_valid, ref_nv,
                       bar_dxy: float, bar_dv: float) -> dict:
    """The verdict of ``pallas_parity.check_end_to_end`` on numpy arrays:
    ``valid`` and ``n_valid`` equal, and over every slot the oracle holds
    valid, its first ``n_valid`` points, the largest |d x|, |d y| (columns
    1-2) and |d v| (column 5), in the arrays' own float32."""
    trajs, ref_trajs = np.asarray(trajs), np.asarray(ref_trajs)
    ref_valid, ref_nv = np.asarray(ref_valid), np.asarray(ref_nv)
    valid_equal = bool(np.array_equal(np.asarray(valid), ref_valid))
    nv_equal = bool(np.array_equal(np.asarray(n_valid), ref_nv))
    rows = np.arange(ref_trajs.shape[2])
    mask = ref_valid[..., None] & (rows < ref_nv[..., None])    # (B, S, P)
    d = np.abs(trajs - ref_trajs)
    dxy = float(d[..., 1:3][mask].max()) if mask.any() else 0.0
    dv = float(d[..., 5][mask].max()) if mask.any() else 0.0
    return dict(max_dxy_m=dxy, max_dv_mps=dv, valid_sets_equal=valid_equal,
                n_valid_equal=nv_equal, bar_dxy=bar_dxy, bar_dv=bar_dv,
                ok=bool(valid_equal and nv_equal and dxy <= bar_dxy
                        and dv <= bar_dv))


def check_end_to_end(lat, dev, tick_kw=None, bars=E2E_FB,
                     batch: int = 8) -> dict:
    """The tick on ``dev`` (compiled on the card) against the plain tick on
    the CPU, on ``lat`` moved there, at ``batch`` scenarios of seed 42 with
    one opponent (:func:`compare_end_to_end`)."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    tick_kw = tick_kw or {}
    lat_cpu = lat.to("cpu")
    ref = sc.make_batched_tick(lat_cpu, device="cpu", **tick_kw)(
        sc.random_scenarios(lat_cpu, batch, seed=42, n_objects=1,
                            device="cpu"))
    out = sc.make_batched_tick(lat, device=dev, **tick_kw)(
        sc.random_scenarios(lat, batch, seed=42, n_objects=1, device=dev))
    _sync(dev)
    rep = compare_end_to_end(
        out["trajs"].cpu().numpy(), out["valid"].cpu().numpy(),
        out["n_valid"].cpu().numpy(), ref["trajs"].numpy(),
        ref["valid"].numpy(), ref["n_valid"].numpy(), *bars)
    rep["oracle"] = "the port's plain tick on the CPU, in process"
    rep["tick"] = ("compiled (one CUDA graph) with the kernels"
                   if dev.type == "cuda" else "the plain tick on the CPU")
    return rep


def run(batch: int = 128, lat=None, device=None, out: str = None) -> dict:
    """Run every gate; returns the report, also written to ``out`` (default
    ``artifacts/CUDA_PARITY.json``).  ``lat`` defaults to the bench's
    lattice of the oval; without a card this raises unless ``device`` is
    ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cuda_build.build_all()
    if lat is None:
        from graphbasedlocaltrajectoryplanner_torch import bench
        lat = bench.lattice("oval", os.path.join(ROOT, "artifacts"))
    lat = lat.to(dev)
    report = dict(device=str(dev), batch=batch, vacuous=dev.type != "cuda")
    kernels = {}
    with torch.no_grad():
        kernels.update(check_window_kernels(lat, batch, dev))
        kernels.update(check_velocity(dev))
        kernels.update(check_backtrace(dev))
        report["kernels"] = {k: kernels[k] for k in KERNELS}
        report["end_to_end"] = check_end_to_end(lat, dev)
        report["end_to_end_sqp"] = check_end_to_end(lat, dev, SQP, E2E_SQP)
    report["kernels_ok"] = all(g["ok"] for g in report["kernels"].values())
    report["ok"] = bool(report["kernels_ok"] and report["end_to_end"]["ok"]
                        and report["end_to_end_sqp"]["ok"])
    out = out or os.path.join(ROOT, "artifacts", REPORT)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)
    from graphbasedlocaltrajectoryplanner_torch import bench
    dev = resolve_device("cpu" if args.cpu else None)
    report = run(batch=args.batch, lat=bench.lattice("oval", args.out),
                 device=dev, out=os.path.join(args.out, REPORT))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
