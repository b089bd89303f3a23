"""Cases of the multi-device paths, run by every rank of a group of four.

    python -m \\
        graphbasedlocaltrajectoryplanner_torch.testing_tools.dist_cases \\
        --out DIR [--cpu] [--size small|chip] [--backend gloo|nccl] \\
        [--launch]

Started in four processes by :func:`run` (``distributed.launch_ranks``;
``--launch`` on the command line does that here, then :func:`check`),
each rank:

  a. runs ``make_sharded_tick`` on a ``("dp",)`` mesh of 4 over a seeded
     oval batch with one opponent each;
  b. runs the composed tick on a ``(dp=2, mp=2)`` mesh (``spatial_axis=
     "mp"``), and with ``small`` also under per-scenario zones;
  c. runs ``spatial_window_dp`` on an ``("mp",)`` mesh of 4 over seeded
     scenarios of each lattice (:func:`spatial_inputs`), and with
     ``chip`` the sharded tick with ``spatial_axis="mp"`` on that mesh
     over as many unclosed-Monteblanco scenarios (``c_tick``: every rank
     holds the whole batch);
  d. (``small`` only) ``run_multihost_selftest`` on a ``(dcn=2, dp=2)``
     mesh.

The ticks of a, b and ``c_tick`` are compiled (:func:`tick_case`): on the
card by ``make_sharded_tick`` itself, one CUDA graph per signature under
NCCL, captured stages with the collectives between them under gloo; on
the CPU ranks of ``small`` those of a and b in the staged form on the
stand-ins of ``graph_standins``.  Each rank holds its compiled tick
against its eager tick, ``torch.equal``.  Rank 0 writes the gathered
results of a, b and d and every rank its tables of c to ``DIR``
(``.npz``); each rank prints one JSON line: its fleet statistics, its
kernels' launches per case (counted from 0 just before the eager kernel
run), the compiled tick's form and capture, on the card the kernel run
against the plain run on the same rank, and with ``--size chip`` the ms
of a tick a rank, eager and compiled, and the share of each in
collectives.  ``small`` is the CPU tests' size (the small oval, L=45,
N=24, H=20); ``chip`` the card's: the default oval at B=1024 and 64
unclosed-Monteblanco scenarios, where rank 0 also records the spatial
path's ``hit_slab`` and ``minplus`` calls
(``rec_spatial.pt``).  :func:`tick_case`, :func:`window_args` and
:func:`spatial_run` also make the parts of ``entry.dryrun_multidevice``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
from graphbasedlocaltrajectoryplanner_torch.models import track as tt
from graphbasedlocaltrajectoryplanner_torch.ops import (
    cuda_build, cuda_collision, cuda_graph, cuda_minplus)
from graphbasedlocaltrajectoryplanner_torch.ops.search import FEAS_THRESH
from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
from graphbasedlocaltrajectoryplanner_torch.parallel import spatial
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    graph_standins)
from graphbasedlocaltrajectoryplanner_torch.utils.config import OfflineConfig

UNCLOSED_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "parity", "fixtures",
    "traj_ltpl_unclosed_monteblanco.csv")
SIZES = {
    # the CPU tests: the small oval of __graft_entry__._small_lattice
    "small": dict(oval=(dict(n=200, r=50.0, straight=150.0),
                        dict(min_plan_horizon=200.0)),
                  batch_dp=16, batch_composed=8, spatial=("oval", "mb"),
                  n_spatial=4, selftest=True),
    # the card: bench.py's shape (default oval, 1 opponent, B=1024)
    "chip": dict(oval=(dict(), dict()), batch_dp=1024, batch_composed=1024,
                 spatial=("mb",), n_spatial=64, selftest=False),
}
SEED_DP, SEED_COMPOSED, SEED_SPATIAL = 0, 1, 3
# exact fields of the tick (the rest: trajectories, within the bar)
EXACT = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel", "em_base")
# the kernels each case launches on the card (b and c_tick: the spatial
# window DP in place of the window-DP kernel)
# every tick: the glue kernels and the projections (scenario_tick)
_GLUE = ("vel_stage_level", "vel_stage_epilogue", "projection")
CASE_KERNELS = {
    "a": ("hit_slab", "window_dp", "backtrace", "vel_scan_cgg", "vel_scan",
          "assemble", "prefix_sum") + _GLUE,
    "b": ("hit_slab", "backtrace", "vel_scan_cgg", "vel_scan", "minplus",
          "assemble", "prefix_sum") + _GLUE,
    "c": ("hit_slab", "minplus"),
    "c_tick": ("hit_slab", "backtrace", "vel_scan_cgg", "vel_scan",
               "minplus", "assemble", "prefix_sum") + _GLUE,
}


def lattices(size: str, device) -> dict:
    """The lattices of a size: ``oval`` and the unclosed Monteblanco
    ``mb``, built by the port's ``build_lattice`` on ``device``."""
    track_kw, cfg_kw = SIZES[size]["oval"]
    oval = tl.build_lattice(tt.make_oval_track(**track_kw),
                            OfflineConfig(**cfg_kw), md5_params="oval")
    mb = tl.build_lattice(tt.import_globtraj_csv(UNCLOSED_CSV),
                          OfflineConfig(), md5_params="open")
    return dict(oval=oval.to(device), mb=mb.to(device))


def spatial_inputs(lat, n: int, seed: int, device):
    """Seeded window-DP inputs of ``n`` scenarios (``n`` even), the
    arguments of ``pathgen.plan_window_kernel`` after ``lat``: the first
    half with one opponent, the second without; on an open track the last
    scenario starts where its window runs into the track end."""
    half = n // 2
    s1 = sc.random_scenarios(lat, half, seed=seed, n_objects=1,
                             device=device)
    s0 = sc.random_scenarios(lat, n - half, seed=seed + 1, n_objects=0,
                             device=device)
    scen = sc.Scenario(**{f.name: torch.cat([getattr(s1, f.name),
                                             getattr(s0, f.name)])
                          for f in dataclasses.fields(sc.Scenario)})
    if not lat.closed:
        end = lat.L - max(4, lat.H_max // 3)
        scen.start_layer[-1] = end
        scen.start_node[-1] = lat.rl_idx[end]
        scen.last_nodes[-1] = -1
    return window_args(lat, scen, (0.0, 0.5, 0.8))


def window_args(lat, scen, w_last_factors):
    """The arguments of ``pathgen.plan_window_kernel`` after ``lat`` for
    the scenarios ``scen``: their obstacles, no zone, the given
    last-action weights."""
    obs = sc._select_obstacle(lat, scen)
    zone = torch.zeros((lat.L, lat.N), dtype=torch.bool, device=lat.device)
    wlf = torch.tensor(w_last_factors, dtype=torch.float32,
                       device=lat.device)
    return (scen.start_layer, scen.start_node, zone, scen.obj_pos,
            scen.obj_radius, scen.obj_active, obs["obs_layer"],
            obs["obs_node"], obs["obs_found"], scen.last_nodes, wlf)


def chains(best, bp, vg, h_goal, kernels=False):
    """Node chains and costs of every slot at three horizons (1, half of
    ``h_goal``, ``h_goal``): ``{h: (nodes (B*4, H+1), cost (B*4,))}``."""
    B, S, Hp1, N = best.shape
    out = {}
    for name, h in (("1", torch.ones_like(h_goal)),
                    ("half", torch.clamp(h_goal // 2, min=1)),
                    ("goal", h_goal)):
        h_eff = h.long()[:, None].expand(B, S).reshape(-1)
        out[name] = pg.backtrace_slot(
            best.reshape(B * S, Hp1, N), bp.reshape(B * S, Hp1, N),
            vg.reshape(B * S, Hp1, N), h_eff, kernels=kernels)
    return out


def check_spatial_against_scan(lat, args, out, kernels=False) -> dict:
    """The spatial tables ``out`` against ``plan_window_kernel`` on the
    same inputs: the window layers and the feasibility pattern equal, the
    node chains equal wherever the scan's chain is feasible, and ``best``
    within the float re-association of min-plus composition (rtol 1e-4,
    atol 1e-3 on feasible entries).  Raises on a difference; returns the
    maxima."""
    ref = pg.plan_window_kernel(lat, *args, kernels=kernels)
    rb, ob = ref["best"].double(), out["best"].double()
    feas = rb < FEAS_THRESH
    if not torch.equal(feas, ob < FEAS_THRESH):
        raise AssertionError("spatial: feasibility pattern differs")
    for k in ("win_layers", "h_goal", "vg"):
        if not torch.equal(ref[k], out[k]):
            raise AssertionError(f"spatial: {k} differs")
    d = (ob - rb).abs()[feas]
    rel = (d / rb.abs()[feas].clamp(min=1e-30)).max().item() if d.numel() \
        else 0.0
    if not bool((d <= 1e-3 + 1e-4 * rb.abs()[feas]).all()):
        raise AssertionError(f"spatial: best deviates by {d.max().item()}")
    c_ref = chains(ref["best"], ref["bp"], ref["vg"], ref["h_goal"], kernels)
    c_out = chains(out["best"], out["bp"], out["vg"], out["h_goal"], kernels)
    n_cmp, d_cost = 0, 0.0
    for h in c_ref:
        (n_r, k_r), (n_o, k_o) = c_ref[h], c_out[h]
        ok = k_r < FEAS_THRESH
        if not torch.equal(k_o < FEAS_THRESH, ok):
            raise AssertionError(f"spatial: chain feasibility differs at {h}")
        if not torch.equal(n_r[ok], n_o[ok]):
            raise AssertionError(f"spatial: node chains differ at {h}")
        n_cmp += int(ok.sum())
        if ok.any():
            d_cost = max(d_cost, float((k_o[ok].double()
                                        - k_r[ok].double()).abs().max()))
    return dict(max_abs_best=float(d.max()) if d.numel() else 0.0,
                max_rel_best=rel, chains=n_cmp, max_abs_cost=d_cost,
                bp_equal=bool(torch.equal(ref["bp"], out["bp"])))


def _held(res_k, res_p, what):
    """A kernel run against the plain run on the same rank: exact fields
    equal, trajectories within 2 mm and 0.02 m/s."""
    for k in EXACT:
        if not torch.equal(res_k[k], res_p[k]):
            raise AssertionError(f"{what}: {k} differs kernels vs plain")
    d = (res_k["trajs"].double() - res_p["trajs"].double()).abs()
    d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
    if not (d_pos <= 2e-3 and d_vx <= 0.02):
        raise AssertionError(f"{what}: kernels vs plain {d_pos} m {d_vx} m/s")
    return d_pos, d_vx


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timing(fn, dev, reps):
    """Median ms of a tick a rank (every rank starts each tick together)."""
    ms = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    dist.barrier()
    return float(np.median(ms))


def _same(got, ref, what):
    """A compiled tick's ``(results, stats)`` against the eager tick's:
    every field and both statistics ``torch.equal``."""
    for part_g, part_r in zip(got, ref):
        if part_g.keys() != part_r.keys():
            raise AssertionError(f"{what}: fields {sorted(part_g)}")
        for k in part_r:
            if not torch.equal(part_g[k], part_r[k]):
                raise AssertionError(f"{what}: {k} differs from the eager "
                                     "tick's")


def zone_case(lat, scen):
    """Per-scenario zones (B, L, N): the second half of the batch has the
    left half of the layer 4 ahead of its start blocked (as the JAX
    package's composed-mesh zone test)."""
    B = scen.start_layer.shape[0]
    zb = torch.zeros((B, lat.L, lat.N), dtype=torch.bool, device=lat.device)
    for b in range(B // 2, B):
        lay = (int(scen.start_layer[b]) + 4) % lat.L
        zb[b, lay, :lat.N // 2] = True
    return zb


def tick_case(tag, mesh, lat, batch, seed, spatial_axis, dev, *,
              out_dir=None, timed=False, zones=False, standins=False):
    """The sharded tick on this rank's slice of a seeded batch with one
    opponent each, gathered (with ``zones``, under :func:`zone_case`'s
    per-scenario zones).  The tick is ``make_sharded_tick``'s: compiled on
    the card (its ``form``: ``"graph"`` under NCCL, ``"staged"`` under
    gloo), eager on the CPU, where ``standins`` compiles it on the CPU
    stand-ins that the caller installed (``graph_standins.installed``).
    Launches are counted on the eager body (a replay runs no Python); a
    compiled tick is held against it on its first call (the capture) and
    on a replay, every field and both statistics ``torch.equal``.  On the
    card the kernel run is held against the plain run on the same slice
    (:func:`_held`, the statistics equal); ``timed`` adds the ms of a tick
    a rank (``ms``, the compiled tick's where there is one; ``eager_ms``)
    and each one's share in collectives (``distributed.collective_share``:
    on the host clock where they run eagerly, from a profiled replay where
    a graph holds them); with ``out_dir`` rank 0 writes the gathered
    results to ``<tag>.npz``.  Returns the report: statistics, launches,
    local and gathered batch, the compiled tick's form and capture."""
    scen = sc.random_scenarios(lat, batch, seed=seed, n_objects=1,
                               device=dev)
    local = distributed.shard_scenarios(scen, mesh, spatial_axis)
    zb = zone_case(lat, scen) if zones else None
    tick = sc.make_sharded_tick(lat, mesh, spatial_axis=spatial_axis,
                                device=dev, zone_block=zb)
    eager = cuda_graph.eager(tick)
    if standins and tick is eager:
        tick = sc.compile_sharded_tick(eager, device=dev)
    (res, stats), launches = cuda_build.counted(lambda: eager(local), dev)
    rep = dict(stats={k: float(v) for k, v in stats.items()},
               launches=launches, local_batch=int(local.start_layer.shape[0]))
    if tick is not eager:
        for call in ("capture", "replay"):
            _same(tick(local), (res, stats), f"{tag} compiled {call}")
        graphs = list(tick.graphs.values())
        rep["compiled"] = dict(
            form=tick.form, equal=True, signatures=len(graphs),
            warmup_ms=sum(c.warmup_ms for c in graphs),
            capture_ms=sum(c.capture_ms for c in graphs),
            pool_mib=sum(c.pool_bytes for c in graphs) / 2 ** 20)
    if dev.type == "cuda":
        tick_p = sc.make_sharded_tick(lat, mesh, spatial_axis=spatial_axis,
                                      device=dev, kernels=False,
                                      zone_block=zb)
        res_p, stats_p = tick_p(local)
        rep["kernels_vs_plain"] = _held(res, res_p, tag)
        if {k: float(v) for k, v in stats_p.items()} != rep["stats"]:
            raise AssertionError(f"{tag}: stats differ kernels vs plain")
    if timed:
        rep["eager_ms"] = _timing(lambda: eager(local), dev, 5)
        rep["eager_collective_share"] = distributed.collective_share(
            eager, (local,), rep["eager_ms"])["share"]
        rep["ms"] = _timing(lambda: tick(local), dev, 5)
        share = distributed.collective_share(tick, (local,), rep["ms"])
        rep["collective_share"] = share["share"]
        rep["collective_share_how"] = share["how"]
        rep["nccl_kernels"] = share.get("nccl_kernels")
    g = distributed.gather_results(
        {k: res[k] for k in EXACT + ("trajs",)}, mesh, spatial_axis)
    rep["batch"] = int(g["trajs"].shape[0])
    if out_dir is not None and mesh.rank == 0:
        np.savez(os.path.join(out_dir, f"{tag}.npz"),
                 **{k: v.cpu().numpy() for k, v in g.items()})
    return rep


def spatial_run(tag, mesh, lat, args, dev):
    """``spatial_window_dp`` of ``args`` over the ``mp`` axis of ``mesh``,
    its launches counted; on the card held against the plain run on the
    same inputs (every table equal).  Returns ``(tables, report)``."""
    out, launches = cuda_build.counted(
        lambda: spatial.spatial_window_dp(lat, mesh, *args), dev)
    if dev.type == "cuda":
        out_p = spatial.spatial_window_dp(lat, mesh, *args, kernels=False)
        for k in out:
            if not torch.equal(out[k], out_p[k]):
                raise AssertionError(f"{tag}: {k} differs kernels vs plain")
    return out, dict(launches=launches)


class _Record:
    """Records the calls of the spatial path's two kernels (arguments
    copied to the host)."""

    def __init__(self):
        self.targets = [(cuda_collision, "hit_slab"),
                        (cuda_minplus, "minplus_scan")]
        self.calls = {name: [] for _, name in self.targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)

            def rec(*a, _o=orig, _n=name, **kw):
                self.calls[_n].append(([x.cpu() for x in a], kw))
                return _o(*a, **kw)
            rec.launches = 0
            self.saved.append((mod, name, orig, rec))
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, orig, rec in self.saved:
            setattr(mod, name, orig)
        return False


def spatial_case(mesh, lats, size, out_dir, dev):
    """Case c: ``spatial_window_dp`` over the ``mp`` axis of 4."""
    rep = {}
    for name in SIZES[size]["spatial"]:
        lat = lats[name]
        args = spatial_inputs(lat, SIZES[size]["n_spatial"], SEED_SPATIAL,
                              dev)
        out, r = spatial_run(f"spatial {name}", mesh, lat, args, dev)
        if size == "chip":
            def window():
                return spatial.spatial_window_dp(lat, mesh, *args)
            window.mesh = mesh
            r["ms"] = _timing(window, dev, 5)
            r["collective_share"] = distributed.collective_share(
                window)["share"]
            if mesh.rank == 0:
                with _Record() as rec:
                    spatial.spatial_window_dp(lat, mesh, *args)
                torch.save(rec.calls, os.path.join(out_dir,
                                                   "rec_spatial.pt"))
            else:
                spatial.spatial_window_dp(lat, mesh, *args)
        np.savez(os.path.join(out_dir, f"c_{name}_rank{mesh.rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in out.items()})
        rep[name] = r
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", choices=sorted(SIZES), default="small")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--launch", action="store_true",
                    help="start the four ranks here, then check them")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.launch:
        return launch(args)
    if args.cpu:
        torch.set_num_threads(2)
    rank, world = distributed.init_distributed(
        backend=args.backend, device="cpu" if args.cpu else None)
    if world != 4:
        raise SystemExit(f"dist_cases needs 4 ranks, has {world}")
    dev = distributed.local_device()
    size = SIZES[args.size]
    lats = lattices(args.size, dev)
    rep = dict(rank=rank, world=world, device=str(dev),
               backend=dist.get_backend())
    t0 = time.perf_counter()
    # the CPU ranks compile their ticks on the stand-ins
    standins = dev.type == "cpu" and args.size == "small"
    with (graph_standins.installed() if standins
          else contextlib.nullcontext()):
        _cases(rep, args, size, lats, dev, standins)
    rep["seconds"] = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(rep))


def _cases(rep, args, size, lats, dev, standins):
    """The cases a-d of the module docstring into ``rep``."""
    mesh = distributed.DistMesh((4,), ("dp",))
    timed = args.size == "chip"
    rep["a"] = tick_case("a", mesh, lats["oval"], size["batch_dp"], SEED_DP,
                         None, dev, out_dir=args.out, timed=timed,
                         standins=standins)
    mesh = distributed.DistMesh((2, 2), ("dp", "mp"))
    rep["b"] = tick_case("b", mesh, lats["oval"], size["batch_composed"],
                         SEED_COMPOSED, "mp", dev, out_dir=args.out,
                         timed=timed, standins=standins)
    if args.size == "small":
        rep["b_zones"] = tick_case("b_zones", mesh, lats["oval"],
                                   size["batch_composed"], SEED_COMPOSED,
                                   "mp", dev, out_dir=args.out, zones=True)
    mesh = distributed.DistMesh((4,), ("mp",))
    rep["c"] = spatial_case(mesh, lats, args.size, args.out, dev)
    if args.size == "chip":
        rep["c_tick"] = tick_case("c_tick", mesh, lats["mb"],
                                  size["n_spatial"], SEED_SPATIAL, "mp", dev,
                                  timed=timed)
    if size["selftest"]:
        os.environ["GLTPL_LOCAL_WORLD_SIZE"] = "2"
        d = distributed.run_multihost_selftest(batch_per_device=4, iters=1,
                                               return_results=True)
        if rep["rank"] == 0:
            np.savez(os.path.join(args.out, "d.npz"),
                     **{k: np.asarray(d.pop(k))
                        for k in ("cost", "valid", "traj_sum")})
        else:
            for k in ("cost", "valid", "traj_sum"):
                d.pop(k)
        rep["d"] = d


def run(out_dir, size="small", cpu=True, backend=None,
        timeout_s=300.0) -> list:
    """Four ranks of :func:`main`, each a fresh interpreter: their JSON
    reports in rank order (raises if a rank fails or times out)."""
    os.makedirs(out_dir, exist_ok=True)
    argv = ["-m", "graphbasedlocaltrajectoryplanner_torch.testing_tools."
            "dist_cases", "--out", str(out_dir), "--size", size]
    if cpu:
        argv.append("--cpu")
    if backend:
        argv += ["--backend", backend]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    outs = distributed.launch_ranks(argv, 4, timeout_s, cwd=root)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def _unsharded(lat, batch, seed, zones=False):
    scen = sc.random_scenarios(lat, batch, seed=seed, n_objects=1,
                               device=lat.device)
    return sc.make_batched_tick(lat, device=lat.device, zone_block=zone_case(
        lat, scen) if zones else None)(scen)


def _traj_dev(got, ref):
    d = np.abs(got.astype(np.float64) - ref.double().cpu().numpy())
    return float(d[..., 0:3].max()), float(d[..., 5].max())


def check(out_dir, reports, size, device) -> dict:
    """The parent's side of :func:`run`: every rank's statistics equal,
    on the card every kernel of each case launched on every rank; the
    gathered results of a against the unsharded tick on ``device`` (exact
    fields equal, trajectories within 2 mm and 0.02 m/s, the statistics
    equal to the host's reduction), those of b the same with ``cost``
    within rtol 1e-4 (the spatial DP re-associates), c's tables equal on
    every rank and :func:`check_spatial_against_scan`.  Raises on a
    difference; returns the maxima."""
    lats = lattices(size, device)
    cases = [c for c in ("a", "b", "b_zones") if c in reports[0]]
    for case in cases + ["c_tick"] * ("c_tick" in reports[0]):
        if any(r[case]["stats"] != reports[0][case]["stats"]
               for r in reports):
            raise AssertionError(f"{case}: ranks disagree on the stats")
        if any(r[case].get("compiled", {}).get("equal") is False
               for r in reports):
            raise AssertionError(f"{case}: a compiled tick differs")
    if device.type == "cuda":
        for r in reports:
            for case, need in CASE_KERNELS.items():
                if case not in r:
                    continue
                cnt = (r[case] if case != "c" else r["c"][
                    SIZES[size]["spatial"][0]])["launches"]
                if not all(cnt[k] > 0 for k in need) or (
                        case != "a" and cnt["window_dp"]):
                    raise AssertionError(f"{case} rank {r['rank']}: "
                                         f"launches {cnt}")
    out = {}
    for case in cases:
        ref = _unsharded(lats["oval"], SIZES[size]["batch_dp" if case == "a"
                                                   else "batch_composed"],
                         SEED_DP if case == "a" else SEED_COMPOSED,
                         zones=case == "b_zones")
        got = np.load(os.path.join(out_dir, f"{case}.npz"))
        for k in EXACT:
            if (k != "cost" or case == "a") and not np.array_equal(
                    got[k], ref[k].cpu().numpy()):
                raise AssertionError(f"{case}: {k} differs from the "
                                     "unsharded tick")
        rc, v = ref["cost"].cpu().numpy(), ref["valid"].cpu().numpy()
        d_cost = float(np.abs(got["cost"] - rc)[v].max())
        if not np.allclose(got["cost"][v], rc[v], rtol=1e-4, atol=0):
            raise AssertionError(f"{case}: cost deviates by {d_cost}")
        d_pos, d_vx = _traj_dev(got["trajs"], ref["trajs"])
        if not (d_pos <= 2e-3 and d_vx <= 0.02):
            raise AssertionError(f"{case}: trajs deviate by {d_pos} m, "
                                 f"{d_vx} m/s")
        host = (float(np.where(v, rc, np.inf).min()), int(v.sum()))
        st = reports[0][case]["stats"]
        tol = 0.0 if case == "a" else 1e-4 * abs(host[0])
        if st["fleet_actions"] != host[1] or abs(
                st["fleet_min_cost"] - host[0]) > tol:
            raise AssertionError(f"{case}: stats {st}, host {host}")
        out[case] = dict(max_abs_cost=d_cost, max_pos_m=d_pos,
                         max_vx_mps=d_vx)
    for name in SIZES[size]["spatial"]:
        tabs = [np.load(os.path.join(out_dir, f"c_{name}_rank{r}.npz"))
                for r in range(len(reports))]
        if any(not np.array_equal(tabs[0][k], t[k]) for t in tabs[1:]
               for k in tabs[0].files):
            raise AssertionError(f"c {name}: the ranks' tables differ")
        args = spatial_inputs(lats[name], SIZES[size]["n_spatial"],
                              SEED_SPATIAL, device)
        out[f"c_{name}"] = check_spatial_against_scan(
            lats[name], args, {k: torch.from_numpy(tabs[0][k]).to(device)
                               for k in tabs[0].files},
            kernels=device.type == "cuda")
    return out


def launch(args):
    """``--launch``: :func:`run` then :func:`check` on this process's
    device (the card unless ``--cpu``), one line a case (the ms of a tick
    a rank and its share in collectives where measured, the compiled
    tick's and the eager tick's) and one JSON line
    of the reports, the maxima and the cards, also written to
    ``DIR/summary.json``."""
    import subprocess
    t0 = time.perf_counter()
    reports = run(args.out, args.size, args.cpu, args.backend, args.timeout)
    secs = time.perf_counter() - t0
    dev = torch.device("cpu" if args.cpu else "cuda")
    maxima = check(args.out, reports, args.size, dev)
    cards = None if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for case in [c for c in ("a", "b", "c", "c_tick") if c in reports[0]]:
        rs = [r[case] if case != "c" else r["c"][SIZES[args.size][
            "spatial"][0]] for r in reports]
        if "ms" in rs[0]:
            eager_share = [round(100 * x["eager_collective_share"], 2)
                           for x in rs] if "compiled" in rs[0] else None
            compiled = (f"compiled ({rs[0]['compiled']['form']}; eager "
                        f"{[round(x['eager_ms'], 2) for x in rs]} ms, "
                        f"collectives {eager_share} %; "
                        f"{rs[0]['collective_share_how']}, NCCL kernels of "
                        f"a replay {rs[0]['nccl_kernels']}) "
                        if "compiled" in rs[0] else "")
            print(f"dist_cases {args.size} {case} on {reports[0]['backend']} "
                  f"({[r['device'] for r in reports]}; {cards}): {compiled}"
                  f"{max(x['ms'] for x in rs):.2f} ms a tick a rank "
                  f"{[round(x['ms'], 2) for x in rs]}, collectives "
                  f"{[round(100 * x['collective_share'], 2) for x in rs]} "
                  f"% of a tick", flush=True)
    line = dict(size=args.size, backend=reports[0]["backend"], cards=cards,
                ranks_seconds=secs, maxima=maxima, reports=reports)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(line, fh, indent=1)
    print(json.dumps(dict(line, reports=None)))


if __name__ == "__main__":
    main()
