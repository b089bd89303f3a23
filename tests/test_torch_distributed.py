"""PyTorch port, the multi-device fleet tick on ``torch.distributed``
(gloo on the CPU): ``parallel/distributed.py``, ``make_sharded_tick`` and
the layer-sharded window DP of ``parallel/spatial.py``, against the port's
unsharded tick and window DP and against the JAX package's sharded tick
and spatial DP on its virtual CPU devices; the four ranks' ticks also
compiled in the staged form on CPU stand-ins, each equal to its eager
tick.

Tolerances: the exact fields of the tick (``valid``, ``h_eff``, ``cost``,
``n_valid``, ``case_a``, ``relabel``, ``em_base``), window layers,
feasibility, backpointers against the JAX spatial DP and node chains are
compared for equality; trajectories within the bar of
``tests/test_torch_tick.py`` (2 mm for x, y, s; 0.02 m/s for vx); the
spatial DP's ``best`` against the sequential scan within the float
re-association that the JAX package's ``parallel/spatial.py`` allows
(rtol 1e-4, atol 1e-3 on feasible entries).  The composed (dp, mp) tick
re-associates the window costs, so against the unsharded tick its costs
are held within rtol 1e-4 and its other exact fields for equality.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphbasedlocaltrajectoryplanner_tpu.parallel import (
    distributed as jdist)
from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_tpu.parallel.spatial import (
    spatial_dp_shard as jax_spatial_dp_shard)
from graphbasedlocaltrajectoryplanner_torch.parallel import (
    distributed as tdist)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.parallel import spatial as tsp
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    dist_cases as dc)

from torch_port_common import carry, jax_small_oval, jax_unclosed

TRAJ_POS_M, TRAJ_VX_MPS = 2e-3, 0.02
BEST_RTOL, BEST_ATOL = 1e-4, 1e-3
COST_RTOL_COMPOSED = 1e-4


@pytest.fixture(scope="module")
def lats():
    ja, jb = jax_small_oval(), jax_unclosed()
    return dict(oval=(ja, carry(ja)), mb=(jb, carry(jb)))


@pytest.fixture
def world1(tmp_path):
    """A real gloo group of one rank on a file store."""
    tdist.init_distributed(coordinator_address=f"file://{tmp_path}/store",
                           num_processes=1, process_id=0, device="cpu")
    yield tdist.DistMesh((1,), ("dp",))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Four gloo CPU ranks running ``dist_cases`` once for the module."""
    out = tmp_path_factory.mktemp("dist_cases")
    reports = dc.run(out, "small", cpu=True, timeout_s=240.0)
    return reports, out


def _traj_dev(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d[..., 0:3].max()), float(d[..., 5].max())


def _host_stats(res):
    valid = res["valid"].numpy()
    cost = np.where(valid, res["cost"].numpy(), np.inf)
    return float(cost.min()), int(valid.sum())


# ---- in process, world 1 ---------------------------------------------------

@pytest.mark.parametrize("zones", ["none", "shared", "per_scenario",
                                   "none_sqp"])
def test_sharded_tick_world1_equals_batched(lats, world1, zones):
    _, lat = lats["oval"]
    scen = tsc.random_scenarios(lat, 8, seed=0, n_objects=1, device="cpu")
    zone, kw = None, {}
    if zones == "none_sqp":
        from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
            profile_stages)
        kw = profile_stages.sqp_options(lat)
    elif zones != "none":
        rl = lat.rl_idx.numpy()
        zb = np.zeros((8, lat.L, lat.N), bool)
        for b, sl in enumerate(scen.start_layer.numpy()):
            lay = (int(sl) + 3) % lat.L
            zb[b, lay, max(rl[lay] - 1, 0):rl[lay] + 2] = True
        zone = torch.from_numpy(zb[0] if zones == "shared" else zb)
    tick = tsc.make_sharded_tick(lat, world1, zone_block=zone, device="cpu",
                                 **kw)
    res, stats = tick(tdist.shard_scenarios(scen, world1))
    ref = tsc.make_batched_tick(lat, device="cpu", zone_block=zone,
                                **kw)(scen)
    assert res.keys() == ref.keys()
    for k in ref:
        assert torch.equal(res[k], ref[k]), k
    min_cost, n_valid = _host_stats(ref)
    assert float(stats["fleet_min_cost"]) == min_cost
    assert int(stats["fleet_actions"]) == n_valid
    assert stats["fleet_actions"].dtype == torch.int32


def test_unknown_spatial_axis_raises(lats):
    _, lat = lats["oval"]
    mesh = tdist.DistMesh((1,), ("dp",), device="cpu")
    with pytest.raises(ValueError, match="no axis 'mp'"):
        tsc.make_sharded_tick(lat, mesh, spatial_axis="mp", device="cpu")


def _pretend_rank(shape, names, rank):
    """A mesh as rank ``rank`` of ``shape`` would see it (no group)."""
    mesh = tdist.DistMesh.__new__(tdist.DistMesh)
    mesh.axis_names = tuple(names)
    mesh.shape = dict(zip(names, shape))
    mesh.coords = dict(zip(names, (int(c) for c in
                                   np.unravel_index(rank, shape))))
    mesh.rank, mesh.device, mesh.distributed = rank, torch.device("cpu"), \
        False
    return mesh


@pytest.mark.parametrize("shape,names", [((4,), ("dp",)),
                                         ((2, 2), ("dcn", "dp"))])
def test_shard_scenarios_slices_as_jax(lats, shape, names):
    ja, lat = lats["oval"]
    js = jsc.random_scenarios(ja, 8, seed=2, n_objects=1)
    ts = tsc.random_scenarios(lat, 8, seed=2, n_objects=1, device="cpu")
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shape),
                              names)
    jsh = jdist.shard_scenarios(js, jmesh)
    for rank in range(4):
        dev = jmesh.devices.reshape(-1)[rank]
        local = tdist.shard_scenarios(ts, _pretend_rank(shape, names, rank))
        for f in dataclasses.fields(jsc.Scenario):
            shard = [s.data for s in getattr(jsh, f.name).addressable_shards
                     if s.device == dev][0]
            np.testing.assert_array_equal(np.asarray(shard),
                                          getattr(local, f.name).numpy(),
                                          err_msg=f"rank {rank} {f.name}")
    with pytest.raises(ValueError, match="does not split"):
        tdist.shard_scenarios(tsc.random_scenarios(lat, 6, device="cpu"),
                              _pretend_rank(shape, names, 0))


def test_rerun_from_frontier_equals_the_direct_rerun():
    """The min-plus scan behind the step W0 (the spatial re-run's route to
    kernel 6) equals the JAX re-run written directly from the frontier,
    bit for bit, backpointers included where every predecessor is INF."""
    rng = np.random.default_rng(7)
    INF = float(tsp.INF)
    w = rng.uniform(1.0, 9.0, (3, 4, 6, 10, 10)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.5] = INF
    w[0, 1, 2] = INF                       # a step with no edge at all
    f = rng.uniform(0.0, 50.0, (3, 4, 10)).astype(np.float32)
    f[rng.uniform(size=f.shape) < 0.4] = INF
    f[2, 3] = INF                          # an unreachable frontier
    best, bp = tsp.rerun_from_frontier(torch.from_numpy(f),
                                       torch.from_numpy(w))
    cur = torch.from_numpy(f)
    for k in range(w.shape[2]):
        tot = cur[..., :, None] + torch.from_numpy(w[:, :, k])
        cur = torch.clamp(torch.amin(tot, dim=-2), max=INF)
        assert torch.equal(best[:, :, k], cur)
        assert torch.equal(bp[:, :, k], torch.argmin(tot, dim=-2).int())


# ---- four gloo CPU processes ----------------------------------------------

def test_four_ranks_agree_on_stats(four_ranks):
    reports, _ = four_ranks
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    assert all(r["backend"] == "gloo" for r in reports)
    for case in ("a", "b", "b_zones"):
        assert all(r[case]["stats"] == reports[0][case]["stats"]
                   for r in reports), case
    for key in ("fleet_min_cost", "fleet_actions", "batch",
                "global_devices"):
        assert len({r["d"][key] for r in reports}) == 1, key
    assert reports[0]["d"]["batch"] == 16
    assert [r["d"]["process_index"] for r in reports] == [0, 1, 2, 3]
    print("rank seconds", [round(r["seconds"], 2) for r in reports])


def test_four_ranks_compiled_ticks_equal_eager(four_ranks):
    """Each CPU rank compiled its dp=4 and (dp=2, mp=2) ticks in gloo's
    staged form on the CPU stand-ins (``testing_tools/graph_standins``)
    and held each against its eager tick (``dist_cases.tick_case``: every
    field and both statistics ``torch.equal`` at the capture and on a
    replay; a rank that differs fails the run)."""
    reports, _ = four_ranks
    for r in reports:
        for case, stages in (("a", 1), ("b", 4)):
            c = r[case]["compiled"]
            assert c["form"] == "staged" and c["equal"], (r["rank"], case)
            assert c["signatures"] == stages, (r["rank"], case)


def _unsharded(lat, batch, seed):
    scen = tsc.random_scenarios(lat, batch, seed=seed, n_objects=1,
                                device="cpu")
    return tsc.make_batched_tick(lat, device="cpu")(scen)


def test_four_ranks_dp_tick_equals_unsharded(lats, four_ranks):
    reports, out = four_ranks
    _, lat = lats["oval"]
    ref = _unsharded(lat, 16, dc.SEED_DP)
    got = np.load(out / "a.npz")
    for k in dc.EXACT:
        np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)
    d_pos, d_vx = _traj_dev(got["trajs"], ref["trajs"].numpy())
    print(f"dp=4 vs unsharded: max |d x,y,s| {d_pos:.3g} m, max |d vx| "
          f"{d_vx:.3g} m/s")
    assert d_pos <= TRAJ_POS_M and d_vx <= TRAJ_VX_MPS
    min_cost, n_valid = _host_stats(ref)
    assert reports[0]["a"]["stats"] == dict(fleet_min_cost=min_cost,
                                            fleet_actions=n_valid)
    assert all(r["a"]["local_batch"] == 4 for r in reports)


def test_four_ranks_composed_tick_against_unsharded(lats, four_ranks):
    reports, out = four_ranks
    _, lat = lats["oval"]
    ref = _unsharded(lat, 8, dc.SEED_COMPOSED)
    got = np.load(out / "b.npz")
    for k in dc.EXACT:
        if k != "cost":
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)
    np.testing.assert_allclose(got["cost"], ref["cost"].numpy(),
                               rtol=COST_RTOL_COMPOSED)
    d_cost = float(np.abs(got["cost"] - ref["cost"].numpy())[
        ref["valid"].numpy()].max())
    d_pos, d_vx = _traj_dev(got["trajs"], ref["trajs"].numpy())
    print(f"(dp=2, mp=2) vs unsharded: max |d cost| {d_cost:.3g}, max "
          f"|d x,y,s| {d_pos:.3g} m, max |d vx| {d_vx:.3g} m/s")
    assert d_pos <= TRAJ_POS_M and d_vx <= TRAJ_VX_MPS
    # the spatial axis replicates the results: the action count sums over
    # dp only
    min_cost, n_valid = _host_stats(ref)
    assert reports[0]["b"]["stats"]["fleet_actions"] == n_valid
    assert abs(reports[0]["b"]["stats"]["fleet_min_cost"] - min_cost) \
        <= COST_RTOL_COMPOSED * abs(min_cost)
    assert all(r["b"]["local_batch"] == 4 for r in reports)


def test_four_ranks_composed_tick_per_scenario_zones(lats, four_ranks):
    """Per-scenario zones shard with the scenarios and reach each
    scenario's spatial window DP."""
    reports, out = four_ranks
    _, lat = lats["oval"]
    scen = tsc.random_scenarios(lat, 8, seed=dc.SEED_COMPOSED, n_objects=1,
                                device="cpu")
    zb = dc.zone_case(lat, scen)
    ref = tsc.make_batched_tick(lat, device="cpu", zone_block=zb)(scen)
    free = tsc.make_batched_tick(lat, device="cpu")(scen)
    assert not torch.equal(ref["cost"][4:], free["cost"][4:])   # zones bite
    got = np.load(out / "b_zones.npz")
    for k in dc.EXACT:
        if k != "cost":
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)
    np.testing.assert_allclose(got["cost"], ref["cost"].numpy(),
                               rtol=COST_RTOL_COMPOSED)
    d_pos, d_vx = _traj_dev(got["trajs"], ref["trajs"].numpy())
    print(f"(dp=2, mp=2) per-scenario zones vs unsharded: max |d cost| "
          f"{float(np.abs(got['cost'] - ref['cost'].numpy()).max()):.3g}, "
          f"max |d x,y,s| {d_pos:.3g} m, max |d vx| {d_vx:.3g} m/s")
    assert d_pos <= TRAJ_POS_M and d_vx <= TRAJ_VX_MPS
    assert all(r["b_zones"]["stats"] == reports[0]["b_zones"]["stats"]
               for r in reports)


def _spatial_out(out, name, rank):
    z = np.load(out / f"c_{name}_rank{rank}.npz")
    return {k: torch.from_numpy(z[k]) for k in z.files}


@pytest.mark.parametrize("name", ["oval", "mb"])
def test_four_ranks_spatial_matches_scan(lats, four_ranks, name):
    _, out = four_ranks
    _, lat = lats[name]
    r0 = _spatial_out(out, name, 0)
    for rank in (1, 2, 3):        # replicated over the mp axis
        rr = _spatial_out(out, name, rank)
        assert all(torch.equal(r0[k], rr[k]) for k in r0), rank
    args = dc.spatial_inputs(lat, 4, dc.SEED_SPATIAL, "cpu")
    if name == "mb":              # the window runs into the track end
        assert int(args[0][-1]) + lat.H_max > lat.L - 1
        assert -(-lat.H_max // 4) * 4 > lat.H_max   # identity tail steps
    assert bool(args[5][:2].any()) and not bool(args[5][2:].any())
    m = dc.check_spatial_against_scan(lat, args, r0)
    print(f"spatial mp=4 {name} vs scan: {m}")
    assert m["chains"] > 0


def test_four_ranks_selftest_equals_unsharded(lats, four_ranks):
    reports, out = four_ranks
    _, lat = lats["oval"]
    ref = _unsharded(lat, 16, 0)
    got = np.load(out / "d.npz")
    np.testing.assert_array_equal(got["valid"], ref["valid"].numpy())
    np.testing.assert_array_equal(got["cost"], ref["cost"].numpy())
    ts = ref["trajs"].double().abs().sum(dim=(1, 2, 3)).numpy()
    d = float(np.abs(got["traj_sum"] - ts).max())
    print(f"selftest (dcn=2, dp=2) vs unsharded: max |d traj_sum| {d:.3g}")
    np.testing.assert_allclose(got["traj_sum"], ts, rtol=1e-6)
    min_cost, n_valid = _host_stats(ref)
    assert reports[0]["d"]["fleet_actions"] == n_valid
    assert reports[0]["d"]["fleet_min_cost"] == min_cost


def test_four_ranks_parent_check(four_ranks):
    """``dist_cases.check``, the parent's side that ``chip_smoke.py`` and
    ``dist_cases --launch`` run, passes on the same runs and reports the
    maxima found above."""
    reports, out = four_ranks
    m = dc.check(out, reports, "small", torch.device("cpu"))
    assert set(m) == {"a", "b", "b_zones", "c_oval", "c_mb"}
    assert m["a"] == dict(max_abs_cost=0.0, max_pos_m=0.0, max_vx_mps=0.0)
    assert m["c_oval"]["chains"] > 0 and m["c_mb"]["chains"] > 0
    # a rank that disagrees on the statistics fails the check
    bad = [dict(r, a=dict(r["a"], stats=dict(r["a"]["stats"],
                                             fleet_actions=-1)))
           if r["rank"] == 2 else r for r in reports]
    with pytest.raises(AssertionError, match="ranks disagree"):
        dc.check(out, bad, "small", torch.device("cpu"))


# ---- against the JAX package ----------------------------------------------

def _jax_spatial(ja, mesh, args):
    """The JAX package's spatial_dp_shard over a batch (vmapped inside its
    shard_map, as its make_sharded_tick runs it), on ``mesh``'s mp axis."""
    D = mesh.shape["mp"]
    P = jax.sharding.PartitionSpec

    def body(*a):
        return jax.vmap(lambda sl, sn, op, orad, oact, ol, on, of, ln:
                        jax_spatial_dp_shard(
                            ja, sl, sn, a[2], op, orad, oact, ol, on, of, ln,
                            a[-1], n_last=tsc.N_LAST, axis_name="mp",
                            D=D))(*a[:2], *a[3:-1])
    fn = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(),) * 11,
        out_specs={k: P() for k in ("best", "bp", "vg", "win_layers",
                                    "h_goal")}))
    return fn(*[jnp.asarray(x.numpy()) for x in args])


@pytest.mark.parametrize("name", ["oval", "mb"])
def test_spatial_against_jax(lats, four_ranks, name):
    _, out = four_ranks
    ja, lat = lats[name]
    args = dc.spatial_inputs(lat, 4, dc.SEED_SPATIAL, "cpu")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("mp",))
    jo = _jax_spatial(ja, mesh, args)
    to = _spatial_out(out, name, 0)
    for k in ("bp", "vg", "win_layers", "h_goal"):
        np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                      err_msg=k)
    jb, tb = np.asarray(jo["best"], np.float64), to["best"].numpy()
    feas = jb < float(tsp.FEAS_THRESH)
    np.testing.assert_array_equal(feas, tb < float(tsp.FEAS_THRESH))
    d = float(np.abs(tb[feas] - jb[feas]).max())
    print(f"spatial mp=4 {name} vs JAX: max |d best| {d:.3g}")
    np.testing.assert_allclose(tb[feas], jb[feas], rtol=BEST_RTOL,
                               atol=BEST_ATOL)
    jc = dc.chains(torch.from_numpy(np.array(jo["best"])),
                   torch.from_numpy(np.array(jo["bp"])),
                   torch.from_numpy(np.array(jo["vg"])),
                   torch.from_numpy(np.array(jo["h_goal"])))
    tc = dc.chains(to["best"], to["bp"], to["vg"], to["h_goal"])
    for h in jc:
        assert torch.equal(jc[h][0], tc[h][0]), h


def test_composed_tick_against_jax(lats, four_ranks):
    reports, out = four_ranks
    ja, lat = lats["oval"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("dp", "mp"))
    js = jsc.random_scenarios(ja, 8, seed=dc.SEED_COMPOSED, n_objects=1)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))
    js = jax.tree_util.tree_map(lambda x: jax.device_put(x, spec), js)
    jo, jstats = jsc.make_sharded_tick(ja, mesh, use_pallas=False,
                                       spatial_axis="mp")(js)
    got = np.load(out / "b.npz")
    for k in dc.EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(jo[k]), err_msg=k)
    d_pos, d_vx = _traj_dev(got["trajs"], np.asarray(jo["trajs"]))
    print(f"(dp=2, mp=2) vs JAX: max |d x,y,s| {d_pos:.3g} m, max |d vx| "
          f"{d_vx:.3g} m/s")
    assert d_pos <= TRAJ_POS_M and d_vx <= TRAJ_VX_MPS
    assert reports[0]["b"]["stats"] == dict(
        fleet_min_cost=float(jstats["fleet_min_cost"]),
        fleet_actions=int(jstats["fleet_actions"]))


def test_scaling_bench_prints_its_line(tmp_path):
    out = tmp_path / "scaling.json"
    run = subprocess.run(
        [sys.executable, "-m",
         "graphbasedlocaltrajectoryplanner_torch.testing_tools.scaling_bench",
         "--cpu", "--ranks", "2", "--iters", "1", "--batch-per-rank", "4",
         "--out", str(out)], capture_output=True, text=True, timeout=240,
        cwd=str(dc.UNCLOSED_CSV).rsplit("/parity/", 1)[0])
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["ranks"] == 2 and line["backend"] == "gloo"
    assert line["batch"] == 8 and line["ranks_agree"]
    assert line["fleet_actions"] > 0 and line["replans_per_sec"] > 0
    assert json.loads(out.read_text())["reports"][1]["process_index"] == 1
