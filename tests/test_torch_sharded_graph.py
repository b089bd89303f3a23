"""PyTorch port, the compiled sharded fleet tick and the compiled dense
window on the CPU: what ``make_sharded_tick`` and
``pathgen.plan_window_dense`` run on the card with the kernels, one CUDA
graph per input signature (``ops/cuda_graph.py``), the sharded tick's
collectives inside the graph (NCCL) or between its captured stages
(gloo; ``scenario.compile_sharded_tick``).

(a) Capture safety: the sharded tick's kernel-routed body (on a gloo group
    of one rank in this process; the data-parallel tick and the spatial
    tick on a ``(dp=1, mp=1)`` mesh, without zones and under shared and
    per-scenario zones) and ``plan_window_dense``'s body run under
    ``test_torch_graph.HostGuard`` (no host read, no tensor built from
    Python data, no device-waiting operator).
(b) Capture and replay on the CPU stand-ins of
    ``testing_tools/graph_standins.py``, which record the gloo group's
    collectives (``c10d.allreduce_``, ``c10d.allgather_``) with the other
    operators and wait for their work on replay: two seeded batches
    through the captured world-1 data-parallel tick against the JAX
    package's ``make_sharded_tick`` on one virtual device (exact fields
    equal, trajectories within 2 mm and 0.02 m/s, maxima printed; the
    statistics equal); on the captured spatial tick a call's outputs
    untouched by the next call and a new signature captured anew.
(c) The staged form (gloo's) against the whole-graph form: every field
    and both statistics ``torch.equal`` (the spatial tick's four stages
    here; the data-parallel tick's one on ``dist_cases``' four CPU ranks).
(d) The captured ``plan_window_dense`` against the JAX package's:
    ``best``, ``bp`` and ``vg`` exact, ``w_all`` and ``blocked`` too;
    another lattice is another signature.
(e) ``mesh.timed`` and a capture: the whole-graph form refuses it, a
    timed collective under capture raises, the staged form times its
    collectives between the replays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.parallel import (
    distributed as tdist)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    dist_cases as dc)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    graph_standins)

from test_torch_graph import HostGuard
from test_torch_tick import _compare
from torch_port_common import carry, jax_small_oval, jax_unclosed

B = 8
MESHES = {"dp": ((1,), ("dp",), None), "spatial": ((1, 1), ("dp", "mp"),
                                                   "mp")}


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    return ja, carry(ja)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A gloo group of one rank in this process, on a file store."""
    store = tmp_path_factory.mktemp("store") / "s"
    tdist.init_distributed(coordinator_address=f"file://{store}",
                           num_processes=1, process_id=0, device="cpu")
    yield
    dist.destroy_process_group()


@pytest.fixture
def stand_in():
    with graph_standins.installed() as cuda:
        yield cuda


def _mesh(kind):
    shape, names, _ = MESHES[kind]
    return tdist.DistMesh(shape, names, device="cpu")


def _zones(lat, scen, zones):
    if zones == "none":
        return None
    zb = dc.zone_case(lat, scen)
    return zb[B - 1] if zones == "shared" else zb


def _eager(lat, kind, scen=None, zones="none"):
    mesh = _mesh(kind)
    return tsc.make_sharded_tick(lat, mesh, spatial_axis=MESHES[kind][2],
                                 device="cpu",
                                 zone_block=_zones(lat, scen, zones))


def _same(got, ref, label):
    (res_g, st_g), (res_r, st_r) = got, ref
    assert res_g.keys() == res_r.keys(), label
    for k in res_r:
        assert torch.equal(res_g[k], res_r[k]), (label, k)
    for k in st_r:
        assert torch.equal(st_g[k], st_r[k]), (label, k)


# ---- (a) capture safety ----------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("zones", ["none", "shared", "per_scenario"])
def test_sharded_body_is_capture_safe(oval, group, monkeypatch, kind, zones):
    _, lat = oval
    scen = tsc.random_scenarios(lat, B, seed=0, n_objects=1, device="cpu")
    tick = _eager(lat, kind, scen, zones)
    assert not hasattr(tick, "parts")        # the CPU tick stays eager
    guard = HostGuard(monkeypatch)
    with guard.on():
        res, stats = tick(scen)
    assert all(torch.is_tensor(v) for v in res.values())
    assert set(stats) == {"fleet_min_cost", "fleet_actions"}


def test_dense_body_is_capture_safe(oval, monkeypatch):
    _, lat = oval
    scen = tsc.random_scenarios(lat, B, seed=0, n_objects=2, device="cpu")
    args = (lat, *dc.window_args(lat, scen, tsc.W_LAST_FACTORS))
    guard = HostGuard(monkeypatch)
    with guard.on():
        out = tpg.plan_window_dense(*args)
    assert out["w_all"].shape == (B, 4, lat.H_max, lat.N, lat.N)


# ---- (b) capture and replay against JAX ------------------------------------

def _jax_sharded(ja, kind):
    shape, names, spatial = MESHES[kind]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(shape),
                             names)
    return jsc.make_sharded_tick(ja, mesh, use_pallas=False,
                                 spatial_axis=spatial)


def test_captured_world1_tick_matches_jax(oval, group, stand_in):
    """One signature captured once, the whole data-parallel tick with its
    collectives in the graph; the capture's batch and a batch made after
    it, each against the JAX package's sharded tick (the spatial tick
    against it: ``test_torch_distributed``; against this one: below)."""
    ja, lat = oval
    eager = _eager(lat, "dp")
    tick = tsc.compile_sharded_tick(eager, form="graph", device="cpu")
    assert tick.form == "graph" and tick.__wrapped__ is eager
    assert cuda_graph.eager(tick) is eager
    jt = _jax_sharded(ja, "dp")
    for seed in (0, 3):
        js = jsc.random_scenarios(ja, B, seed=seed, n_objects=1)
        ts = tsc.random_scenarios(lat, B, seed=seed, n_objects=1,
                                  device="cpu")
        (res, stats), (jres, jstats) = tick(ts), jt(js)
        _compare(jres, res, f"captured sharded dp seed {seed}")
        assert float(stats["fleet_min_cost"]) == \
            float(jstats["fleet_min_cost"])
        assert int(stats["fleet_actions"]) == int(jstats["fleet_actions"])
    (graph,) = stand_in.made
    assert len(tick.graphs) == 1 and graph.replays == 2
    # the fleet statistics' two all_reduces replayed, each waited for
    assert graph.collectives == 2 * 2


def test_outputs_survive_the_next_call(oval, group, stand_in):
    """The spatial tick captured whole, its gathers in the graph: a
    call's outputs are untouched by the next call and equal the eager
    tick's; a new batch size captures anew, a repeated one replays."""
    _, lat = oval
    eager = _eager(lat, "spatial")
    tick = tsc.compile_sharded_tick(eager, form="graph", device="cpu")
    scen = tsc.random_scenarios(lat, B, seed=0, n_objects=1, device="cpu")
    res1, st1 = tick(scen)
    kept = ({k: v.clone() for k, v in res1.items()},
            {k: v.clone() for k, v in st1.items()})
    other = tsc.random_scenarios(lat, B, seed=7, n_objects=2, device="cpu")
    res2, _ = tick(other)
    assert not torch.equal(res2["trajs"], kept[0]["trajs"])
    _same((res1, st1), kept, "call 1 after call 2")
    _same((res1, st1), eager(scen), "call 1 against eager")
    small = tsc.random_scenarios(lat, 3, seed=2, n_objects=1, device="cpu")
    _same(tick(small), eager(small), "a new signature")
    assert len(tick.graphs) == 2
    assert [g.replays for g in stand_in.made] == [2, 1]
    # the two gathers and two reductions of each replay
    assert [g.collectives for g in stand_in.made] == [8, 4]


# ---- (c) the staged form against the whole graph ---------------------------

def test_staged_form_equals_whole_graph(oval, group, stand_in):
    """The spatial tick under per-scenario zones, staged (its stages A-D
    captured, the two gathers and the reductions between them) and whole;
    the data-parallel tick's one stage: ``dist_cases``' four ranks."""
    _, lat = oval
    scen = tsc.random_scenarios(lat, B, seed=4, n_objects=1, device="cpu")
    eager = _eager(lat, "spatial", scen, "per_scenario")
    whole = tsc.compile_sharded_tick(eager, form="graph", device="cpu")
    staged = tsc.compile_sharded_tick(eager, device="cpu")
    assert staged.form == "staged"           # gloo: the backend's rule
    assert set(staged.parts) == {"a", "b", "c", "d"}
    fresh = tsc.random_scenarios(lat, B, seed=5, n_objects=1, device="cpu")
    for s in (scen, fresh):
        _same(staged(s), whole(s), "staged")
    assert len(staged.graphs) == 4
    assert [g.replays for g in stand_in.made] == [2] * 5
    # inside disabled() every form runs the eager tick
    with cuda_graph.disabled():
        _same(staged(fresh), eager(fresh), "disabled")
    assert [g.replays for g in stand_in.made] == [2] * 5


def test_form_follows_the_backend(oval, group):
    """gloo's collectives cannot be captured, a mesh without a group has
    none: the default forms."""
    _, lat = oval
    assert not _mesh("dp").capturable
    alone = tdist.DistMesh.__new__(tdist.DistMesh)
    alone.distributed = False
    assert alone.capturable


# ---- (d) the captured dense window against JAX -----------------------------

def test_captured_dense_window_matches_jax(oval, stand_in):
    ja, lat = oval
    dense = cuda_graph.capture(tpg.plan_window_dense.__wrapped__, "cpu")
    for seed in (0, 3):
        scen = tsc.random_scenarios(lat, 4, seed=seed, n_objects=2,
                                    device="cpu")
        args = (lat, *dc.window_args(lat, scen, (0.1, 0.5, 0.8)))
        got = dense(*args)
        for k, v in tpg.plan_window_dense(*args).items():
            assert torch.equal(got[k], v), k
        for b in range(4):
            j = [jnp.asarray(a.numpy() if k in (3, 11) else a[b].numpy())
                 for k, a in enumerate(args[1:], start=1)]
            ref = jpg.plan_window_dense(ja, *j, n_last=4)
            for k in ("best", "bp", "vg", "w_all", "blocked", "win_layers"):
                np.testing.assert_array_equal(got[k][b].numpy(),
                                              np.asarray(ref[k]),
                                              err_msg=f"{seed} {b} {k}")
    assert len(dense.graphs) == 1
    # the lattice is an argument: another lattice, another signature
    mb = carry(jax_unclosed())
    scen = tsc.random_scenarios(mb, 4, seed=1, n_objects=1, device="cpu")
    args = (mb, *dc.window_args(mb, scen, (0.1, 0.5, 0.8)))
    for k, v in dense(*args).items():
        assert torch.equal(v, tpg.plan_window_dense(*args)[k]), k
    assert len(dense.graphs) == 2
    assert tpg.plan_window_dense.compiled == {}   # the CPU stays eager


# ---- (e) mesh.timed -------------------------------------------------------

def test_timed_mesh_and_capture(oval, group, stand_in):
    _, lat = oval
    scen = tsc.random_scenarios(lat, B, seed=0, n_objects=1, device="cpu")
    eager = _eager(lat, "dp")
    mesh = eager.mesh
    whole = tsc.compile_sharded_tick(eager, form="graph", device="cpu")
    mesh.timed = True
    try:
        with pytest.raises(RuntimeError, match="inside a CUDA graph"):
            whole(scen)
        assert whole.graphs == {}
        # the guard under the compiled tick's: a timed collective refuses
        # any capture
        raw = cuda_graph.capture(lambda x: mesh.all_reduce(
            x, dist.ReduceOp.MIN, "dp"), "cpu")
        with pytest.raises(RuntimeError, match="during a CUDA graph "
                                               "capture"):
            raw(torch.arange(3.0))
        # the staged form's collectives run between the replays: timed
        staged = tsc.compile_sharded_tick(eager, device="cpu")
        mesh.collective_s, mesh.n_collectives = 0.0, 0
        staged(scen)
        staged(scen)
        assert mesh.collective_s > 0.0 and mesh.n_collectives == 4
    finally:
        mesh.timed = False


def test_card_rule(oval, group):
    """On the CPU make_sharded_tick returns the eager tick; its stages
    and their composition are reachable for compile_sharded_tick."""
    _, lat = oval
    tick = _eager(lat, "spatial")
    assert set(tick.stages) == {"a", "b", "c", "d"}
    with pytest.raises(ValueError, match="form"):
        tsc.compile_sharded_tick(tick, form="fused", device="cpu")
