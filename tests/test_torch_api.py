"""PyTorch port, API parity with the JAX package: code written against one
package's public functions runs against the other's.

- every public module-level function that both packages define takes the
  JAX package's positional parameters first, in its order (``use_pallas``
  read as ``kernels``), but for the allow-listed tuning knobs below;
- the functions whose signatures were repaired, called as a JAX caller
  calls them, against the JAX package on the same seeded inputs (exact
  fields equal, geometry within 2 mm, velocities within 0.02 m/s; each
  test prints its measured maxima).
"""

import importlib
import inspect
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphbasedlocaltrajectoryplanner_torch as tpkg
import graphbasedlocaltrajectoryplanner_tpu as jpkg
from graphbasedlocaltrajectoryplanner_tpu.ops import projection as jproj
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_tpu.planner import velplan as jvp
from graphbasedlocaltrajectoryplanner_torch.ops import projection as tproj
from graphbasedlocaltrajectoryplanner_torch.parallel import profiling as tpf
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.parallel import spatial as tsp
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp

from torch_port_common import carry, jax_small_oval

TOL_POS, TOL_VX = 2e-3, 0.02

# JAX tuning knobs the port leaves out: they set how XLA lowers a loop or a
# select, never what it computes
KNOBS = {
    # lax.scan's unroll factor of the recurrence
    # (graphbasedlocaltrajectoryplanner_tpu/ops/velocity.py:181, 242, 277)
    ("ops.velocity", "stacked_vel_scan"): ("unroll",),
    ("ops.velocity", "stacked_vel_scan_auto"): ("unroll",),
    ("ops.velocity", "stacked_vel_scan_cgg_auto"): ("unroll",),
    # the block width of the one-hot coarse select that stands in for a
    # dynamic slice on the TPU; the port slices directly
    # (graphbasedlocaltrajectoryplanner_tpu/ops/dynshift.py:59)
    ("ops.dynshift", "select_window"): ("blk",),
}


def _modules(pkg):
    out = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = m.name[len(pkg.__name__) + 1:]
        if not rel.startswith("ops.pallas_"):     # csrc/ replaces them
            out[rel] = importlib.import_module(m.name)
    return out


def _unwrap(f):
    while hasattr(f, "__wrapped__"):
        f = f.__wrapped__
    return f


def _positional(f):
    return [p.name for p in inspect.signature(f).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _shared_functions():
    """(module, name, JAX function, port function) of every public
    function defined in a JAX module whose port module defines it too."""
    tmods = _modules(tpkg)
    out = []
    for rel, jmod in _modules(jpkg).items():
        for name, jf in vars(jmod).items():
            jf = _unwrap(jf)
            if name.startswith("_") or not inspect.isfunction(jf) \
                    or jf.__module__ != jmod.__name__:
                continue
            tf = getattr(tmods.get(rel), name, None)
            assert tf is not None, f"{rel}.{name} has no port counterpart"
            out.append((rel, name, jf, _unwrap(tf)))
    return out


def test_shared_functions_take_the_jax_positional_order():
    shared = _shared_functions()
    bad = []
    for rel, name, jf, tf in shared:
        knobs = KNOBS.get((rel, name), ())
        jp = ["kernels" if p == "use_pallas" else p for p in _positional(jf)
              if p not in knobs]
        tp = _positional(tf)
        if tp[:len(jp)] != jp:
            bad.append(f"{rel}.{name}: JAX {jp}, port {tp}")
    print(f"{len(shared)} shared public functions compared")
    assert not bad, "\n".join(bad)
    assert len(shared) >= 110


@pytest.mark.parametrize("key", sorted(KNOBS))
def test_allowed_knobs_are_jax_only(key):
    """Each allow-listed knob is still a JAX parameter the port lacks."""
    rel, name = key
    jf = _unwrap(getattr(importlib.import_module(
        f"{jpkg.__name__}.{rel}"), name))
    tf = _unwrap(getattr(importlib.import_module(
        f"{tpkg.__name__}.{rel}"), name))
    for knob in KNOBS[key]:
        assert knob in _positional(jf) and knob not in _positional(tf)


def test_package_level_graphltpl():
    from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
        GraphLTPL)
    assert tpkg.GraphLTPL is GraphLTPL
    with pytest.raises(AttributeError):
        tpkg.NoSuchName


# ---- projection -------------------------------------------------------------

def _polyline(seed, n, closed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2 * np.pi if closed else 2.5, n, endpoint=not closed)
    r = 40.0 + rng.uniform(-2.0, 2.0, n)
    line = np.stack([r * np.cos(t), 0.6 * r * np.sin(t)], axis=1)
    pos = line[rng.integers(0, n, 16)] + rng.normal(0.0, 1.5, (16, 2))
    return line.astype(np.float32), pos.astype(np.float32)


@pytest.mark.parametrize("closed", [False, True])
def test_get_s_coord_builds_s_array(closed):
    """``s_array`` omitted: the polyline's cumulative chord length."""
    line, pos = _polyline(3, 50, closed)
    s, (ia, ib) = tproj.get_s_coord(torch.from_numpy(line),
                                    torch.from_numpy(pos), closed=closed)
    d_s = 0.0
    for i in range(len(pos)):
        rs, (ra, rb) = jproj.get_s_coord(jnp.asarray(line),
                                         jnp.asarray(pos[i]), closed=closed)
        assert (int(ia[i]), int(ib[i])) == (int(ra), int(rb)), i
        d_s = max(d_s, abs(float(s[i]) - float(rs)))
    print(f"get_s_coord (closed={closed}) without s_array: max |d s| = "
          f"{d_s:.3g} m")
    assert d_s <= TOL_POS


def _padded(seed):
    """A polyline of 40 valid rows padded to 56 with rows that lie closer
    to every position than any valid one (the mask must exclude them)."""
    line, pos = _polyline(seed, 40, False)
    pad = np.repeat(pos[:1], 16, axis=0)
    full = np.concatenate([line, pad]).astype(np.float32)
    mask = np.arange(len(full)) < len(line)
    return line, full, mask, pos


def test_closest_path_index_valid_mask():
    line, full, mask, pos = _padded(5)
    idx, d2 = tproj.closest_path_index(torch.from_numpy(full),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(mask))
    for i in range(len(pos)):
        ri, rd2 = jproj.closest_path_index(jnp.asarray(full),
                                           jnp.asarray(pos[i]),
                                           jnp.asarray(mask))
        assert int(idx[i]) == int(ri) < len(line)
        np.testing.assert_array_equal(d2[i].numpy(), np.asarray(rd2))
    assert bool(torch.isinf(d2[:, ~torch.from_numpy(mask)]).all())


def test_get_s_coord_valid_mask():
    line, full, mask, pos = _padded(6)
    s_arr = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(full, axis=0), axis=1))]).astype(np.float32)
    s, (ia, ib) = tproj.get_s_coord(
        torch.from_numpy(full), torch.from_numpy(pos),
        torch.from_numpy(s_arr), False, torch.from_numpy(mask))
    d_s = 0.0
    for i in range(len(pos)):
        rs, (ra, rb) = jproj.get_s_coord(jnp.asarray(full),
                                         jnp.asarray(pos[i]),
                                         jnp.asarray(s_arr), False,
                                         jnp.asarray(mask))
        assert (int(ia[i]), int(ib[i])) == (int(ra), int(rb)), i
        d_s = max(d_s, abs(float(s[i]) - float(rs)))
    print(f"get_s_coord with valid_mask: max |d s| = {d_s:.3g} m")
    assert d_s <= TOL_POS
    assert int(ia.max()) < len(line)


# ---- the velocity stage, called positionally in JAX's order -----------------

P, M_SQP = 448, 115


def _path(seed, n):
    """A seeded curved path (P, 5) [x y psi kappa el] of ``n`` 1 m steps,
    padded as the handler pads a cut path."""
    rng = np.random.default_rng(seed)
    s = np.arange(n, dtype=np.float64)
    kappa = 0.01 + 0.008 * np.sin(s / rng.uniform(15.0, 30.0))
    psi = np.concatenate([[0.0], np.cumsum(kappa[:-1])])
    x = np.concatenate([[0.0], np.cumsum(np.cos(psi[:-1]))])
    y = np.concatenate([[0.0], np.cumsum(np.sin(psi[:-1]))])
    path = np.zeros((P, 5), np.float32)
    path[:n, 0], path[:n, 1], path[:n, 2], path[:n, 3] = x, y, psi, kappa
    path[:n - 1, 4] = 1.0
    path[n:, 0:4] = path[n - 1, 0:4]
    return path


def _opponent(seed):
    """A made-up opponent summary: stopping distance, rolling profile."""
    rng = np.random.default_rng(seed)
    roll_vel = np.full(tvp.F_CAP, rng.uniform(8.0, 10.0), np.float32)
    roll_cum = np.arange(tvp.F_CAP, dtype=np.float32)
    return np.float32(rng.uniform(6.0, 10.0)), roll_vel, roll_cum


def _cmp_traj(t, r):
    d = np.abs(t.astype(np.float64) - r.astype(np.float64))
    return float(d[..., 0:3].max()), float(d[..., 5].max())


def test_velocity_kernel_positional_sqp():
    """Every argument positional, ``vp_backend="sqp"`` in JAX's 32nd place:
    the SQP branch runs (QP status out) and matches the JAX function."""
    rows = [(_path(0, 300), 300, True, False, 30.0, 60.0, 9.0, False),
            (_path(1, 260), 260, False, False, 30.0, 0.0, 0.0, True),
            (_path(2, 200), 200, False, True, 25.0, 0.0, 0.0, False)]
    gg = np.random.default_rng(7).uniform(4.5, 5.5, (P, 2)).astype(
        np.float32)
    vc = np.zeros(P, np.float32)
    vc[:3] = [20.0, 20.2, 20.4]
    opp_stop, roll_vel, roll_cum = _opponent(1)
    x0 = (18.0 + 4.0 * np.sin(np.arange(P) / 17.0)).astype(np.float32)
    machines = np.array([[0.0, 5.0], [100.0, 5.0]], np.float32)
    tail = ("PD", 1, "sqp")
    ref = []
    for path, n, fol, red, v_end, od, vo, ot in rows:
        ref.append(jvp.velocity_kernel(
            jnp.asarray(path), jnp.int32(n), jnp.asarray(gg), jnp.asarray(vc),
            jnp.int32(3), jnp.float32(20.0), jnp.float32(20.0),
            jnp.float32(45.0), jnp.float32(0.9), jnp.float32(1.0),
            jnp.asarray(machines), jnp.float32(0.1), fol, red,
            jnp.float32(v_end), jnp.float32(od), jnp.float32(vo),
            jnp.float32(30.0), jnp.float32(opp_stop), jnp.asarray(roll_vel),
            jnp.asarray(roll_cum), jnp.float32(4.7), jnp.float32(1.25),
            jnp.float32(0.025), jnp.float32(0.2), jnp.float32(1.0), 1.0,
            0.85, 1000.0, *tail, jnp.asarray(x0), ot, jnp.float32(7.0), 2,
            jnp.float32(5.0), M_SQP, jnp.float32(2.5)))
    col = lambda k: [r[k] for r in rows]                     # noqa: E731
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)     # noqa: E731
    R = len(rows)
    out = tvp.velocity_kernel(
        torch.from_numpy(np.stack(col(0))), torch.tensor(col(1)),
        torch.from_numpy(gg)[None].expand(R, -1, -1), torch.from_numpy(vc),
        torch.tensor(3), f32(20.0), f32(20.0), f32(45.0), f32(0.9),
        f32(1.0), torch.from_numpy(machines), f32(0.1), torch.tensor(col(2)),
        torch.tensor(col(3)), f32(col(4)), f32(col(5)), f32(col(6)),
        f32(30.0), f32(opp_stop), torch.from_numpy(roll_vel),
        torch.from_numpy(roll_cum), f32(4.7), f32(1.25), f32(0.025),
        f32(0.2), f32(1.0), 1.0, 0.85, 1000.0, *tail,
        torch.from_numpy(x0)[None].expand(R, -1), torch.tensor(col(7)),
        f32(7.0), 2, f32(5.0), M_SQP, 2.5)
    assert "qp_status" in out and "vx_sqp" in out
    d_pos = d_vx = 0.0
    for r, o in enumerate(ref):
        for k in ("vel_bound", "too_close", "qp_status"):
            assert int(out[k][r]) == int(o[k]), (r, k)
        dp, dv = _cmp_traj(out["traj"][r].numpy(), np.asarray(o["traj"]))
        d_pos, d_vx = max(d_pos, dp), max(d_vx, dv)
    print(f"velocity_kernel positional sqp: status "
          f"{out['qp_status'].tolist()}; max |d s,x,y| = {d_pos:.3g} m, "
          f"max |d vx| = {d_vx:.3g} m/s")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX


def test_velocity_stage_scenario_positional_sqp():
    """Every argument positional in JAX's order, ``control_type`` in the
    27th place and ``vp_backend="sqp"`` in the 30th: the SQP branch runs
    and matches the JAX function."""
    B = 2
    paths = np.stack([np.stack([_path(4 * b + s, 240 + 20 * s)
                                for s in range(4)]) for b in range(B)])
    n_valids = np.array([[240, 260, 280, 300]] * B, np.int32)
    gg = np.tile(np.array([[9.0, 8.0]], np.float32), (P, 1))
    vc = np.zeros((B, P), np.float32)
    vc[:, :3] = [[30.0, 30.1, 30.2], [22.0, 22.1, 22.2]]
    vel_plan = np.array([30.0, 22.0], np.float32)
    v_end_rl = np.array([[30.0, 28.0, 25.0, 30.0], [26.0, 30.0, 30.0, 22.0]],
                        np.float32)
    red = np.array([[False, False, True, False], [False, True, False, False]])
    obj_dist = np.array([70.0, 35.0], np.float32)
    opp = [_opponent(10 + b) for b in range(B)]
    x0 = np.broadcast_to((15.0 + 5.0 * np.cos(np.arange(P) / 23.0)).astype(
        np.float32), (B, 4, P)).copy()
    machines = np.array([[0.0, 5.0], [100.0, 5.0]], np.float32)
    tail = ("PD", 1, 1, "sqp")
    ref = []
    for b in range(B):
        ref.append(jvp.velocity_stage_scenario(
            jnp.asarray(paths[b]), jnp.asarray(n_valids[b]), jnp.asarray(gg),
            jnp.asarray(vc[b]), jnp.int32(3), jnp.float32(vel_plan[b]),
            jnp.float32(vel_plan[b]), jnp.float32(45.0),
            jnp.asarray(machines), jnp.float32(0.1),
            jnp.asarray(v_end_rl[b]), jnp.asarray(red[b]),
            jnp.float32(obj_dist[b]), jnp.float32(9.0), jnp.float32(30.0),
            jnp.float32(opp[b][0]), jnp.asarray(opp[b][1]),
            jnp.asarray(opp[b][2]), jnp.float32(4.7), jnp.float32(1.25),
            jnp.float32(0.025), jnp.float32(0.2), jnp.float32(15.0), 1.0,
            0.85, 1000.0, *tail, jnp.asarray(x0[b]), jnp.float32(7.0), 2,
            jnp.float32(9.0), M_SQP, jnp.float32(2.5), None))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)     # noqa: E731
    out = tvp.velocity_stage_scenario(
        torch.from_numpy(paths), torch.from_numpy(n_valids).long(),
        torch.from_numpy(gg), torch.from_numpy(vc), torch.full((B,), 3),
        torch.from_numpy(vel_plan), torch.from_numpy(vel_plan), f32(45.0),
        torch.from_numpy(machines), f32(0.1), torch.from_numpy(v_end_rl),
        torch.from_numpy(red), torch.from_numpy(obj_dist),
        torch.full((B,), 9.0), f32(30.0),
        f32([o[0] for o in opp]), torch.from_numpy(np.stack(
            [o[1] for o in opp])), torch.from_numpy(np.stack(
                [o[2] for o in opp])), f32(4.7), f32(1.25), f32(0.025),
        f32(0.2), f32(15.0), 1.0, 0.85, 1000.0, *tail,
        torch.from_numpy(x0), f32(7.0), 2, f32(9.0), M_SQP, 2.5, None)
    assert "qp_status" in out and "vx_sqp" in out
    d_pos = d_vx = 0.0
    for b, o in enumerate(ref):
        for k in ("vel_bound", "too_close", "qp_status"):
            np.testing.assert_array_equal(out[k][b].numpy(),
                                          np.asarray(o[k]), err_msg=k)
        dp, dv = _cmp_traj(out["trajs"][b].numpy(), np.asarray(o["trajs"]))
        d_pos, d_vx = max(d_pos, dp), max(d_vx, dv)
    print(f"velocity_stage_scenario positional sqp: status "
          f"{out['qp_status'].tolist()}; max |d s,x,y| = {d_pos:.3g} m, "
          f"max |d vx| = {d_vx:.3g} m/s")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX


# ---- window DP, assembly, the fleet tick's entry points ---------------------

@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    lat = carry(ja)
    scen = tsc.random_scenarios(lat, 6, seed=4, n_objects=1, device="cpu")
    obs = tsc._select_obstacle(lat, scen)
    args = (lat, scen.start_layer, scen.start_node,
            torch.zeros((lat.L, lat.N), dtype=torch.bool), scen.obj_pos,
            scen.obj_radius, scen.obj_active, obs["obs_layer"],
            obs["obs_node"], obs["obs_found"], scen.last_nodes,
            torch.tensor([0.0, 0.5, 0.8]))
    return dict(ja=ja, lat=lat, scen=scen, args=args)


@pytest.mark.parametrize("fn", ["plan_window_kernel", "plan_window_dense"])
def test_plan_window_n_last(oval, fn):
    """``n_last`` in JAX's 13th place: equal to the call without it and to
    the JAX function; a value that disagrees with ``last_nodes`` raises."""
    args = oval["args"]
    n_last = args[-2].shape[-1]
    base = getattr(tpg, fn)(*args)
    got = getattr(tpg, fn)(*args, n_last)
    for k in ("best", "bp", "vg", "win_layers", "h_goal"):
        assert torch.equal(got[k], base[k]), k
    # scenario 0 for the JAX function: every argument but the zone mask and
    # the discount factors carries the batch
    j = [jnp.asarray(a.numpy() if k in (3, 11) else a[0].numpy())
         for k, a in enumerate(args[1:], start=1)]
    ref = getattr(jpg, fn)(oval["ja"], *j, n_last)
    for k in ("best", "bp", "vg", "win_layers"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    with pytest.raises(ValueError, match="n_last"):
        getattr(tpg, fn)(*args, n_last + 1)


def test_assemble_action_kernel_without_packed(oval):
    """``packed`` keyword-only and optional: the table built inside equals
    the caller's; row 0 against the JAX function called positionally."""
    lat, scen = oval["lat"], oval["scen"]
    win = tpg.plan_window_kernel(*oval["args"])
    B = scen.start_layer.shape[0]
    nodes, _ = tpg.backtrace_slot(win["best"][:, 0], win["bp"][:, 0],
                                  win["vg"][:, 0], win["h_goal"])
    psi = lat.node_psi[scen.start_layer.long(), scen.start_node.long()]
    p_max = tsc.default_p_max(lat)
    pos = (lat, win["win_layers"], nodes, win["h_goal"], psi, p_max)
    a = tpg.assemble_action_kernel(*pos)
    b = tpg.assemble_action_kernel(*pos, packed=tpg.packed_edge_table(lat))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    d_pos = 0.0
    for r in range(B):
        ref = jpg.assemble_action_kernel(
            oval["ja"], jnp.asarray(win["win_layers"][r].numpy()),
            jnp.asarray(nodes[r].numpy()), jnp.int32(win["h_goal"][r]),
            jnp.float32(psi[r]), p_max)
        assert int(a["n_valid"][r]) == int(ref["n_valid"])
        np.testing.assert_array_equal(a["node_idx"][r].numpy(),
                                      np.asarray(ref["node_idx"]))
        d = np.abs(a["path"][r].numpy()[:, 0:2].astype(np.float64)
                   - np.asarray(ref["path"])[:, 0:2])
        d_pos = max(d_pos, float(d.max()))
    print(f"assemble_action_kernel without packed, {B} rows: max |d x,y| = "
          f"{d_pos:.3g} m against JAX")
    assert d_pos <= TOL_POS


def test_fleet_entry_points_take_kernels_positionally(oval):
    """``make_batched_tick(lat, False)`` and ``stage_timings(lat, scen, 1,
    False)``: JAX's ``use_pallas`` place; ``device`` by keyword only."""
    lat, scen = oval["lat"], oval["scen"]
    a = tsc.make_batched_tick(lat, False, device="cpu")(scen)
    b = tsc.make_batched_tick(lat, device="cpu", kernels=False)(scen)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(TypeError):
        tsc.make_batched_tick(lat, False, None, None, "cpu")
    rep = tpf.stage_timings(lat, scen, 1, False, device="cpu")
    assert set(rep["stage_ms"]) == {"window", "assembly", "velocity"}
    assert tpf.stage_timings_trace(lat, scen, 1, False, device="cpu") is None


def test_spatial_dp_shard_d_must_match_the_mesh(oval):
    """``D`` in JAX's place checks the mesh's axis; ``mesh`` is
    keyword-only (the JAX function's implicit ``shard_map`` mesh)."""
    mesh = types.SimpleNamespace(shape={"mp": 2}, coords={"mp": 0})
    with pytest.raises(ValueError, match="D=3"):
        tsp.spatial_dp_shard(*oval["args"], 4, "mp", 3, mesh=mesh)
    with pytest.raises(TypeError):
        tsp.spatial_dp_shard(*oval["args"], 4, "mp", 2)
