"""PyTorch port, the plain versions of the backpointer walk (with and
without its slot form) and of the min-plus scan against the JAX package on
the seeded raw cases of ``testing_tools/walk_cases`` (rows around a warp;
the cases of thousands of rows run on the card, in ``chip_smoke.py``; node
counts around a warp and beyond 64, horizons of 0, 1, H and beyond,
tables from a real DP and of random nodes, tied and INF and overflowing
costs).  Exact: nodes, frontiers and backpointers equal, against
``search.backtrace``/``search.minplus_scan`` (``jax.vmap``) and against the
Pallas kernels in interpret mode, as the JAX package's own tests run them
on the CPU.  Also: the fleet tick and the facade's ``backtrace_slot`` walk
the same nodes in the slot form as behind the gather of the chosen slots'
tables that they used before."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import search as jsrch
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_backtrace import (
    make_backtrace_walk)
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_minplus import (
    minplus_scan_pallas)
from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
from graphbasedlocaltrajectoryplanner_torch.models import track as tt
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_backtrace
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_minplus
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_window
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    walk_cases as kc)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    window_cases as wc)
from graphbasedlocaltrajectoryplanner_torch.utils.config import (
    OfflineConfig)

from torch_port_common import SMALL_OVAL, SMALL_OVAL_CFG

# cases by index, made inside the test (every worker collects this file);
# on the CPU the cases of a few dozen rows (those of thousands run on the
# card, in chip_smoke.py)
WALK = [i for i, c in enumerate(kc.WALK_CASES) if c[0] <= 40]
MINPLUS = [i for i, c in enumerate(kc.MINPLUS_CASES) if c[0] <= 40]
# a subset for the JAX scan and the interpreted Pallas kernels (each shape
# compiles anew): every node count, horizon kind and table kind, the slot
# form, and the shared-memory paths (N = 80, H+1 = 40)
WALK_SMALL = [1, 3, 8, 10, 11, 15, 16]
MINPLUS_SMALL = [2, 3, 5, 6, 12]


def _selected(case):
    """The case's rows' own (R, H+1, N) tables (the slot form gathered)."""
    bp = case["bp"]
    if "slot" not in case:
        return bp
    R = len(case["goal_node"])
    return bp[np.arange(R) // (R // bp.shape[0]), case["slot"]]


def _walk_numpy(bp, goal, h_eff):
    """The walk of the docstring of ``ops/search.backtrace``, row by row."""
    R, Hp1, _ = bp.shape
    out = np.full((R, Hp1), -1, np.int32)
    for r in range(R):
        he, carry = int(h_eff[r]), int(goal[r])
        for h in range(Hp1 - 1, -1, -1):
            if h == he:
                out[r, h] = carry
            elif h < he:
                carry = int(bp[r, min(h + 1, Hp1 - 1), max(carry, 0)])
                out[r, h] = carry
    return out


def _port_walk(case):
    return cuda_backtrace.backtrace_walk(
        *[torch.from_numpy(x) for x in kc.walk_args(case)]).numpy()


@pytest.mark.parametrize("i", WALK_SMALL, ids=kc.walk_label)
def test_walk_matches_jax_and_pallas(i):
    case = kc.walk_case_at(i)
    got = _port_walk(case)
    assert got.dtype == np.int32
    bp = _selected(case)
    goal, h_eff = case["goal_node"], case["h_eff"]
    ref = jax.jit(jax.vmap(jsrch.backtrace))(
        jnp.asarray(bp), jnp.asarray(h_eff.astype(np.int32)),
        jnp.asarray(goal.astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(ref), got)
    if kc.WALK_CASES[i][4] == "dp":     # holes only in random tables
        pl = make_backtrace_walk(interpret=True)(
            jnp.asarray(bp), jnp.asarray(goal), jnp.asarray(h_eff))
        np.testing.assert_array_equal(np.asarray(pl), got)


@pytest.mark.parametrize("i", WALK, ids=kc.walk_label)
def test_walk_matches_numpy(i):
    case = kc.walk_case_at(i)
    np.testing.assert_array_equal(
        _port_walk(case),
        _walk_numpy(_selected(case), case["goal_node"], case["h_eff"]))


@pytest.mark.parametrize("i", MINPLUS_SMALL, ids=kc.minplus_label)
def test_minplus_matches_jax_and_pallas(i):
    case = kc.minplus_case_at(i)
    w, start = case["w_window"], case["start_node"]
    best, bp = cuda_minplus.minplus_scan(torch.from_numpy(w),
                                         torch.from_numpy(start))
    ref = jax.jit(jax.vmap(jsrch.minplus_scan))(
        jnp.asarray(w), jnp.asarray(start.astype(np.int32)))
    pl = minplus_scan_pallas(jnp.asarray(w), jnp.asarray(
        start.astype(np.int32)), interpret=True)
    for b_j, bp_j in (ref, pl):
        np.testing.assert_array_equal(best.numpy(), np.asarray(b_j))
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bp_j))


@pytest.mark.parametrize("i", MINPLUS, ids=kc.minplus_label)
def test_minplus_matches_numpy(i):
    case = kc.minplus_case_at(i)
    w, start = case["w_window"], case["start_node"]
    best, bp = cuda_minplus.minplus_scan(torch.from_numpy(w),
                                         torch.from_numpy(start))
    b_ref, bp_ref = kc.minplus_numpy(w, start)
    np.testing.assert_array_equal(best.numpy(), b_ref)
    np.testing.assert_array_equal(bp.numpy(), bp_ref)


def test_walk_slot_checked_on_the_host():
    case = kc.walk_case_at(1)               # slot form, 4 slots
    bp, goal, h_eff, slot = [torch.from_numpy(x)
                             for x in kc.walk_args(case)]
    for bad in (4, -1):
        s = slot.clone()
        s[-1] = bad
        with pytest.raises(ValueError, match="slot"):
            cuda_backtrace.backtrace_walk(bp, goal, h_eff, s)
        # the caller's bounds are held against the table's slots too
        with pytest.raises(ValueError, match="slot"):
            cuda_backtrace.backtrace_walk(bp, goal, h_eff, slot,
                                          slot_range=(min(bad, 0),
                                                      max(bad, 3)))
    with pytest.raises(ValueError, match="R0"):     # 4 rows, 3 tables
        cuda_backtrace.backtrace_walk(torch.cat([bp] * 3), goal, h_eff,
                                      slot)


def test_minplus_start_read_where_it_lies():
    base = torch.tensor([3, 1, 2], dtype=torch.int64)
    start, ks = cuda_minplus.start_arg(base[:, None].expand(3, 4), [3, 4])
    assert ks == 4 and start.data_ptr() == base.data_ptr()
    assert start.tolist() == [3, 1, 2]
    start, ks = cuda_minplus.start_arg(torch.arange(12).reshape(3, 4),
                                       [3, 4])
    assert ks == 1 and start.tolist() == list(range(12))
    start, ks = cuda_minplus.start_arg(torch.tensor(5), [2, 3])
    assert ks == 6 and start.tolist() == [5]


@pytest.fixture(scope="module")
def small_oval():
    return tl.build_lattice(tt.make_oval_track(**SMALL_OVAL),
                            OfflineConfig(**SMALL_OVAL_CFG),
                            md5_params="walk")


def test_fleet_tick_slot_form_equals_gather(small_oval, monkeypatch):
    calls = []
    plain = cuda_backtrace.backtrace_walk_plain

    def record(*a, **kw):
        calls.append((a, kw))
        return plain(*a, **kw)
    monkeypatch.setattr(cuda_backtrace, "backtrace_walk_plain", record)
    B = 6
    scen = sc.random_scenarios(small_oval, B, seed=3, n_objects=1,
                               device="cpu")
    sc.make_batched_tick(small_oval, device="cpu", kernels=False)(scen)
    ((bp, goal, h_eff, slot), kw), = calls
    assert kw == {"slot_range": (0, 3)}
    assert bp.shape[:2] == (B, 4) and slot.shape == (B * 4,)
    assert bool((slot.reshape(B, 4)[:, 1] == pg.SLOT_FOLLOW).all())
    gathered = bp[torch.arange(B)[:, None], slot.reshape(B, 4)]
    old = plain(gathered.reshape(B * 4, *bp.shape[2:]), goal, h_eff)
    assert torch.equal(plain(bp, goal, h_eff, slot), old)
    # the kernels' wrapper takes the same call (its plain version on CPU)
    assert torch.equal(cuda_backtrace.backtrace_walk(bp, goal, h_eff, slot),
                       old)


@pytest.mark.parametrize("B,slots", [(1, [0, 1, 2, 3, 1]),
                                     (2, [2, 2, 0, 3]), (3, [1, 0, 3])])
def test_backtrace_slot_form_equals_gather(B, slots):
    label, case = [c for c in wc.window_cases()
                   if c[0].startswith(f"B{7 if B > 1 else 1}-")][0]
    a = [torch.from_numpy(case[k]) for k in wc.WINDOW_ARGS]
    best, bp = cuda_window.fused_window_dp_plain(
        *a, closed=case["closed"], h_max=case["h_max"])
    best, bp = best[:B], bp[:B]
    H = case["h_max"]
    rng = np.random.default_rng(B)
    vg = torch.from_numpy(rng.uniform(0, 5, best.shape).astype(np.float32))
    k = len(slots)
    slot = torch.tensor(slots * B)
    h_eff = torch.from_numpy(rng.integers(1, H + 1, k * B))
    nodes, cost = pg.backtrace_slot(best, bp, vg, h_eff, kernels=False,
                                    slot=slot)
    ranged = pg.backtrace_slot(best, bp, vg, h_eff, kernels=False, slot=slot,
                               slot_range=(min(slots), max(slots)))
    assert torch.equal(ranged[0], nodes) and torch.equal(ranged[1], cost)
    t = torch.arange(k * B) // k
    old_nodes, old_cost = pg.backtrace_slot(best[t, slot], bp[t, slot],
                                            vg[t, slot], h_eff,
                                            kernels=False)
    assert torch.equal(nodes, old_nodes) and torch.equal(cost, old_cost)
    assert bool((nodes[:, 0] >= 0).any())
