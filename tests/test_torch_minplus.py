"""PyTorch port, the min-plus DP over materialized windows (kernel 6's
function) and the dense-window search built on it: the port's
``cuda_minplus.minplus_scan`` (its plain version on CPU tensors),
``search.select_goal``/``search_window`` and ``pathgen.plan_window_dense``
against the JAX package on the same seeded inputs.

Gates: frontiers, backpointers, horizons, goal nodes and node chains are
exact — backpointers everywhere, unreachable nodes included, since both
sides take the first index of the same float32 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import search as jsrch
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_minplus import (
    minplus_scan_pallas)
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_minplus
from graphbasedlocaltrajectoryplanner_torch.ops import search as tsrch
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg

from torch_port_common import carry, jax_small_oval

O_PAD = 4


def _windows(seed, B, H, N, inf_share=0.4):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 10, (B, H, N, N)).astype(np.float32)
    w[rng.uniform(size=w.shape) < inf_share] = float(jsrch.INF)
    start = rng.integers(0, N, B).astype(np.int32)
    return w, start


@pytest.mark.parametrize("B,H,N,seed", [(13, 12, 16, 0), (5, 6, 8, 1),
                                        (9, 27, 24, 2)])
def test_minplus_scan_matches_jax_and_pallas(B, H, N, seed):
    # a batch that is not a multiple of the TPU kernel's 8-row block
    w, start = _windows(seed, B, H, N)
    b_ref, bp_ref = jax.jit(jax.vmap(jsrch.minplus_scan))(
        jnp.asarray(w), jnp.asarray(start))
    b_pl, bp_pl = minplus_scan_pallas(jnp.asarray(w), jnp.asarray(start),
                                      interpret=True)
    b_t, bp_t = cuda_minplus.minplus_scan(torch.from_numpy(w),
                                          torch.from_numpy(start))
    assert b_t.dtype == torch.float32 and bp_t.dtype == torch.int32
    assert tuple(b_t.shape) == (B, H + 1, N)
    for b_j, bp_j in ((b_ref, bp_ref), (b_pl, bp_pl)):
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
        np.testing.assert_array_equal(bp_t.numpy(), np.asarray(bp_j))


def test_minplus_scan_leading_dims():
    # (B, 4, H, N, N) windows flatten into rows and come back shaped
    w, start = _windows(3, 12, 5, 8)
    w4 = torch.from_numpy(w).reshape(3, 4, 5, 8, 8)
    s4 = torch.from_numpy(start).reshape(3, 4)
    b4, bp4 = cuda_minplus.minplus_scan(w4, s4)
    b, bp = cuda_minplus.minplus_scan(torch.from_numpy(w),
                                      torch.from_numpy(start))
    assert torch.equal(b4.reshape(12, 6, 8), b)
    assert torch.equal(bp4.reshape(12, 6, 8), bp)


@pytest.mark.parametrize("shrink", [True, False])
def test_search_window_matches_jax_and_dijkstra(shrink):
    B, H, N = 11, 10, 12
    w, start = _windows(4, B, H, N, inf_share=0.55)
    rng = np.random.default_rng(5)
    vg = rng.uniform(0, 3, (B, H + 1, N)).astype(np.float32)
    vg[rng.uniform(size=vg.shape) < 0.2] = float(jsrch.INF)
    h_goal = rng.integers(1, H + 1, B).astype(np.int32)
    shr = np.full(B, shrink)
    ref = jax.jit(jax.vmap(jsrch.search_window))(
        jnp.asarray(w), jnp.asarray(start), jnp.asarray(vg),
        jnp.asarray(h_goal), jnp.asarray(shr))
    out = tsrch.search_window(torch.from_numpy(w), torch.from_numpy(start),
                              torch.from_numpy(vg), torch.from_numpy(h_goal),
                              torch.from_numpy(shr))
    for k in ("nodes", "h_eff", "goal_node", "feasible"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(out["cost"].numpy(),
                                  np.asarray(ref["cost"]))
    # select_goal alone, on the same frontiers
    best, _ = tsrch.minplus_scan(torch.from_numpy(w), torch.from_numpy(start))
    sg = tsrch.select_goal(best, torch.from_numpy(vg),
                           torch.from_numpy(h_goal), torch.from_numpy(shr))
    for got, k in zip(sg, ("h_eff", "goal_node", "cost", "feasible")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref[k]))
    # Dijkstra golden at the selected horizon of every feasible row
    n_feasible = 0
    for r in range(B):
        if not bool(out["feasible"][r]):
            continue
        n_feasible += 1
        he = int(out["h_eff"][r])
        nodes, cost = jsrch.dijkstra_window_np(w[r], int(start[r]), vg[r], he)
        assert nodes == out["nodes"][r, :he + 1].tolist()
        assert abs(cost - float(out["cost"][r])) <= 1e-4 * max(1.0, cost)
    assert n_feasible >= 3


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    return ja, carry(ja)


def _dense_inputs(ja, B):
    """B scenarios on the small oval: two objects near the raceline ahead,
    a zone, a warm-start chain and per-scenario start layers."""
    rl = np.asarray(ja.rl_idx)
    raceline = np.asarray(ja.raceline)
    L, N = ja.L, ja.N
    rng = np.random.default_rng(7)
    sl = rng.integers(0, L, B).astype(np.int32)
    sn = rl[sl].astype(np.int32)
    obs_l = (sl + 6) % L
    opos = np.zeros((B, O_PAD, 2), np.float32)
    opos[:, 0] = raceline[obs_l]
    opos[:, 1] = raceline[obs_l] + 1.0
    orad = np.full((B, O_PAD), 2.5, np.float32)
    oact = np.zeros((B, O_PAD), bool)
    oact[:, :2] = True
    zone = np.zeros((L, N), bool)
    zone[12, :4] = True
    last = np.stack([sn, rl[(sl + 1) % L], rl[(sl + 2) % L] + 1,
                     np.full(B, -1)], axis=1).astype(np.int32)
    w_fac = np.array([0.1, 0.5, 0.8], np.float32)
    found = np.arange(B) % 3 != 2
    return dict(sl=sl, sn=sn, zone=zone, opos=opos, orad=orad, oact=oact,
                obs_l=obs_l.astype(np.int32), obs_n=rl[obs_l].astype(np.int32),
                found=found, last=last, w_fac=w_fac)


def test_plan_window_dense_matches_jax_and_kernel(oval):
    ja, lat = oval
    B = 5
    d = _dense_inputs(ja, B)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    args = (lat, t["sl"], t["sn"], t["zone"], t["opos"], t["orad"],
            t["oact"], t["obs_l"], t["obs_n"], t["found"], t["last"],
            t["w_fac"])
    dense = tpg.plan_window_dense(*args)
    scan = tpg.plan_window_kernel(*args)
    for k in ("best", "bp", "vg", "win_layers", "h_goal"):
        assert torch.equal(dense[k], scan[k].to(dense[k].dtype)), k
    for b in range(B):
        ref = jpg.plan_window_dense(
            ja, jnp.int32(d["sl"][b]), jnp.int32(d["sn"][b]),
            jnp.asarray(d["zone"]), jnp.asarray(d["opos"][b]),
            jnp.asarray(d["orad"][b]), jnp.asarray(d["oact"][b]),
            jnp.int32(d["obs_l"][b]), jnp.int32(d["obs_n"][b]),
            jnp.bool_(d["found"][b]), jnp.asarray(d["last"][b]),
            jnp.asarray(d["w_fac"]), n_last=4)
        for k in ("best", "bp", "vg", "blocked", "w_all", "win_layers"):
            np.testing.assert_array_equal(dense[k][b].numpy(),
                                          np.asarray(ref[k]),
                                          err_msg=f"scenario {b}: {k}")
    # the objects block edges and the overtake splits bite somewhere
    assert bool(dense["blocked"].any())
    assert not torch.equal(dense["best"][:, 2], dense["best"][:, 3])
