"""PyTorch port, the plain versions of the window-DP and slab-hit kernels
against the JAX package on the seeded raw cases of
``testing_tools/window_cases`` (ragged shapes, wrap-around, open tracks,
ties, INF costs, clipped slab layers, objects exactly at their radius).
Exact: the Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_collision import (
    build_samples_t, hit_slab_pallas)
from graphbasedlocaltrajectoryplanner_tpu.ops.pallas_window import (
    fused_window_dp as jax_fused_window_dp)
from graphbasedlocaltrajectoryplanner_torch.ops import (
    cuda_build, cuda_collision, cuda_window)
from graphbasedlocaltrajectoryplanner_torch.ops.cuda_collision import (
    hit_slab, hit_slab_plain)
from graphbasedlocaltrajectoryplanner_torch.ops.cuda_window import (
    fused_window_dp, fused_window_dp_plain)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    window_cases as wc)

WINDOW = list(wc.window_cases())
HIT = list(wc.hit_cases())


def _window_reference(case):
    """The batched scan step written out per scenario in numpy, from the
    docstring of ``fused_window_dp_plain`` alone."""
    c = case
    w, zone = c["w"], c["zone_block"]
    L, N, _ = w.shape
    B, H = len(c["start_layer"]), c["h_max"]
    n_last = c["last_nodes"].shape[1]
    best = np.full((B, 4, H + 1, N), wc.INF, np.float32)
    bp = np.full((B, 4, H + 1, N), -1, np.int32)
    for b in range(B):
        zb = zone[b] if zone.ndim == 3 else zone
        sl, obs = int(c["start_layer"][b]), int(c["obs_node"][b])
        best[b, :, 0, c["start_node"][b]] = 0.0
        for h in range(H):
            layer, nxt = (sl + h) % L, (sl + h + 1) % L
            wl = w[layer].copy()
            if not c["closed"] and sl + h >= L - 1:
                wl[:] = wc.INF
            wl[zb[layer][:, None] | zb[nxt][None, :]] = wc.INF
            if n_last >= 2 and h < n_last - 1:
                a, d = c["last_nodes"][b, h], c["last_nodes"][b, h + 1]
                if a >= 0 and d >= 0 and wl[a, d] < 1e29:
                    wl[a, d] = wl[a, d] * c["w_last_factors"][h]
            blocked = np.zeros((N, N), bool)
            for o in range(c["slab_layers"].shape[1]):
                for j in range(2):
                    if c["slab_layers"][b, o, j] == layer:
                        blocked |= c["hit_slab"][b, o, j]
            w_def = np.where(blocked, wc.INF, wl)
            into = bool(c["in_win"][b]) and int(c["p_obs"][b]) - 1 == h
            outof = bool(c["in_win"][b]) and int(c["p_obs"][b]) == h
            left = np.arange(N) >= obs
            w_left = np.where((into & left[None, :]) | (outof & left[:, None]),
                              wc.INF, w_def)
            w_right = np.where((into & ~left[None, :])
                               | (outof & ~left[:, None]), wc.INF, w_def)
            for s, ws in enumerate((w_def, wl, w_left, w_right)):
                tot = best[b, s, h][:, None] + ws
                best[b, s, h + 1] = np.minimum(tot.min(axis=0), wc.INF)
                bp[b, s, h + 1] = tot.argmin(axis=0)
    return best, bp


@pytest.mark.parametrize("label,case", WINDOW, ids=[l for l, _ in WINDOW])
def test_window_dp_plain_matches_jax(label, case):
    t = {k: torch.from_numpy(case[k]) for k in wc.WINDOW_ARGS}
    args = [t[k] for k in wc.WINDOW_ARGS]
    best, bp = fused_window_dp_plain(*args, closed=case["closed"],
                                     h_max=case["h_max"])
    B, N, H = len(case["start_layer"]), case["w"].shape[1], case["h_max"]
    assert best.shape == bp.shape == (B, 4, H + 1, N)
    assert best.dtype == torch.float32 and bp.dtype == torch.int32
    # on CPU tensors the wrapper is the plain version
    wbest, wbp = fused_window_dp(*args, closed=case["closed"],
                                 h_max=case["h_max"])
    assert torch.equal(wbest, best) and torch.equal(wbp, bp)
    rbest, rbp = _window_reference(case)
    np.testing.assert_array_equal(rbest, best.numpy())
    np.testing.assert_array_equal(rbp, bp.numpy())
    # the Pallas wrapper indexes its discount tables with n_last - 1 and
    # n_last - 2: a chain of fewer than 2 nodes (no discount at all) goes
    # to it as a chain of 2 absent nodes, which means the same
    j = {k: case[k] for k in wc.WINDOW_ARGS}
    if case["last_nodes"].shape[1] < 2:
        j["last_nodes"] = np.full((B, 2), -1, np.int32)
        j["w_last_factors"] = np.ones((1,), np.float32)
    # it also reduces start_layer + h by L at most once: a window that
    # wraps a closed track more than once (L < H here) has no Pallas
    # counterpart and is held against the numpy reference above alone
    if int(case["start_layer"].max()) + H - 1 >= 2 * case["w"].shape[0]:
        assert case["w"].shape[0] < H
        return
    pbest, pbp = jax_fused_window_dp(
        *[jnp.asarray(j[k]) for k in wc.WINDOW_ARGS], closed=case["closed"],
        h_max=case["h_max"], interpret=True)
    np.testing.assert_array_equal(np.asarray(pbest), best.numpy())
    np.testing.assert_array_equal(np.asarray(pbp), bp.numpy())


@pytest.mark.parametrize("label,case", HIT, ids=[l for l, _ in HIT])
def test_hit_slab_plain_matches_jax(label, case):
    args = [torch.from_numpy(case[k]) for k in wc.HIT_ARGS]
    got = hit_slab_plain(*args)
    B, O, _ = case["slab_layers"].shape
    N = case["samples_xy"].shape[1]
    assert got.shape == (B, O, 2, N, N) and got.dtype == torch.bool
    assert torch.equal(hit_slab(*args), got)
    assert not bool(got[~args[4]].any())        # inactive objects hit nothing
    if "all_inactive" not in label and N >= 24:
        assert bool(got.any())
    pallas = hit_slab_pallas(
        build_samples_t(case["samples_xy"]),
        *[jnp.asarray(case[k]) for k in wc.HIT_ARGS[1:]], interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas), got.numpy())


def test_hit_slab_radius_edge_is_a_hit():
    """An object exactly at its radius from an edge's nearest sample blocks
    that edge (``<=``), and misses it once the radius is one ulp smaller."""
    label, case = HIT[1]
    a = {k: case[k].copy() for k in wc.HIT_ARGS}
    L = a["samples_xy"].shape[0]
    a["obj_app"][:] = True
    a["slab_layers"][:] = 2                     # a layer on the exact grid
    d = a["samples_xy"][2][None, None] - a["obj_pos"][:, :, None, None, None]
    dmin = (d[..., 0] ** 2 + d[..., 1] ** 2).min(axis=-1)       # (B,O,N,N)
    B, O = a["ref2"].shape
    a["ref2"] = dmin.reshape(B, O, -1).min(axis=-1).astype(np.float32)
    hit = hit_slab_plain(*[torch.from_numpy(a[k]) for k in wc.HIT_ARGS])
    assert bool(hit.flatten(2).any(dim=2).all()) and L > 2
    a["ref2"] = np.nextafter(a["ref2"], np.float32(-1.0))
    miss = hit_slab_plain(*[torch.from_numpy(a[k]) for k in wc.HIT_ARGS])
    assert not bool(miss.any())


def test_index_tensors_go_to_the_kernels_as_they_are():
    """int32 and int64 indices are passed on unconverted (the kernels read
    both); any other integer type becomes int32; a view becomes contiguous."""
    for dtype, wide in ((torch.int32, 0), (torch.int64, 1)):
        t = torch.arange(6, dtype=dtype)
        got, is_wide = cuda_build.index_arg(t)
        assert got.data_ptr() == t.data_ptr() and is_wide == wide
    got, is_wide = cuda_build.index_arg(torch.arange(6, dtype=torch.int16))
    assert got.dtype == torch.int32 and is_wide == 0
    got, is_wide = cuda_build.index_arg(torch.arange(12).reshape(3, 4).T)
    assert got.is_contiguous() and is_wide == 1
    assert got.tolist() == torch.arange(12).reshape(3, 4).T.tolist()


def test_kernel_arguments_refuse_cpu_tensors():
    """The kernels' argument checks take CUDA tensors only: the wrappers
    use the plain versions for CPU tensors before they get there."""
    label, case = WINDOW[1]
    args = [torch.from_numpy(case[k]) for k in wc.WINDOW_ARGS]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_window.kernel_args(*args, closed=case["closed"],
                                h_max=case["h_max"])
    label, case = HIT[1]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_collision.kernel_args(
            *[torch.from_numpy(case[k]) for k in wc.HIT_ARGS])
