"""PyTorch port, the stacked velocity recurrences at ragged shapes: the
wrappers of the CUDA kernel (``ops/cuda_velocity``; on CPU tensors they run
the plain version) against the JAX package's ``stacked_vel_scan`` and
``stacked_vel_scan_cgg_auto`` on the same numpy-seeded inputs
(``testing_tools/vel_cases``): rows and steps around a warp and a chunk of
the kernel, the three modes in an irregular order, ``dyn_model_exp`` 1 and
1.5, machine tables of 2, 16 and 23 rows with a zero-width interval,
zero-length tails and rows without a limit.  Plus the Python that stands
around the kernel: the chunk constant, the shared-memory budget of its
tiling, the build key.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import velocity as jvel
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velocity as cv
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as tvel
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    vel_cases as vc)

SHAPES = list(itertools.product(range(len(vc.RAGGED_R)),
                                range(len(vc.ragged_t(cv.CHUNK)))))
# Port against JAX.  Both run float32 IEEE arithmetic in the same order, but
# XLA's CPU code contracts a*b+c into an FMA and has its own pow, which
# PyTorch's does not share: single roundings differ, and a row carries them
# through up to 447 dependent steps.  The recurrence is linear in v^2, so
# the roundings add up there, in units of an ulp of the row's largest v^2
# (measured over these cases: at most 39.4); in v itself the square root
# magnifies them where a row has slowed far below its top speed (a brake
# row near standstill: up to 2.4e-3 m/s at 1.4 m/s, while rows of a few
# steps agree to 1e-5 m/s).  Hence the bound is on v^2.
TOL_ULP_V2 = 64.0
EPS32 = float(np.finfo(np.float32).eps)


def _ulps_v2(got, ref):
    g, r = got.astype(np.float64), ref.astype(np.float64)
    scale = np.maximum((r * r).max(axis=1, keepdims=True), 1.0)
    return float((np.abs(g * g - r * r) / (EPS32 * scale)).max())


@pytest.mark.parametrize("ri,ti", SHAPES)
def test_vel_scan_matches_jax(ri, ti):
    case, R, T, exp = vc.ragged_case(ri, ti, False, cv.CHUNK)
    args = [case[k] for k in vc.GENERAL_ARGS]
    ref = np.asarray(jvel.stacked_vel_scan(
        *[jnp.asarray(x) for x in args], exp, 0.85, 1000.0))
    got = cv.vel_scan(*[torch.from_numpy(x) for x in args], exp, 0.85,
                      1000.0).numpy()
    assert got.shape == ref.shape == (R, T + 1)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, 0], case["v_init"])
    assert _ulps_v2(got, ref) <= TOL_ULP_V2


@pytest.mark.parametrize("ri,ti", SHAPES)
def test_vel_scan_cgg_matches_jax(ri, ti):
    case, R, T, exp = vc.ragged_case(ri, ti, True, cv.CHUNK)
    args = [case[k] for k in vc.CGG_ARGS]
    ref = np.asarray(jvel.stacked_vel_scan_cgg_auto(
        *[jnp.asarray(x) for x in args], exp, 0.85, 1000.0, 10.0, 9.0))
    got = cv.vel_scan_cgg(*[torch.from_numpy(x) for x in args], exp, 0.85,
                          1000.0, 10.0, 9.0).numpy()
    assert got.shape == ref.shape == (R, T + 1)
    assert _ulps_v2(got, ref) <= TOL_ULP_V2
    # the constant-gg wrapper is the general one with the gg broadcast
    full = {k: torch.from_numpy(v) for k, v in case.items()}
    ax, ay = torch.full_like(full["k1"], 10.0), torch.full_like(full["k1"],
                                                               9.0)
    gen = cv.vel_scan(full["k1"], ax, ay, full["k2"], ax, ay, full["ds"],
                      full["v_lim"], full["v_init"], full["mode"],
                      full["machines"], exp, 0.85, 1000.0).numpy()
    np.testing.assert_array_equal(got, gen)


def test_cases_are_irregular():
    """What the ragged cases claim to hold, they hold."""
    case = vc.vel_case(7, 33, 127, 16)
    mode = case["mode"]
    assert set(mode.tolist()) == {0, 1, 2}
    # no repeating pattern of a short period, as the planner's stacks have
    assert all((mode[p:] != mode[:-p]).any() for p in range(1, 9))
    assert np.isinf(case["v_lim"][mode == tvel.MODE_BRAKE]).all()
    assert np.isinf(case["v_lim"][mode != tvel.MODE_BRAKE]).all(1).any()
    tails = (case["ds"][:, ::-1] != 0).argmax(1)      # trailing zero steps
    assert tails.min() == 0 and tails.max() > cv.CHUNK
    xp = case["machines"][:, 0]
    assert (np.diff(xp) >= 0).all() and (np.diff(xp) == 0).sum() == 1
    # rows start below, inside and above the table
    v0 = vc.vel_case(7, 1000, 2, 16)["v_init"]
    assert v0.min() < xp[0] < np.median(v0) < xp[-1] < v0.max()
    assert vc.vel_case(7, 1, 1)["k1"].shape == (1, 1)


def test_padded_steps_keep_the_limit():
    """A zero-length step still applies v_lim (FWD and BWD rows), so the
    kernel may not skip it; a BRAKE row holds its velocity there."""
    t = torch.tensor
    z = torch.zeros((3, 4))
    v_lim = t([[50.0, 20.0, 30.0, 10.0]] * 3)
    out = cv.vel_scan(z, z + 10, z + 10, z, z + 10, z + 10, z, v_lim,
                      t([40.0, 40.0, 40.0]), t([0, 1, 2], dtype=torch.int32),
                      t(vc.machine_table(2)), 1.0, 0.85, 1000.0)
    np.testing.assert_array_equal(out[0].numpy(), [40, 40, 20, 20, 10])
    np.testing.assert_array_equal(out[1].numpy(), [40] * 5)
    np.testing.assert_array_equal(out[2].numpy(), [40, 40, 20, 20, 10])


def _kernel_constants():
    src = (cuda_build.CSRC / "vel_scan.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}


def test_chunk_constant_matches_the_source():
    assert _kernel_constants()["CH"] == cv.CHUNK
    assert cv.CHUNK - 1 in vc.ragged_t(cv.CHUNK)


@pytest.mark.parametrize("const_gg,streams", [(True, (3, 2, 4)),
                                              (False, (5, 4, 8))])
def test_shared_memory_budget(const_gg, streams):
    """The kernel's tiling (per mode a ring of STAGES chunks of its streams
    and two chunks of output, ROWS rows at a pitch of CH + 1 floats) plus a
    64-row machine table fits the 227 KB a block may use, whatever R and T
    a caller brings: the tile does not grow with them."""
    c = _kernel_constants()
    tile = c["ROWS"] * (c["CH"] + 1) * 4
    ring = sum((n * c["STAGES"] + 2) * tile for n in streams)
    table = 64 * 4 + 63 * 32
    assert c["SMEM_MAX"] == 232448
    assert ring + table <= c["SMEM_MAX"]
    # and two blocks of the constant-gg instance share an SM
    if const_gg:
        assert 2 * (ring + table) <= c["SMEM_MAX"]


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A change to csrc/*.cuh rebuilds the sources that include it."""
    (tmp_path / "vel_scan.cu").write_text("// kernel\n")
    (tmp_path / "ieee_fast.cuh").write_text("// header 1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build._lib_path("vel_scan")
    (tmp_path / "ieee_fast.cuh").write_text("// header 2\n")
    assert cuda_build._lib_path("vel_scan") != before
    assert (cuda_build.CSRC / "vel_scan.cu").exists()
