"""PyTorch port, ops numerics against the JAX package on numpy-seeded
inputs: min-plus scan, spline fits and sampling, projection, row shifts,
the moving-average filter and the cumulative sum's summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import dynshift as jshift
from graphbasedlocaltrajectoryplanner_tpu.ops import projection as jproj
from graphbasedlocaltrajectoryplanner_tpu.ops import search as jsearch
from graphbasedlocaltrajectoryplanner_tpu.ops import splines as jspl
from graphbasedlocaltrajectoryplanner_tpu.ops import velocity as jvel
from graphbasedlocaltrajectoryplanner_torch.ops import dynshift as tshift
from graphbasedlocaltrajectoryplanner_torch.ops import projection as tproj
from graphbasedlocaltrajectoryplanner_torch.ops import search as tsearch
from graphbasedlocaltrajectoryplanner_torch.ops import splines as tspl
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as tvel
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    projection_cases as pc)

t = torch.from_numpy


def test_minplus_scan_matches_jax():
    rng = np.random.default_rng(0)
    H, N = 12, 16
    w = np.where(rng.random((3, H, N, N)) < 0.6,
                 rng.random((3, H, N, N)) * 5, 1e30).astype(np.float32)
    w[1, 2] = 1.0                                   # a layer of ties
    start = np.array([0, 5, 15], np.int32)
    best, bp = tsearch.minplus_scan(t(w), t(start))
    ref = jax.vmap(jsearch.minplus_scan)(jnp.asarray(w), jnp.asarray(start))
    np.testing.assert_array_equal(np.asarray(ref[0]), best.numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), bp.numpy())


def test_spline_fits_match_jax():
    rng = np.random.default_rng(1)
    pts = np.cumsum(rng.uniform(5, 15, (9, 2)), axis=0).astype(np.float32)
    psi_s, psi_e = np.float32(-0.7), np.float32(-0.4)
    got = tspl.fit_clamped_chain(t(pts), torch.tensor(psi_s),
                                 torch.tensor(psi_e)).numpy()
    ref = np.asarray(jspl.fit_clamped_chain(jnp.asarray(pts), psi_s, psi_e))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    ring = np.stack([50 * np.cos(ang), 30 * np.sin(ang)], 1)
    closed = np.vstack([ring, ring[:1]]).astype(np.float32)
    got = tspl.fit_periodic_chain(t(closed)).numpy()
    ref = np.asarray(jspl.fit_periodic_chain(jnp.asarray(closed)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    got_len = tspl.spline_lengths(t(got)).numpy()
    np.testing.assert_allclose(got_len, np.asarray(jspl.spline_lengths(
        jnp.asarray(ref))), rtol=1e-5)
    tt = np.linspace(0, 1, 7).astype(np.float32)
    for tf, jf in ((tspl.head_curv_an, jspl.head_curv_an),):
        for a, b in zip(tf(t(got[:7]), t(tt)), jf(jnp.asarray(ref[:7]),
                                                  jnp.asarray(tt))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


# True / False: the seeded ellipse, closed and open; then the cases the
# projection kernel must reproduce (testing_tools/projection_cases)
@pytest.mark.parametrize("case", [True, False] + [
    n for n in pc.CASES if not n.startswith("ellipse")])
def test_get_s_coord_matches_jax(case):
    """Each position set of a case against the JAX function (vmapped over
    the positions, and over the rows of a polyline a row): the same
    indices, s within 1 mm (NaN where JAX's is NaN)."""
    name = {True: "ellipse_closed", False: "ellipse_open"}.get(case, case)
    line, pos, s_arr, closed = pc.case(name)
    for p in pos:
        s, (ia, ib) = tproj.get_s_coord(line, p, s_arr, closed=closed)
        f = jax.jit(jax.vmap(lambda ln, q, sa: jproj.get_s_coord(
            ln, q, sa, closed=closed),
            in_axes=(0 if line.dim() == 3 else None, 0,
                     0 if line.dim() == 3 else None)))
        ref = f(jnp.asarray(line.contiguous().numpy()),
                jnp.asarray(p.reshape(-1, 2).numpy()),
                jnp.asarray(s_arr.contiguous().numpy()))
        rs, ra, rb = (np.asarray(x).reshape(s.shape)
                        for x in (ref[0], *ref[1]))
        np.testing.assert_array_equal(ra, ia.numpy())
        np.testing.assert_array_equal(rb, ib.numpy())
        np.testing.assert_allclose(s.numpy(), rs, atol=1e-3)


def test_row_shifts_and_window_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((5, 70, 3)).astype(np.float32)
    shifts = np.array([0, 1, 17, 64, 99], np.int32)
    for tf, jf in ((tshift.shift_rows_down, jshift.shift_rows_down),
                   (tshift.shift_rows_up, jshift.shift_rows_up)):
        got = tf(t(x), t(shifts), 64).numpy()
        ref = np.asarray(jax.vmap(lambda a, s: jf(a, s, 64))(
            jnp.asarray(x), jnp.asarray(shifts)))
        np.testing.assert_array_equal(got, ref)
    table = rng.random((300, 3)).astype(np.float32)
    starts = np.array([0, 63, 64, 150, 172], np.int32)
    got = tshift.select_window(t(table), t(starts), 128).numpy()
    ref = np.asarray(jax.vmap(lambda s: jshift.select_window(
        jnp.asarray(table), s, 128))(jnp.asarray(starts)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 127, 128, 256, 257, 447, 1000,
                               4096, 4097, 5000])
def test_cumsum_order_is_the_reference_order(n):
    rng = np.random.default_rng(n)
    x = (rng.random((3, 4, n)) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    np.testing.assert_array_equal(tvp._cumsum(t(x)).numpy(), ref)


@pytest.mark.parametrize("n", [5, 17, 257, 447, 4097])
@pytest.mark.parametrize("form", ["signed", "strided", "leading_zero"])
def test_cumsum_forms_are_the_reference_order(form, n):
    """Negative values and signed zeros, a strided view like a path's
    ``paths[..., 4]`` and the leading-zero form ``_cumsum0``, against
    ``jnp.cumsum``: equal values, and equal bits for rows of more than 16
    (in rows of up to 16 XLA writes a leading -0.0 as +0.0)."""
    rng = np.random.default_rng(n)
    pick = np.array([-0.0, 0.0, 2.5, -1.25, -7.0], np.float32)
    x = np.where(rng.random((3, 4, n)) < 0.5, rng.choice(pick, (3, 4, n)),
                 rng.normal(0.0, 3.0, (3, 4, n))).astype(np.float32)
    jcum = jax.jit(lambda v: jnp.cumsum(v, axis=-1))
    if form == "strided":
        paths = rng.random((3, 4, n, 5)).astype(np.float32)
        paths[..., 4] = x
        got = tvp._cumsum(t(paths)[..., 4]).numpy()
        ref = np.asarray(jcum(x))
    elif form == "leading_zero":
        got = tvp._cumsum0(t(x)).numpy()
        ref = np.concatenate([np.zeros((3, 4, 1), np.float32),
                              np.asarray(jcum(x[..., :-1]))], axis=-1)
    else:
        got = tvp._cumsum(t(x)).numpy()
        ref = np.asarray(jcum(x))
    np.testing.assert_array_equal(got, ref)
    if n > 16:
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_conv_filt_and_ax_profile_match_jax():
    rng = np.random.default_rng(4)
    v = (20 + 5 * rng.random(60)).astype(np.float32)
    el = np.where(rng.random(60) < 0.9, 2.5, 0.0).astype(np.float32)
    for w in (1, 3, 7):
        np.testing.assert_allclose(
            tvel.conv_filt(t(v), w).numpy(),
            np.asarray(jvel.conv_filt(jnp.asarray(v), w)), rtol=1e-6)
    np.testing.assert_allclose(
        tvel.calc_ax_profile(t(v), t(el)).numpy(),
        np.asarray(jvel.calc_ax_profile(jnp.asarray(v), jnp.asarray(el))),
        rtol=1e-5, atol=1e-4)
