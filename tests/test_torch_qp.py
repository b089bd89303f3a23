"""PyTorch port, the SQP backend's solver (``ops/qp.py``): the port's plain
functions against the JAX package's on the same seeded inputs, on the CPU.

The JAX functions work on one QP and run batched under ``vmap``; the port
takes leading batch axes.  XLA on the CPU contracts ``a * b + c`` into one
fused multiply-add where the port rounds twice, and the ADMM's KKT system
(diagonal about 1,600 against off-diagonals about 800) amplifies such
last-bit differences, so the iterates agree to the bars below and not bit
for bit: x within 1e-5 in the scaled [0, 1] units, v within 1e-3 m/s,
status codes equal.  The instances are smooth, track-like windows of the
velocity planner (the JAX package's own test families); each test prints
its measured maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import qp as jq
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
from graphbasedlocaltrajectoryplanner_torch.ops import qp as tq
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as tvel

MACHINES = np.array([[0.0, 5.0], [30.0, 4.0], [70.0, 2.5]], np.float32)
TOL_X = 1e-5        # scaled units
TOL_V = 1e-3        # m/s


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _window(rng, m, k_amp=0.02, waves=3, pad=0, prefix=0, gg_var=False):
    """A velocity-planner window of m points: smooth curvature, 2.5 m
    steps, ``prefix`` zero-length rows before the profile start and
    ``pad`` zero-length rows at its end, constant or smooth per-point gg."""
    i = np.arange(m)
    phase = rng.uniform(0, 2 * np.pi)
    kappa = (k_amp * np.sin(2 * np.pi * waves * i / m + phase)).astype(
        np.float32)
    el = np.full(m, 2.5, np.float32)
    el[:prefix] = 0.0
    el[m - 1 - pad:] = 0.0
    gg = np.full((m, 2), 10.0, np.float32)
    if gg_var:
        gg[:, 0] = 9.0 + np.sin(0.05 * i + phase)
        gg[:, 1] = 10.0 + np.cos(0.04 * i)
    return kappa, el, gg


def _follow_vmax(m, vel_max, idx_vmax, v_obj):
    """A pointwise cap as the follow mode makes it: the behaviour cap up to
    the gap, the opponent's speed beyond."""
    return np.where(np.arange(m) < idx_vmax, vel_max, v_obj).astype(
        np.float32)


# (label, m, window kwargs, qp kwargs) — every argument form the planner
# passes: scalar and pointwise v_max, v_end, pin_idx after a masked prefix,
# a warm-start x0_v, padded segments, per-point gg
CASES = [
    ("scalar", 115, dict(), dict(v_max=40.0, v_start=20.0)),
    ("v_end", 115, dict(k_amp=0.035, waves=4),
     dict(v_max=40.0, v_start=12.0, v_end=8.0, end_idx=115)),
    ("pointwise_vmax", 115, dict(gg_var=True),
     dict(v_max="follow", v_start=22.0, v_end=6.0, end_idx=115)),
    ("pin_prefix_padded", 115, dict(prefix=3, pad=20),
     dict(v_max=40.0, v_start=18.0, pin_idx=3, v_end=5.0, end_idx=90)),
    ("warm_x0", 115, dict(waves=2),
     dict(v_max=40.0, v_start=25.0, v_end=6.0, end_idx=115, x0="warm")),
    ("short", 60, dict(k_amp=0.015, waves=2),
     dict(v_max=35.0, v_start=20.0, v_end=12.0, end_idx=60)),
]


def _case(label, m, wkw, qkw, rows=3, seed=0):
    """``rows`` seeded instances of one case: (jax args per row, torch
    batched args, kwargs)."""
    rng = np.random.default_rng(seed)
    kap, els, ggs, vmaxs, vss, x0s = [], [], [], [], [], []
    for r in range(rows):
        kappa, el, gg = _window(rng, m, **wkw)
        vs = np.float32(qkw["v_start"] + rng.uniform(-2.0, 2.0))
        if qkw["v_max"] == "follow":
            vmax = _follow_vmax(m, 40.0, 20 + 7 * r, 15.0 + r)
        else:
            vmax = np.full(m, qkw["v_max"], np.float32)
        x0 = None
        if qkw.get("x0") == "warm":
            x0 = (vs + 3.0 * np.sin(np.arange(m) / 9.0 + r)).astype(
                np.float32)
        kap.append(kappa)
        els.append(el)
        ggs.append(gg)
        vmaxs.append(vmax)
        vss.append(vs)
        x0s.append(x0)
    kw = {k: qkw[k] for k in ("v_end", "end_idx", "pin_idx") if k in qkw}
    pointwise = qkw["v_max"] == "follow"
    jargs = [dict(kappa=jnp.asarray(kap[r]), el_lengths=jnp.asarray(els[r]),
                  loc_gg=jnp.asarray(ggs[r]),
                  ax_max_machines=jnp.asarray(MACHINES),
                  v_max=(jnp.asarray(vmaxs[r]) if pointwise
                         else qkw["v_max"]),
                  v_start=vss[r], v_max_scale=40.0 if pointwise else None,
                  x0_v=None if x0s[r] is None else jnp.asarray(x0s[r]),
                  **kw) for r in range(rows)]
    targs = dict(kappa=_t(np.stack(kap)), el_lengths=_t(np.stack(els)),
                 loc_gg=_t(np.stack(ggs)), ax_max_machines=_t(MACHINES),
                 v_max=(_t(np.stack(vmaxs)) if pointwise else qkw["v_max"]),
                 v_start=_t(np.array(vss, np.float32)),
                 v_max_scale=40.0 if pointwise else None,
                 x0_v=(None if x0s[0] is None else _t(np.stack(x0s))), **kw)
    return jargs, targs


def test_shift_helpers_match_jax():
    rng = np.random.default_rng(0)
    for n in (2, 3, 7, 115):
        x = rng.normal(size=n).astype(np.float32)
        xb = np.stack([x, -x])
        for s in sorted({1, 2, n // 2, n - 1} - {0}):
            for fill in (0.0, 1.0):
                for jf, tf in ((jq._sh_d, tq._sh_d), (jq._sh_u, tq._sh_u)):
                    ref = np.asarray(jf(jnp.asarray(x), s, fill))
                    got = tf(_t(xb), s, fill).numpy()
                    np.testing.assert_array_equal(got[0], ref)
                    np.testing.assert_array_equal(
                        got[1], np.asarray(jf(jnp.asarray(-x), s, fill)))
        v = x[:-1]
        np.testing.assert_array_equal(tq._pad_r(_t(v)).numpy(),
                                      np.asarray(jq._pad_r(jnp.asarray(v))))
        np.testing.assert_array_equal(tq._pad_l(_t(v)).numpy(),
                                      np.asarray(jq._pad_l(jnp.asarray(v))))


@pytest.mark.parametrize("n", [2, 3, 64, 115, 130])
def test_pcr_factor_and_solve(n):
    """The PCR tables against JAX's, and the solve against a float64 dense
    solve of the same tridiagonal systems (three rows in one batch)."""
    rng = np.random.default_rng(n)
    rows = 3
    off = rng.uniform(-800.0, -10.0, (rows, n - 1)).astype(np.float32)
    diag = (np.abs(np.pad(off, ((0, 0), (1, 0))))
            + np.abs(np.pad(off, ((0, 0), (0, 1))))
            + rng.uniform(1.0, 20.0, (rows, n))).astype(np.float32)
    a = np.pad(off, ((0, 0), (1, 0)))
    c = np.pad(off, ((0, 0), (0, 1)))
    rhs = rng.normal(size=(rows, n)).astype(np.float32)
    al, ga, b_inv = tq.pcr_factor(_t(a), _t(diag), _t(c))
    x = tq.pcr_solve(al, ga, b_inv, _t(rhs)).numpy()
    assert al.shape == (rows, int(np.ceil(np.log2(n))), n)
    d_tab = d_x = d_ref = 0.0
    for r in range(rows):
        ja, jg, jb = jq.pcr_factor(jnp.asarray(a[r]), jnp.asarray(diag[r]),
                                   jnp.asarray(c[r]))
        for got, ref in ((al[r], ja), (ga[r], jg), (b_inv[r], jb)):
            ref = np.asarray(ref)
            d_tab = max(d_tab, float(np.max(np.abs(got.numpy() - ref)
                                            / np.maximum(np.abs(ref), 1e-6))))
        jx = np.asarray(jq.pcr_solve(ja, jg, jb, jnp.asarray(rhs[r])))
        d_x = max(d_x, float(np.abs(x[r] - jx).max()))
        K = np.diag(diag[r].astype(np.float64)) + np.diag(off[r], 1) \
            + np.diag(off[r], -1)
        xr = np.linalg.solve(K, rhs[r].astype(np.float64))
        d_ref = max(d_ref, float(np.abs(x[r] - xr).max()
                                 / max(np.abs(xr).max(), 1e-12)))
    print(f"pcr n={n}: tables rel {d_tab:.3g}, solve vs JAX {d_x:.3g}, "
          f"vs float64 dense rel {d_ref:.3g}")
    assert d_tab <= 1e-5 and d_ref <= 1e-3
    assert d_x <= 1e-5 * max(1.0, float(np.abs(x).max()))


def test_interp_matches_jnp_interp():
    """The port's ``jnp.interp`` counterpart (``ops/velocity._interp``):
    inside the table, below and above it, on its knots and across repeated
    x values (a zero-width interval)."""
    xp = np.array([0.0, 10.0, 10.0, 30.0, 30.0, 30.0, 70.0], np.float32)
    fp = np.array([5.0, 4.5, 4.0, 3.5, 3.0, 2.8, 2.5], np.float32)
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-20.0, 90.0, 500), xp, [-1e-3, 70.001,
                                                            1e6, -1e6]])
    x = x.astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))
    got = tvel._interp(_t(x), _t(xp), _t(fp)).numpy()
    # jnp.interp is compiled with fp[i-1] + t * df as one fused
    # multiply-add; the port rounds the product first: at most 1 ulp
    ulp = np.spacing(np.abs(ref))
    d_ulp = float(np.max(np.abs(got - ref) / ulp))
    print(f"interp: max {d_ulp:.3g} ulp from jnp.interp")
    assert d_ulp <= 1.0
    # exact outside the table, on its knots and at repeated x values
    exact = (x < xp[0]) | (x > xp[-1]) | np.isin(x, xp)
    np.testing.assert_array_equal(got[exact], ref[exact])
    assert exact.sum() >= len(xp) + 4
    # a 2-D argument, as the planner's (rows, points) tables
    got2 = tvel._interp(_t(x[:500].reshape(20, 25)), _t(xp), _t(fp))
    np.testing.assert_array_equal(got2.numpy().ravel(), got[:500])


@pytest.mark.parametrize("label,m,wkw,qkw", CASES,
                         ids=[c[0] for c in CASES])
def test_vel_qp_data_matches_jax(label, m, wkw, qkw):
    jargs, targs = _case(label, m, wkw, qkw)
    d = tq._vel_qp_data(**targs)
    worst = 0.0
    for r, ja in enumerate(jargs):
        dj = jq._vel_qp_data(**ja)
        for k in ("e", "f", "q", "l_box", "u_box", "u_acc", "u_dec",
                  "rho_box", "rho_acc", "rho_dec", "x0", "x_hi"):
            ref = np.asarray(dj[k], np.float64)
            got = d[k][r].numpy().astype(np.float64)
            worst = max(worst, float(np.max(np.abs(got - ref)
                                            / np.maximum(np.abs(ref), 1.0))))
        np.testing.assert_array_equal(d["pin_oh"][r].numpy(),
                                      np.asarray(dj["pin_oh"]))
        assert float(d["s_x"][r]) == float(dj["s_x"])
    print(f"_vel_qp_data {label}: max rel deviation {worst:.3g}")
    assert worst <= 1e-6


def _jax_eager_profile(ja, iters=150):
    """The JAX package's ``qp_vel_profile`` run op by op (its data
    derivation eager, its ADMM scan, the same post-processing): the same
    arithmetic without XLA fusing the whole pipeline."""
    d = jq._vel_qp_data(**ja)
    x, res = jq.admm_vel_qp(d, iters=iters)
    xx = jnp.clip(x * d["s_x"], 0.0, d["x_hi"])
    xx = jnp.where(d["pin_oh"], jnp.minimum(ja["v_start"] ** 2, d["x_hi"]),
                   xx)
    return np.asarray(x), np.asarray(jnp.sqrt(jnp.maximum(xx, 0.0)))


@pytest.mark.parametrize("label,m,wkw,qkw", CASES,
                         ids=[c[0] for c in CASES])
def test_qp_vel_profile_matches_jax(label, m, wkw, qkw):
    """``qp_vel_profile`` (150 iterations, rows batched) against the JAX
    package row by row.  Against the same arithmetic run op by op: x
    within 1e-5 (scaled), v within 1e-3 m/s.  Against the compiled JAX
    function, whose fused multiply-adds move its own result by up to a few
    1e-3 m/s on these windows (JAX compiled against JAX op by op, printed
    as ``jax self``): status codes equal, and v no farther from it than
    JAX's own op-by-op run is, plus 1e-3 m/s."""
    jargs, targs = _case(label, m, wkw, qkw)
    v, res = tq.qp_vel_profile(**targs)
    # the port's CPU wrapper path is the plain version
    v_plain, _ = tq.qp_vel_profile(**targs, kernels=False)
    assert torch.equal(v, v_plain)
    x, _ = tq.admm_vel_qp(tq._vel_qp_data(**targs), iters=150)
    d_x = d_v = d_jit = d_self = 0.0
    for r, ja in enumerate(jargs):
        jv, jres = jq.qp_vel_profile(**ja)
        jv = np.asarray(jv)
        ex, ev = _jax_eager_profile(ja)
        d_x = max(d_x, float(np.abs(x[r].numpy() - ex).max()))
        d_v = max(d_v, float(np.abs(v[r].numpy() - ev).max()))
        self_r = float(np.abs(ev - jv).max())
        jit_r = float(np.abs(v[r].numpy() - jv).max())
        d_self, d_jit = max(d_self, self_r), max(d_jit, jit_r)
        assert jit_r <= self_r + TOL_V, (label, r, jit_r, self_r)
        st_j = int(jq.qp_solver_status(jres))
        st_t = int(tq.qp_solver_status(res)[r])
        rp = float(jres["r_prim"])
        edge = min(abs(rp - 5e-3) / 5e-3, abs(rp - 5e-2) / 5e-2)
        assert edge > 1e-6, f"{label} row {r}: r_prim {rp} on a threshold"
        assert st_t == st_j, (label, r, st_t, st_j, rp,
                              float(res["r_prim"][r]))
    print(f"qp_vel_profile {label}: op by op max |d x| {d_x:.3g} (scaled), "
          f"max |d v| {d_v:.3g} m/s; compiled max |d v| {d_jit:.3g} m/s "
          f"(jax self {d_self:.3g}); status "
          f"{tq.qp_solver_status(res).tolist()}")
    assert d_x <= TOL_X and d_v <= TOL_V, (d_x, d_v)


def test_admm_vel_qp_residuals_and_duals_match_jax():
    jargs, targs = _case(*CASES[1])
    d = tq._vel_qp_data(**targs)
    x, res = tq.admm_vel_qp(d, iters=60)
    for r, ja in enumerate(jargs):
        jx, jres = jq.admm_vel_qp(jq._vel_qp_data(**ja), iters=60)
        np.testing.assert_allclose(res["y"][r].numpy(), np.asarray(jres["y"]),
                                   atol=1e-3, rtol=1e-4)
        for k in ("r_prim", "r_dual"):
            np.testing.assert_allclose(float(res[k][r]), float(jres[k]),
                                       rtol=1e-3, atol=1e-6)
    assert res["y"].shape == (3, 3 * 115 - 2)


def test_cuda_admm_wrapper_on_cpu_is_the_plain_version():
    jargs, targs = _case(*CASES[0])
    d = tq._vel_qp_data(**targs)
    x, res = cuda_admm.admm_vel(d, iters=20)
    xp, resp = tq.admm_vel_qp(d, iters=20)
    assert torch.equal(x, xp)
    for k in ("r_prim", "r_dual", "y"):
        assert torch.equal(res[k], resp[k])
    assert cuda_admm.admm_vel.launches == 0


def test_status_infeasible_and_feasible_braking():
    """A 60 m/s pinned start with zero end velocity two points later needs
    ~360 m/s^2 of braking: -3 on both sides; a hard but feasible brake (50
    to 0 m/s over 222 m) is not flagged infeasible: 2, solved inaccurately
    in 150 iterations, on both sides (``tests/test_qp_kkt.py``'s
    instances)."""
    machines = np.array([[0.0, 8.0], [30.0, 6.0], [80.0, 4.0]], np.float32)
    for P, el_n, v_max, v_start, v_end, end_idx, want in (
            (8, 2, 70.0, 60.0, 0.0, 3, -3), (96, 90, 50.0, 50.0, 0.0, 91, 2)):
        kappa = np.zeros(P, np.float32)
        el = np.where(np.arange(P) < el_n, 2.5, 0.0).astype(np.float32)
        gg = np.full((P, 2), 10.0, np.float32)
        _, jres = jq.qp_vel_profile(
            jnp.asarray(kappa), jnp.asarray(el), jnp.asarray(gg),
            jnp.asarray(machines), v_max=v_max, v_start=v_start, v_end=v_end,
            end_idx=end_idx)
        v, res = tq.qp_vel_profile(
            _t(kappa)[None], _t(el)[None], _t(gg)[None], _t(machines),
            v_max=v_max, v_start=v_start, v_end=v_end, end_idx=end_idx)
        rp = float(jres["r_prim"])
        print(f"status case P={P}: r_prim {rp:.5g} (jax) "
              f"{float(res['r_prim'][0]):.5g} (port)")
        st = int(tq.qp_solver_status(res)[0])
        assert st == int(jq.qp_solver_status(jres)) == want
        assert tq.qp_solver_status(res).dtype == torch.int32
    # the thresholds on r_prim
    r = torch.tensor([0.0, 5e-3, 5.0001e-3, 5e-2, 5.0001e-2, float("inf")])
    assert tq.qp_solver_status(dict(r_prim=r)).tolist() == [0, 0, 2, 2, -3,
                                                             -3]


def test_dense_oracle_matches_jax_and_the_banded_solve():
    """``build_vel_qp`` + ``admm_qp`` against the JAX package's, and the
    banded ``admm_vel_qp`` against the dense ``admm_qp`` on the same QP (the
    pattern of ``tests/test_qp_crosscheck.py``)."""
    jargs, targs = _case(*CASES[1], rows=2)
    dense = tq.build_vel_qp(**targs)
    for r, ja in enumerate(jargs):
        jd = jq.build_vel_qp(**ja)
        for k in ("P", "A", "l", "u", "rho", "q"):
            np.testing.assert_allclose(dense[k][r].numpy(), np.asarray(jd[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    xd, _, resd = tq.admm_qp(dense["P"], dense["q"], dense["A"], dense["l"],
                             dense["u"], iters=60, rho=dense["rho"],
                             x0=dense["x0"])
    for r, ja in enumerate(jargs):
        jd = jq.build_vel_qp(**ja)
        jx, _, jres = jq.admm_qp(jd["P"], jd["q"], jd["A"], jd["l"], jd["u"],
                                 iters=60, rho=jd["rho"], x0=jd["x0"])
        np.testing.assert_allclose(xd[r].numpy(), np.asarray(jx), atol=1e-4)
    xs, ress = tq.admm_vel_qp(tq._vel_qp_data(**targs), iters=60)
    d_bd = float((xd - xs).abs().max())
    print(f"banded vs dense ADMM: max |d x| {d_bd:.3g}")
    assert d_bd < 1e-4
    assert float((resd["r_prim"] - ress["r_prim"]).abs().max()) < 1e-4
