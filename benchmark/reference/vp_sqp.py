"""The plain reference's speed stage for the SQP velocity planner
(upstream ``vp_type=sqp``: the planner's ``VpSQP`` around the QP solver of
TUMFTM/velocity_optimization), plain PyTorch on the CPU in float64, a
dense QP a row.  Written from the seam's semantics as ``PARITY.md``
§"SQP velocity planner" records them and from the QP that the port's
documentation states (``ops/qp.py``'s docstrings); nothing of the port is
imported.

Per scenario five QPs, each over a fixed window of ``sqp_m`` points
(``EXPORT.nmbr_export_points``) cut at the delay-compensation index
``c_len`` (no brake prefix):

1. the four actions' normal QPs, whose slice ends where the fb stage's
   profile ends (the path's last real row, or 5 m short of it on a
   reduced horizon); the follow QP over the follow action's whole real
   slice, with a pointwise speed cap from the opponent (VpSQP:146-181);
2. the window: the slice's rows, and past its length every column
   repeats its last row and the element length its last step
   (VpSQP:185-205); the gg on the last ``tire_end_idx`` points is the
   tire-end value, the speed at the window's last point at most
   ``sqrt(tire_end * veh_turn)`` (VpSQP:74-81, 361-364); ``v = v_start``
   (``vel_plan``) pinned at its first point;
3. the QP in squared speed ``x = v^2`` scaled by ``s = max(v_max^2, 1)``
   (``v_max`` the row's largest cap), box ``0 <= x <= min(ay / |k|,
   v_cap^2) / s``, the implied acceleration ``a_i = (x_{i+1} - x_i) s /
   (2 ds_i)`` held to ``a_i + (ax |k| / ay + drag) x_i s <= min(ax,
   machine)`` and ``-a_i + (ax |k| / ay - drag) x_i s <= ax``, the machine
   limit read at the box's speed cap (its linearisation point); objective
   ``1/2 x'x + w_s/2 |D x|^2 - x_cap' x``: as close to the caps as the
   limits allow, smoothed;
4. fixed-step OSQP splitting (Stellato et al., "OSQP: an operator
   splitting solver for quadratic programs", 2020, Algorithm 1) on the
   dense matrices: ``K = P + sigma I + A' diag(rho) A`` factored once by
   Cholesky, ``STEPS`` steps with relaxation ``ALPHA`` from the carried
   warm start (the same car's previous profile, VpSQP:297-340; cold
   ``X0_COLD`` m/s), the start pin then met exactly;
5. the status from the scaled primal residual ``max |A x - z|``:
   infeasible (-3) above ``R_INFEASIBLE``, inaccurate (2) above
   ``R_INACCURATE``, else solved (0);
6. the hand-off (VpSQP:238-247, 415-430): an infeasible solve is zeroed,
   an overtake's also when inaccurate, an infeasible follow solve too;
   the follow bound from the follow profile's first point; ``too_close``
   is never raised under SQP (the tick reports none); the profiles placed
   back on the path rows from ``c_len`` (rows past the window zero), the
   fb stage's end and degenerate-slice rules, the follow profile held
   under the follow action's normal one on a reduced horizon, the
   committed course before ``c_len``.

Departures from upstream, each as ``PARITY.md`` §"SQP velocity planner"
records it for the port: a fixed-step ADMM in place of OSQP run to its
tolerance, so the status comes from residual thresholds, not from an
infeasibility certificate; no ``F_ini`` initial force and no power map
(the machine table linearised at the caps stands for both); the
warm-start store's call contract, not the solver package's internals.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from benchmark.reference import plan
from benchmark.reference import velocity as vel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
# ADMM constants as the port documents them: ops/qp.py, admm_vel_qp's
# sigma and alpha; qp_vel_profile's w_smooth and iteration count (the
# "production 150-iteration budget" of PARITY.md); _vel_qp_data's
# penalties (the pinned start row and the dynamics rows stiff)
SIGMA = 1e-6
ALPHA = 1.6
W_SMOOTH = 1e-4
STEPS = 150
RHO_BOX, RHO_PIN, RHO_DYN = 5.0, 400.0, 400.0
# status thresholds on the scaled primal residual: ops/qp.py,
# qp_solver_status's docstring
R_INACCURATE, R_INFEASIBLE = 5e-3, 5e-2
# the cold warm start (VpSQP:64), the reduced horizon's end short of the
# path's end, the follow cap's one depleted sample (VpSQP:146-181)
X0_COLD = 20.0
END_SHORT_M = 5.0
DEPLETED_V = 2.0
# guards: a straight point's curvature, a segment's least length in the
# constraints, a padded segment (no constraint), an open side
KAPPA_EPS, DS_MIN, PAD_EL, BIG = 1e-9, 1e-3, 1e-9, 1e12
# QP rows whose dense matrices are built together: bounds their memory
CHUNK = 512


def _window(col, start, n_real, m):
    """The ``m``-point window of the per-point table ``col`` (R, P, C)
    from row ``start`` (R,), its real length ``n_real`` (R,): past it every
    column repeats the row at ``n_real - 1`` and the element length
    (column 1) the step at ``n_real - 2``, both clamped into the window.
    Rows past the table's end read zero."""
    R, P, C = col.shape
    i = np.arange(m)
    rows = start[:, None] + i
    win = np.where((rows < P)[..., None],
                   np.take_along_axis(col, np.minimum(rows, P - 1)[..., None],
                                      1), 0.0)
    last_v = np.clip(n_real - 1, 0, m - 1)
    last_e = np.clip(n_real - 2, 0, m - 1)
    out = np.where((i < n_real[:, None])[..., None], win,
                   win[np.arange(R), last_v][:, None])
    out[..., 1] = np.where(i < n_real[:, None] - 1, win[..., 1],
                           win[np.arange(R), last_e, 1][:, None])
    return out


def _follow_cap(m, v_max, v_obj, obj_dist, safety, ax, step):
    """VpSQP's follow cap on the ``step`` grid (R,) -> (R, m): ``v_max``
    up to the safety gap, then the opponent's braking curve ``v_j^2 =
    v_obj^2 - 2 ax step j`` from ``v_obj``, its first depleted sample at
    ``DEPLETED_V``; the curve ends there, or at the window's last point
    but one, and the rest keeps the loop's prefill ``v_obj``."""
    i = np.arange(m)
    gap = np.clip(np.ceil((obj_dist - safety) / step), 0, m).astype(int)
    j = i - gap[:, None]
    dep = np.floor(v_obj ** 2 / max(2.0 * ax * step, 1e-9)).astype(int) + 1
    n_fill = np.where(dep <= m - 1, dep + 1, m - 1)
    curve = np.sqrt(np.maximum(v_obj[:, None] ** 2
                               - 2.0 * ax * step * j, 0.0))
    curve = np.where(j == dep[:, None], DEPLETED_V, curve)
    curve = np.where(j == 0, v_obj[:, None], curve)
    tail = np.where((j >= 0) & (j < n_fill[:, None]), curve,
                    v_obj[:, None])
    return np.where(i < gap[:, None], v_max, tail)


def qp_matrices(kap, el, gg, machines, cap, v_start, v_end, drag):
    """The scaled QPs of ``R`` windows as dense float64 matrices: ``kap``,
    ``el``, ``cap`` (R, m), ``gg`` (R, m, 2) [ax ay], ``v_start`` (R,),
    ``v_end`` a number.  Returns dict(P (R, m, m), q, A (R, 3m-2, m), l,
    u, rho, x_cap (R, m) the unscaled cap of x, s (R,))."""
    R, m = kap.shape
    k = np.abs(kap)
    ax, ay = gg[..., 0], gg[..., 1]
    x_cap = np.minimum(ay / np.maximum(k, KAPPA_EPS), cap ** 2)
    x_cap[:, -1] = np.minimum(x_cap[:, -1], v_end ** 2)
    x_cap[:, 0] = np.minimum(x_cap[:, 0], v_start ** 2)
    s = np.maximum(cap.max(-1) ** 2, 1.0)
    machine = np.interp(np.sqrt(x_cap), machines[:, 0], machines[:, 1])
    fric = ax * k / np.maximum(ay, KAPPA_EPS)
    ds = np.maximum(el[:, :-1], DS_MIN)
    live = el[:, :-1] > PAD_EL
    I = np.eye(m)
    lo, hi = I[:-1], I[1:]                       # x_i and x_{i+1} pickers
    c_acc = (2.0 * ds * (fric[:, :-1] + drag))[..., None]
    c_dec = (2.0 * ds * (fric[:, :-1] - drag))[..., None]
    A = np.concatenate([np.broadcast_to(I, (R, m, m)),
                        hi - lo + c_acc * lo,
                        lo - hi + c_dec * lo], 1)
    u_acc = np.where(live, 2.0 * ds * np.minimum(ax, machine)[:, :-1]
                     / s[:, None], BIG)
    u_dec = np.where(live, 2.0 * ds * ax[:, :-1] / s[:, None], BIG)
    l_box = np.zeros((R, m))
    l_box[:, 0] = x_cap[:, 0] / s
    l = np.concatenate([l_box, np.full((R, 2 * (m - 1)), -BIG)], 1)
    u = np.concatenate([x_cap / s[:, None], u_acc, u_dec], 1)
    rho = np.full((R, 3 * m - 2), RHO_DYN)
    rho[:, :m] = RHO_BOX
    rho[:, 0] = RHO_PIN
    D = hi - lo
    P = np.broadcast_to(I + W_SMOOTH * D.T @ D, (R, m, m))
    return dict(P=P, q=-x_cap / s[:, None], A=A, l=l, u=u, rho=rho,
                x_cap=x_cap, s=s)


def _diagonals(M):
    """The diagonals of the batch of matrices ``M`` (R, a, b) that hold a
    nonzero in some matrix: {offset k = column - row: (first row i0,
    M[:, i, i + k] for rows i0 <= i < i0 + len, transposed to (len, R))},
    each cut to the rows between its first and its last nonzero."""
    R, a, b = M.shape
    rows, cols = (M != 0).any(0).nonzero(as_tuple=True)
    out = {}
    for k in sorted(set((cols - rows).tolist())):
        i = rows[cols - rows == k]
        i = torch.arange(int(i.min()), int(i.max()) + 1)
        out[k] = (int(i[0]), M[:, i, i + k].t().contiguous())
    return out


def _cat_diagonals(parts, sizes):
    """:func:`_diagonals` of consecutive blocks of ``sizes`` matrices
    joined: every diagonal that a block holds, over the union of the
    blocks' rows, zero where a block has nothing."""
    out = {}
    for k in sorted(set().union(*parts)):
        spans = [(p[k][0], p[k][0] + len(p[k][1])) for p in parts if k in p]
        i0, i1 = min(a for a, _ in spans), max(b for _, b in spans)
        cols = []
        for p, n in zip(parts, sizes):
            d = torch.zeros(i1 - i0, n, dtype=F64)
            if k in p:
                j0, v = p[k]
                d[j0 - i0:j0 - i0 + len(v)] = v
            cols.append(d)
        out[k] = (i0, torch.cat(cols, 1))
    return out


def _mv(diags, x, a):
    """``M x`` (a, R) from :func:`_diagonals` of ``M`` and ``x`` (b, R):
    vectors are stored transposed, a row of points a column of QPs."""
    out = torch.zeros(a, x.shape[1], dtype=x.dtype)
    for k, (i0, d) in diags.items():
        out[i0:i0 + len(d)] += d * x[i0 + k:i0 + k + len(d)]
    return out


def _cholesky_solve(diags, rhs):
    """``K^-1 rhs`` (n, R) by forward and back substitution with the
    Cholesky factor ``L`` of ``K`` (``K = L L'``), given by
    :func:`_diagonals` (offset 0 and below), each step through the
    factor's nonzero diagonals alone."""
    n = rhs.shape[0]
    i0, d0 = diags[0]
    inv = (1.0 / d0).unbind(0)
    below = [(k, i0, d.unbind(0)) for k, (i0, d) in diags.items() if k < 0]
    b = rhs.unbind(0)
    y = []
    for i in range(n):
        acc = b[i]
        for k, j0, d in below:
            if j0 <= i < j0 + len(d):
                acc = acc - d[i - j0] * y[i + k]
        y.append(acc * inv[i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        for k, j0, d in below:             # L'[i, i - k] = L[i - k, i]
            r = i - k
            if j0 <= r < j0 + len(d):
                acc = acc - d[r - j0] * x[r]
        x[i] = acc * inv[i]
    return torch.stack(x)


def admm(qp, x0, steps=STEPS):
    """Fixed-step OSQP splitting on the dense QPs ``qp``
    (:func:`qp_matrices`) from the scaled start ``x0`` (R, m), in float64
    torch.  ``K`` is built and factored densely, ``CHUNK`` rows at a
    time; the steps run on every row at once, their products with ``A``,
    ``A'`` and the factor through the diagonals that hold the matrices'
    nonzeros (the same matrices, at a fraction of the work).  Returns
    dict(x (R, m) scaled, y (R, 3m-2) the duals, r_prim (R,) the scaled
    primal residual max |A x - z|, r_dual (R,) max |P x + q + A'y|, f (R,)
    the objective 1/2 x'Px + q'x)."""
    def t(k):
        return torch.from_numpy(np.ascontiguousarray(qp[k].T)).to(F64)
    q, l, u, rho = t("q"), t("l"), t("u"), t("rho")        # (points, R)
    n, R = q.shape
    M = l.shape[0]
    dA, dAt, dL, dP, sizes = [], [], [], [], []
    for a in range(0, R, CHUNK):
        sl = slice(a, a + CHUNK)
        A = torch.from_numpy(np.ascontiguousarray(qp["A"][sl])).to(F64)
        P = torch.from_numpy(np.ascontiguousarray(qp["P"][sl])).to(F64)
        At = A.transpose(1, 2)
        K = P + SIGMA * torch.eye(n, dtype=F64) \
            + At @ (rho[:, sl].t()[..., None] * A)
        dL.append(_diagonals(torch.linalg.cholesky(K)))
        dA.append(_diagonals(A))
        dAt.append(_diagonals(At))
        dP.append(_diagonals(P))
        sizes.append(len(A))
    dA, dAt, dL, dP = (_cat_diagonals(d, sizes) for d in (dA, dAt, dL, dP))
    x = torch.from_numpy(np.ascontiguousarray(x0.T)).to(F64)
    z = _mv(dA, x, M)
    y = torch.zeros_like(z)
    for _ in range(steps):
        xt = _cholesky_solve(dL, SIGMA * x - q + _mv(dAt, rho * z - y, n))
        zt = _mv(dA, xt, M)
        x = ALPHA * xt + (1 - ALPHA) * x
        zh = ALPHA * zt + (1 - ALPHA) * z
        z_new = torch.minimum(torch.maximum(zh + y / rho, l), u)
        y = y + rho * (zh - z_new)
        z = z_new
    px = _mv(dP, x, n)
    return dict(x=x.t().numpy(), y=y.t().numpy(),
                r_prim=(_mv(dA, x, M) - z).abs().amax(0).numpy(),
                r_dual=(px + q + _mv(dAt, y, n)).abs().amax(0).numpy(),
                f=(0.5 * (x * px).sum(0) + (q * x).sum(0)).numpy())


@contextlib.contextmanager
def _host_threads():
    """Every core this process may run on for the solve, the run's own
    thread count restored after (the check runs after the timed window,
    when nothing else does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(max(n, len(os.sched_getaffinity(0))))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def status(r_prim):
    return np.where(r_prim > R_INFEASIBLE, -3,
                    np.where(r_prim > R_INACCURATE, 2, 0))


def solve(win, cap, v_start, x0_v, tp, steps=STEPS):
    """The QP profiles of the windows ``win`` (R, m, 4) [kappa el ax ay]
    under the caps ``cap`` (R, m), pinned at ``v_start`` (R,), from the
    warm start ``x0_v`` (R, m) m/s: (v (R, m), status (R,), the scaled
    primal residual (R,))."""
    m = win.shape[1]
    tire = float(tp["tire_end_mps2"])
    gg = win[..., 2:4].copy()
    gg[:, m - int(tp["tire_end_idx"]):] = tire
    qp = qp_matrices(win[..., 0], win[..., 1], gg,
                     np.asarray(tp["machines"], float), cap, v_start,
                     np.sqrt(tire * float(tp["veh_turn"])),
                     tp["drag_coeff"] / tp["m_veh"])
    s = qp["s"][:, None]
    with _host_threads():
        sol = admm(qp, np.minimum(x0_v ** 2 / s, qp["x_cap"] / s), steps)
    r = sol["r_prim"]
    x2 = np.minimum(np.maximum(sol["x"] * s, 0.0), qp["x_cap"])
    x2[:, 0] = np.minimum(v_start ** 2, qp["x_cap"][:, 0])
    return np.sqrt(np.maximum(x2, 0.0)), status(r), r


def speeds(tp, car, paths, n_real, b, red, v_end_rl, obj_dist, v_obj,
           opp_stop, opp_v, opp_cum, sqp_x0=None):
    """The four actions' SQP speed profiles of every scenario (arguments
    and returns as ``plan.speeds``; ``v_end_rl`` and the opponent's
    run-out are the fb stage's and unused here); ``sqp_x0`` (B, 4, P) the
    profiles carried from each scenario's previous tick (None: cold).
    ``speeds.last`` keeps the solve's status and residual (B, 5) for the
    tests and the run's report."""
    B, _, P, _ = paths.shape
    F = plan.FOLLOW
    m = min(int(tp["sqp_m"]), P)
    idx = np.arange(P)
    c_len = b["c_len"].astype(int)
    v_start = b["vel_plan"].astype(float)
    el = paths[..., 4]
    s_path = np.concatenate([np.zeros((B, 4, 1)),
                             np.cumsum(el[..., :-1], -1)], -1)
    # the profile's end, as the fb stage's
    last = np.maximum(n_real - 1, 0)
    short = np.cumsum(el[..., :-1], -1) \
        < (plan._at(s_path, last) - END_SHORT_M)[..., None]
    j = np.argmin(short, -1) + 1
    j = np.where((j == 1) & (n_real > 1), n_real, j)
    v_idx = np.where(red, j, n_real)

    # the five windows a scenario: four normal, then the follow one
    ax, ay = (float(g) for g in tp["gg"])
    col = np.concatenate([paths[..., 3:5],
                          np.broadcast_to([ax, ay], (B, 4, P, 2))], -1)
    col5 = np.concatenate([col, col[:, F:F + 1]], 1).reshape(B * 5, P, 4)
    n5 = np.concatenate([v_idx, n_real[:, F:F + 1]], 1) - c_len[:, None]
    win = _window(col5, np.repeat(c_len, 5), n5.reshape(-1), m)
    cap_f = _follow_cap(m, tp["vel_max"], np.asarray(v_obj, float),
                        np.asarray(obj_dist, float),
                        tp["safety_d"] + tp["veh_length"], ax, tp["sqp_step"])
    cap = np.repeat(np.full((B, 1, m), float(tp["vel_max"])), 5, 1)
    cap[:, 4] = cap_f
    x0 = (np.full((B, 4, m), X0_COLD) if sqp_x0 is None
          else np.asarray(sqp_x0, float)[..., :m])
    x0 = np.concatenate([x0, x0[:, F:F + 1]], 1)
    t0, threads = time.perf_counter(), len(os.sched_getaffinity(0))
    v5, st5, r5 = solve(win, cap.reshape(-1, m), np.repeat(v_start, 5),
                        x0.reshape(-1, m), tp)
    v5, st5 = v5.reshape(B, 5, m), st5.reshape(B, 5)
    print(f"sqp reference: {st5.size} QPs in {time.perf_counter() - t0:.2f} "
          f"s on {threads} threads; status 0 / 2 / -3: "
          f"{int((st5 == 0).sum())} / {int((st5 == 2).sum())} / "
          f"{int((st5 == -3).sum())}; the "
          f"residual's nearest to {R_INACCURATE}: "
          f"{np.abs(r5 - R_INACCURATE).min():.3g} away, to {R_INFEASIBLE}: "
          f"{np.abs(r5 - R_INFEASIBLE).min():.3g}", file=sys.stderr,
          flush=True)

    # the hand-off
    overtake = np.arange(4) >= 2
    zero = (st5[:, :4] == -3) | (overtake & (st5[:, :4] == 2))
    v5[:, :4] = np.where(zero[..., None], 0.0, v5[:, :4])
    v5[:, 4] = np.where((st5[:, 4] == -3)[:, None], 0.0, v5[:, 4])
    placed = np.zeros((B, 5, P))
    bi, i = np.nonzero(c_len[:, None] + np.arange(m) < P)
    placed[bi, :, c_len[bi] + i] = v5[bi, :, i]
    v_norm, v_f = placed[:, :4], placed[:, 4]
    f_bound = np.abs(v_f[np.arange(B), c_len] - v_start) \
        < tp["v_max_offset"]
    v_norm = np.where(idx >= v_idx[..., None], 0.0, v_norm)
    degen = (v_idx - c_len[:, None]) <= 1
    v_norm = np.where(degen[..., None], 0.0, v_norm)
    bound = (np.abs(plan._at(v_norm, np.repeat(c_len[:, None], 4, 1))
                    - v_start[:, None]) < tp["v_max_offset"]) & ~degen
    v_f = np.where(red[:, F, None], np.minimum(v_f, v_norm[:, F]), v_f)
    vx = v_norm.copy()
    vx[:, F] = v_f
    bound[:, F] = f_bound
    course = np.pad(b["vel_course"],
                    ((0, 0), (0, P - b["vel_course"].shape[1])))
    vx = np.where(idx < c_len[:, None, None], course[:, None], vx)
    acc = vel.accelerations(vx, el)
    still = (np.abs(vx[..., :-1]) <= 1e-8) & (np.abs(acc) <= 1e-8) \
        & (idx[:-1] < n_real[..., None] - 1)
    acc = np.where(still, -5.0, acc)
    acc = np.concatenate([acc, np.zeros((B, 4, 1))], -1)
    return s_path, vx, acc, bound
