"""ADMM QP solver and the QP velocity-planning formulation (torch) —
counterpart of the JAX package's ``ops/qp.py``, the SQP velocity backend's
solver (the reference's ``VpSQP`` around OSQP).

QP velocity planning in squared-speed coordinates ``x_i = v_i^2``:

    minimize    -w_v * sum(x) + w_s/2 * ||D1 x||^2
    subject to  0 <= x_i <= min(v_max, v_lat_i)^2          (box)
                a_i + (ax_max_i |kappa_i| / ay_max_i) x_i <= ax_acc_i
                -a_i + (ax_max_i |kappa_i| / ay_max_i) x_i <= ax_dec_i
                x_0 = v_start^2,  x_{end} <= v_end^2

with ``a_i = (x_{i+1} - x_i) / (2 ds_i)`` the implied acceleration.  The
constraint matrix is ``A = [I; A_acc; A_dec]`` with bidiagonal dynamics
blocks, so the ADMM KKT matrix is tridiagonal: ``A x`` and ``A' w`` are
shifted multiply-adds and the x-update is a parallel-cyclic-reduction
solve with coefficients factored once per solve.

Every function takes leading batch axes: one QP per row.  The banded ADMM
(:func:`admm_vel_qp`) is the plain version of the CUDA kernel
``csrc/admm_vel.cu`` (``ops/cuda_admm.py``), which :func:`qp_vel_profile`
runs on the card; the dense :func:`admm_qp` on :func:`build_vel_qp`'s
matrices is the oracle of the tests.
"""

from __future__ import annotations

import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops

_BIG = 1e12


def admm_qp(P, q, A, l, u, iters: int = 60, rho=1.0,
            sigma: float = 1e-6, alpha: float = 1.6, x0=None):
    """Solve ``min 1/2 x'Px + q'x  s.t. l <= Ax <= u`` with fixed-iteration
    ADMM (OSQP splitting), dense, over leading batch axes: ``P`` (..., n,
    n), ``q`` (..., n), ``A`` (..., m, n), ``l``/``u`` (..., m).

    :param rho: scalar or (..., m) per-constraint penalty.
    :returns: (x, z, residuals dict)
    """
    n = q.shape[-1]
    m = l.shape[-1]
    rho = torch.broadcast_to(cuda_graph.as_tensor(rho, q.dtype, q.device),
                             l.shape[:-1] + (m,))
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    At = A.transpose(-1, -2)
    K = P + sigma * eye + (At * rho[..., None, :]) @ A
    K_inv = torch.cholesky_solve(eye.expand(K.shape),
                                 torch.linalg.cholesky(K))

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    x = torch.zeros_like(q) if x0 is None else x0
    z = mv(A, x)
    y = torch.zeros_like(l)
    for _ in range(iters):
        rhs = sigma * x - q + mv(At, rho * z - y)
        x_t = mv(K_inv, rhs)
        z_t = mv(A, x_t)
        x_new = alpha * x_t + (1 - alpha) * x
        z_new = torch.minimum(torch.maximum(
            alpha * z_t + (1 - alpha) * z + y / rho, l), u)
        y = y + rho * (alpha * z_t + (1 - alpha) * z - z_new)
        x, z = x_new, z_new
    r_prim = torch.amax(torch.abs(mv(A, x) - z), dim=-1)
    r_dual = torch.amax(torch.abs(mv(P, x) + q + mv(At, y)), dim=-1)
    return x, z, dict(r_prim=r_prim, r_dual=r_dual, y=y)


# ---------------------------------------------------------------------------
# banded path: shifts along the last axis
# ---------------------------------------------------------------------------

def _sh_d(x, s: int, fill: float = 0.0):
    """Shift down by s: out[..., i] = x[..., i - s] (fill-padded)."""
    return torch.cat([torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype,
                                 device=x.device), x[..., :-s]], dim=-1)


def _sh_u(x, s: int, fill: float = 0.0):
    """Shift up by s: out[..., i] = x[..., i + s] (fill-padded)."""
    return torch.cat([x[..., s:], torch.full(x.shape[:-1] + (s,), fill,
                                             dtype=x.dtype,
                                             device=x.device)], dim=-1)


def _pad_r(v):
    """(..., n-1) -> (..., n) placed at rows 0..n-2."""
    return torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)


def _pad_l(v):
    """(..., n-1) -> (..., n) placed at rows 1..n-1."""
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def pcr_factor(a, b, c):
    """Parallel-cyclic-reduction coefficient tables of tridiagonal systems
    (diagonally dominant, as the ADMM KKT matrix is): ``a`` (..., n)
    sub-diagonal with a[0] = 0, ``b`` (..., n) diagonal, ``c`` (..., n)
    super-diagonal with c[n-1] = 0.  Each of the ceil(log2 n) levels
    eliminates the couplings at the current stride and doubles it.

    :returns: (alphas (..., Lv, n), gammas (..., Lv, n), b_inv (..., n)).
    """
    n = b.shape[-1]
    alphas, gammas = [], []
    s = 1
    while s < n:
        alpha = -a / _sh_d(b, s, 1.0)
        gamma = -c / _sh_u(b, s, 1.0)
        b = b + alpha * _sh_d(c, s) + gamma * _sh_u(a, s)
        a = alpha * _sh_d(a, s)
        c = gamma * _sh_u(c, s)
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return torch.stack(alphas, dim=-2), torch.stack(gammas, dim=-2), 1.0 / b


def pcr_solve(alphas, gammas, b_inv, r):
    """The factored PCR sweeps applied to right-hand sides ``r`` (..., n):
    log2(n) shifted multiply-adds, then one product with ``b_inv``."""
    s = 1
    for lv in range(alphas.shape[-2]):
        r = r + alphas[..., lv, :] * _sh_d(r, s) \
            + gammas[..., lv, :] * _sh_u(r, s)
        s *= 2
    return r * b_inv


def admm_vel_qp(d: dict, iters: int = 60, sigma: float = 1e-6,
                alpha: float = 1.6, w_smooth: float = 1e-4):
    """Banded ADMM on the velocity QP's data (:func:`_vel_qp_data`), one QP
    per row — the same splitting as :func:`admm_qp` on the
    :func:`build_vel_qp` matrices, with every dense product in its banded
    form.  The plain version of ``csrc/admm_vel.cu``: the kernel repeats
    this arithmetic operation for operation.

    :returns: (x (..., n), dict(r_prim (...,), r_dual (...,),
        y (..., 3n-2)))
    """
    e, f = d["e"], d["f"]                               # (..., n-1)
    rho_b, rho_a, rho_d = d["rho_box"], d["rho_acc"], d["rho_dec"]
    q, x0 = d["q"], d["x0"]
    lb, ub = d["l_box"], d["u_box"]
    ua, ud = d["u_acc"], d["u_dec"]
    n = q.shape[-1]

    with cuda_graph.span("gltpl.qp_factor"):
        # K = P + sigma I + A' rho A bands; P = I + w_smooth D'D
        dd = torch.full((n,), 2.0, dtype=q.dtype, device=q.device)
        dd[0] = 1.0
        dd[-1] = 1.0
        diag = (1.0 + w_smooth * dd + sigma + rho_b
                + _pad_r(rho_a * e ** 2 + rho_d * f ** 2)
                + _pad_l(rho_a + rho_d))
        off = -w_smooth + rho_a * e - rho_d * f             # (..., n-1)
        alphas, gammas, b_inv = pcr_factor(_pad_l(off), diag, _pad_r(off))

    def Ax(x):
        return x, e * x[..., :-1] + x[..., 1:], f * x[..., :-1] - x[..., 1:]

    def ATw(wb, wa, wd):
        return wb + _pad_r(e * wa + f * wd) + _pad_l(wa - wd)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    with cuda_graph.span("gltpl.qp_iters"):
        lo_dyn = torch.full_like(ua, -_BIG)
        x = x0
        z_b, z_a, z_d = Ax(x)
        y_b = torch.zeros_like(q)
        y_a = torch.zeros_like(e)
        y_d = torch.zeros_like(e)
        for _ in range(iters):
            rhs = sigma * x - q + ATw(rho_b * z_b - y_b, rho_a * z_a - y_a,
                                      rho_d * z_d - y_d)
            x_t = pcr_solve(alphas, gammas, b_inv, rhs)
            t_b, t_a, t_d = Ax(x_t)
            x_n = alpha * x_t + (1 - alpha) * x
            zh_b = alpha * t_b + (1 - alpha) * z_b
            zh_a = alpha * t_a + (1 - alpha) * z_a
            zh_d = alpha * t_d + (1 - alpha) * z_d
            z_bn = clip(zh_b + y_b / rho_b, lb, ub)
            z_an = clip(zh_a + y_a / rho_a, lo_dyn, ua)
            z_dn = clip(zh_d + y_d / rho_d, lo_dyn, ud)
            x, z_b, z_a, z_d = x_n, z_bn, z_an, z_dn
            y_b = y_b + rho_b * (zh_b - z_bn)
            y_a = y_a + rho_a * (zh_a - z_an)
            y_d = y_d + rho_d * (zh_d - z_dn)

        t_b, t_a, t_d = Ax(x)
        r_prim = torch.maximum(
            torch.amax(torch.abs(t_b - z_b), dim=-1),
            torch.maximum(torch.amax(torch.abs(t_a - z_a), dim=-1),
                          torch.amax(torch.abs(t_d - z_d), dim=-1)))
        # P x with P = I + w_smooth D'D (tridiagonal)
        px = (1.0 + w_smooth * dd) * x \
            - w_smooth * (_pad_l(x[..., :-1]) + _pad_r(x[..., 1:]))
        r_dual = torch.amax(torch.abs(px + q + ATw(y_b, y_a, y_d)), dim=-1)
    return x, dict(r_prim=r_prim, r_dual=r_dual,
                   y=torch.cat([y_b, y_a, y_d], dim=-1))


def _f32(x, ref):
    return cuda_graph.as_tensor(x, ref.dtype, ref.device)


def _vel_qp_data(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                 v_start, v_end=None, end_idx=None, drag_coeff=0.85,
                 m_veh=1000.0, pin_idx=0, v_max_scale=None, x0_v=None):
    """The scaled velocity-QP problem data in banded form, one QP per row:
    ``kappa``/``el_lengths`` (..., P), ``loc_gg`` (..., P, 2),
    ``ax_max_machines`` (M, 2) [v, ax].  ``v_max`` is a scalar or a
    pointwise cap broadcastable to (..., P); ``v_start``, ``v_end``,
    ``end_idx``, ``pin_idx`` and ``v_max_scale`` are scalars or (...,);
    ``x0_v`` (..., P) an optional warm-start velocity guess.  Consumed by
    :func:`admm_vel_qp` and by the dense :func:`build_vel_qp`."""
    P_ = kappa.shape[-1]
    lead = kappa.shape[:-1]
    idx = torch.arange(P_, device=kappa.device)

    def per_row(v):      # a scalar or (...,) argument as (..., 1)
        return torch.broadcast_to(_f32(v, kappa), lead)[..., None]

    kappa_abs = torch.abs(kappa)
    ax_max = loc_gg[..., 0]
    ay_max = loc_gg[..., 1]
    ds = torch.clamp(el_lengths, min=1e-3)
    active = el_lengths > 1e-9                       # real segments

    if end_idx is None:
        end_idx = P_
    v_max_pt = torch.broadcast_to(_f32(v_max, kappa), kappa.shape)
    if v_max_scale is None:
        v_max_scale = torch.amax(v_max_pt, dim=-1)
    v_max_s = per_row(v_max_scale)
    v_start = per_row(v_start)
    end_idx = torch.broadcast_to(cuda_graph.as_tensor(end_idx,
                                                      device=kappa.device),
                                 lead)[..., None]
    pin_idx = torch.broadcast_to(cuda_graph.as_tensor(pin_idx,
                                                      device=kappa.device),
                                 lead)[..., None]

    # velocity caps
    v_lat2 = ay_max / torch.clamp(kappa_abs, min=1e-9)
    x_hi = torch.minimum(v_lat2, v_max_pt ** 2)
    if v_end is not None:
        x_hi = torch.where(idx >= end_idx - 1,
                           torch.minimum(x_hi, per_row(v_end) ** 2), x_hi)
    pin_oh = idx == pin_idx
    x_hi = torch.where(pin_oh, torch.minimum(x_hi, v_start ** 2), x_hi)

    # machine accel at a nominal velocity (linearization point = lat cap)
    v_nom = torch.sqrt(torch.clamp(x_hi, min=0.0))
    ax_machine = velops._interp(v_nom, ax_max_machines[:, 0].contiguous(),
                                ax_max_machines[:, 1])
    drag = _f32(drag_coeff, kappa) / _f32(m_veh, kappa)
    # friction-coupling coefficient (diamond model)
    c_fric = ax_max * kappa_abs / torch.clamp(ay_max, min=1e-9)

    # scaling: x' = x / s with s = v_max^2, so the box is [0, 1]
    s_x = torch.clamp(v_max_s ** 2, min=1.0)
    two_ds = 2.0 * ds[..., :-1]
    coef_acc = two_ds * (c_fric[..., :-1] + drag)
    coef_dec = two_ds * (c_fric[..., :-1] - drag)
    u_acc = two_ds * torch.minimum(ax_max[..., :-1],
                                   ax_machine[..., :-1]) / s_x
    u_dec = two_ds * ax_max[..., :-1] / s_x
    # constraints on padded segments inactive
    u_acc = torch.where(active[..., :-1], u_acc, _BIG)
    u_dec = torch.where(active[..., :-1], u_dec, _BIG)

    x_hi_n = x_hi / s_x
    pin_c = torch.clamp(pin_idx, 0, P_ - 1)
    start_val = torch.minimum(v_start ** 2,
                              torch.gather(x_hi, -1, pin_c.expand(
                                  lead + (1,)).long())) / s_x
    l_box = torch.where(pin_oh, start_val, 0.0)
    q = -x_hi_n
    # stiff penalties on the dynamics rows and the pinned start row
    rho_box = torch.where(pin_oh, 400.0, 5.0).to(kappa.dtype)
    rho_dyn = torch.full(lead + (P_ - 1,), 400.0, dtype=kappa.dtype,
                         device=kappa.device)
    x0 = x_hi_n if x0_v is None else torch.minimum(x0_v ** 2 / s_x, x_hi_n)
    return dict(e=coef_acc - 1.0, f=coef_dec + 1.0, q=q,
                l_box=l_box, u_box=x_hi_n, u_acc=u_acc, u_dec=u_dec,
                rho_box=rho_box, rho_acc=rho_dyn, rho_dec=rho_dyn,
                x0=x0, s_x=s_x[..., 0], x_hi=x_hi, pin_oh=pin_oh)


def build_vel_qp(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                 v_start, v_end=None, end_idx=None, drag_coeff=0.85,
                 m_veh=1000.0, w_smooth=1e-4, pin_idx=0, v_max_scale=None,
                 x0_v=None):
    """The scaled velocity QP ``min 1/2 x'Px + q'x, l <= Ax <= u`` as dense
    matrices (..., n, n) and (..., 3n-2, n), from the same
    :func:`_vel_qp_data` derivation as the banded path — the tests' oracle.

    Returns dict(P, q, A, l, u, rho, x0, s_x, x_hi, pin_oh)."""
    d = _vel_qp_data(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                     v_start, v_end=v_end, end_idx=end_idx,
                     drag_coeff=drag_coeff, m_veh=m_veh, pin_idx=pin_idx,
                     v_max_scale=v_max_scale, x0_v=x0_v)
    q = d["q"]
    n = q.shape[-1]
    lead = q.shape[:-1]
    dt, dev = q.dtype, q.device
    eye = torch.eye(n, dtype=dt, device=dev)
    sub = eye[:-1]                                  # ones at (i, i)
    sup = eye[1:]                                   # ones at (i, i + 1)
    A_acc = d["e"][..., :, None] * sub + sup
    A_dec = d["f"][..., :, None] * sub - sup
    Dn = sup - sub
    A = torch.cat([eye.expand(lead + (n, n)), A_acc, A_dec], dim=-2)
    l = torch.cat([d["l_box"], torch.full(lead + (2 * (n - 1),), -_BIG,
                                          dtype=dt, device=dev)], dim=-1)
    u = torch.cat([d["u_box"], d["u_acc"], d["u_dec"]], dim=-1)
    Pmat = (eye + w_smooth * (Dn.T @ Dn)).expand(lead + (n, n))
    rho = torch.cat([d["rho_box"], d["rho_acc"], d["rho_dec"]], dim=-1)
    return dict(P=Pmat, q=q, A=A, l=l, u=u, rho=rho, x0=d["x0"],
                s_x=d["s_x"], x_hi=d["x_hi"], pin_oh=d["pin_oh"])


def qp_vel_profile(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                   v_start, v_end=None, end_idx=None, drag_coeff=0.85,
                   m_veh=1000.0, w_smooth: float = 1e-4, iters: int = 150,
                   pin_idx=0, v_max_scale=None, x0_v=None,
                   kernels: bool = True):
    """QP velocity profiles, one per row (arguments as
    :func:`_vel_qp_data`): zero element lengths pad a row; ``v = v_start``
    holds exactly at ``pin_idx``.

    The ADMM runs through ``cuda_admm.admm_vel`` when ``kernels`` (the
    CUDA kernel on the card, :func:`admm_vel_qp` on the CPU), else through
    :func:`admm_vel_qp` on any device.

    :param v_max: scalar or pointwise cap — the pointwise form carries the
        follow mode's opponent constraint.
    :param v_max_scale: the box normalization when ``v_max`` is pointwise.
    :param x0_v: optional warm-start velocity guess (the MPC-shifted
        previous solution); None starts from the relaxed optimum.
    :returns: (v (..., P), residuals dict of :func:`admm_vel_qp`)
    """
    with cuda_graph.span("gltpl.qp_setup"):
        d = _vel_qp_data(kappa, el_lengths, loc_gg, ax_max_machines, v_max,
                         v_start, v_end=v_end, end_idx=end_idx,
                         drag_coeff=drag_coeff, m_veh=m_veh, pin_idx=pin_idx,
                         v_max_scale=v_max_scale, x0_v=x0_v)
    if kernels:
        from graphbasedlocaltrajectoryplanner_torch.ops.cuda_admm import (
            admm_vel)
        # one launch factors and iterates: gltpl.qp_factor stays empty
        with cuda_graph.span("gltpl.qp_iters"):
            x_n, res = admm_vel(d, iters=iters, w_smooth=w_smooth)
    else:
        x_n, res = admm_vel_qp(d, iters=iters, w_smooth=w_smooth)
    x = torch.minimum(torch.clamp(x_n * d["s_x"][..., None], min=0.0),
                      d["x_hi"])
    # exact start pin (the ADMM meets it only to solver tolerance, and the
    # handler's velocity-bound check is strict)
    vs2 = torch.broadcast_to(_f32(v_start, kappa),
                             kappa.shape[:-1])[..., None] ** 2
    x = torch.where(d["pin_oh"], torch.minimum(vs2, d["x_hi"]), x)
    return torch.sqrt(torch.clamp(x, min=0.0)), res


def qp_solver_status(res: dict):
    """ADMM residuals as the OSQP-style status codes the infeasibility
    hand-off branches on: ``-3`` primal infeasible, ``2`` solved
    inaccurately, ``0`` solved — thresholds on the scaled primal residual
    (a fixed-iteration ADMM has no infeasibility certificate)."""
    r = res["r_prim"]
    return torch.where(r > 5e-2, -3, torch.where(r > 5e-3, 2, 0)).to(
        torch.int32)
