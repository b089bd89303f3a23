"""PyTorch port, the ADMM kernel's seeded cases at the edges of its warp
design (``testing_tools/admm_cases.py``): the plain ``ops/qp.admm_vel_qp``
against the JAX package's ``admm_vel_qp`` on the CPU, and the cases' own
properties.

``csrc/admm_vel.cu`` runs one warp a QP row for n <= 128, K = ceil(n / 32)
points a lane, ``cuda_admm.WARP_ROWS`` rows a block, and divides by the
penalties through ``csrc/ieee_fast.cuh`` where they lie in its window
[2^-60, 2^60] (by the plain operator elsewhere).  ``chip_smoke.py`` holds
the kernel bit-equal to the plain version on every case on the card; here
the plain version is held against the JAX function on the last row of
each new case (a row in a block that the rows do not fill), as
``tests/test_torch_qp.py`` holds it: x within 1e-5 (scaled units), y
within atol 1e-3 / rtol 1e-4, r_prim and r_dual within rtol 1e-3 / atol
1e-6.

The JAX function runs op by op (``jax.disable_jit``): its compiled scan
contracts ``a * b + c`` into fused multiply-adds, and at 150 steps the KKT
system amplifies those last-bit differences past the residuals' bar on
some of these cases.  Op by op, the two run the same arithmetic; measured
maxima on these cases: 0 for x, y, r_prim and r_dual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.ops import qp as jq
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
from graphbasedlocaltrajectoryplanner_torch.ops import qp as tq
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    admm_cases as ac)

KEYS = cuda_admm._LONG + cuda_admm._SHORT
# the cases added for the warp design (the first 19 predate it)
NEW = list(range(19, len(ac.CASES)))
EDGE_N = (63, 65, 96, 97, 128)
WINDOW = (2.0 ** -60, 2.0 ** 60)


@pytest.mark.parametrize("i", NEW, ids=[ac.label(i) for i in NEW])
def test_new_case_plain_matches_jax(i):
    d, iters = ac.case(i)
    r = d["q"].shape[0] - 1
    x, res = tq.admm_vel_qp({k: d[k][r] for k in KEYS}, iters=iters)
    with jax.disable_jit():
        jx, jres = jq.admm_vel_qp({k: jnp.asarray(d[k][r].numpy())
                                   for k in KEYS}, iters=iters)
    d_x = float(np.abs(x.numpy() - np.asarray(jx)).max())
    d_y = float(np.abs(res["y"].numpy() - np.asarray(jres["y"])).max())
    print(f"admm case {ac.label(i)} row {r}: max |d x| {d_x:.3g} (scaled), "
          f"max |d y| {d_y:.3g}")
    assert d_x <= 1e-5, d_x
    np.testing.assert_allclose(res["y"].numpy(), np.asarray(jres["y"]),
                               atol=1e-3, rtol=1e-4)
    for k in ("r_prim", "r_dual"):
        np.testing.assert_allclose(float(res[k]), float(jres[k]),
                                   rtol=1e-3, atol=1e-6)
    assert bool(torch.isfinite(x).all())


def test_new_cases_reach_the_warp_design_edges():
    """n around 64, 96 and the limit 128 (2, 3 and 4 points a lane), each
    with a row count that fills no block of rows; the facade's call; and
    the block design still reached above 128."""
    shapes = [ac.CASES[i][:3] for i in NEW]
    for n in EDGE_N:
        rows = [R for m, R, _ in shapes if m == n]
        assert rows, f"no new case with n = {n}"
        assert all(R % cuda_admm.WARP_ROWS for R in rows), (n, rows)
        assert all(R % 2 for R in rows), (n, rows)
        assert cuda_admm.design(n) == "warp"
    assert {(n + 31) // 32 for n in EDGE_N} == {2, 3, 4}
    assert (115, 4, 150) in shapes
    assert any(cuda_admm.design(c[0]) == "block" for c in ac.CASES)
    assert cuda_admm.design(cuda_admm.WARP_N_MAX) == "warp"
    assert cuda_admm.design(cuda_admm.WARP_N_MAX + 1) == "block"


def test_tiny_rho_case_leaves_the_division_window():
    """The out-of-window case has, in every row, penalties of each kind
    outside ieee_fast's window, and runs the warp design."""
    flagged = [i for i in NEW if ac.CASES[i][3:] == ("tiny_rho",)]
    assert len(flagged) == 1
    d, _ = ac.case(flagged[0])
    assert cuda_admm.design(d["q"].shape[-1]) == "warp"
    for k in ("rho_box", "rho_acc", "rho_dec"):
        a = d[k].abs()
        out = (a < WINDOW[0]) | (a > WINDOW[1])
        assert bool(out.any(dim=-1).all()), k
        assert bool((~out).any(dim=-1).all()), k
    # the other cases keep their penalties inside the window
    d0, _ = ac.case(NEW[0])
    for k in ("rho_box", "rho_acc", "rho_dec"):
        assert bool(((d0[k] >= WINDOW[0]) & (d0[k] <= WINDOW[1])).all())


def test_cuda_admm_wrapper_on_cpu_is_plain_on_facade_case():
    i = [j for j in NEW if ac.CASES[j][:3] == (115, 4, 150)][0]
    d, iters = ac.case(i)
    launches = cuda_admm.admm_vel.launches
    x, res = cuda_admm.admm_vel(d, iters=iters, with_y=True)
    xp, resp = tq.admm_vel_qp(d, iters=iters)
    assert torch.equal(x, xp)
    for k in ("r_prim", "r_dual", "y"):
        assert torch.equal(res[k], resp[k])
    assert cuda_admm.admm_vel.launches == launches
