"""The SQP configuration and its cell on the CPU: the configuration's
files and derived options, the plain QP reference (``reference/vp_sqp.py``)
against the program's plain SQP fleet tick with a carried warm start, the
reference's QP run to convergence, planted faults in the program's SQP
path, the bf16 control, and the ADMM kernel's work count."""

import configparser
import json
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import core, fleet, work
from benchmark.reference import lattice as rlat
from benchmark.reference import plan
from benchmark.tests import helpers

NAME = "fleet_sqp_b1024_short_h"
SEED = 2 ** 33 + 21
# the least depth (scaled) of an interior point for which 5,000 fixed
# steps are held to convergence; ADMM closes in slowly on a QP that is
# barely feasible
DEPTH = 1e-3


def _sqp_stage():
    """The reference's SQP speed stage, and its module's namespace."""
    st = plan.speed_stage("sqp")
    return st, st.__globals__


def _cell():
    return helpers.cell(NAME)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_configuration_files_and_options():
    c, cfg, mix = _cell()
    assert c["chips"] == 1 and c["config"] == "ltpl_sqp_oval"
    fb = core.config(helpers.MAN, "ltpl_fb_oval")
    for k in ("track", "offline_ini", "lattice", "vehicle", "reduced",
              "precision"):
        assert cfg[k] == fb[k], k
    # the fb configuration's guarantees but the speed's (see PERF.md)
    assert cfg["guarantees"] == dict(fb["guarantees"], max_dv_mps=0.25)
    # the upstream INI verbatim, vp_type=sqp from the file
    with open(os.path.join(core.ROOT, cfg["online_ini"]), "rb") as a, \
            open(os.path.join(core.ROOT, "parity", "fixtures",
                              "ltpl_config_online_sqp.ini"), "rb") as b:
        assert a.read() == b.read()
    assert cfg["ini_to_tick"] == dict(
        fb["ini_to_tick"], **{"EXPORT.nmbr_export_points": "sqp_m"})
    # each literal by its stated derivation
    cp = core.ini(cfg["online_ini"])
    off = rlat.read_offline(os.path.join(core.ROOT, cfg["offline_ini"]))
    lit = cfg["tick_literals"]
    assert lit["tire_end_idx"] == math.ceil(
        cp.getfloat("DELAY", "delaycomp") * 50 / off.stepsize_approx) == 2
    assert lit["sqp_step"] == off.stepsize_approx == 2.5
    assert lit["veh_turn"] == off.veh_turn
    assert lit["tire_end_mps2"] == cfg["vehicle"]["gg"][1]
    assert set(cfg["tick_literals_source"]) == set(lit)
    opts = core.tick_options(cfg)
    assert (opts["vp_backend"], opts["sqp_m"], opts["tire_end_idx"],
            opts["sqp_step"], opts["tire_end_mps2"]) == ("sqp", 115, 2, 2.5,
                                                         10.0)
    assert "veh_turn" not in opts          # the tick reads its lattice's
    # the traffic: fleet_b1024_short_h field for field, plus the carry
    base = core.traffic("fleet_b1024_short_h")
    assert mix == dict(base, carry={"sqp_x0": "vx_sqp"})


def test_the_cells_manifest_entries():
    man = helpers.MAN
    got = {m["name"] for m in core.per_layer(man, NAME)}
    assert "vel_scan_cgg_roofline" not in got
    assert "fleet.velocity_ms" not in got
    assert got == {"fleet.window_ms", "fleet.assembly_ms", "assemble_roofline",
                   "fleet.device_idle_pct", "fleet.graph_window_ms",
                   "fleet.graph_assembly_ms", "fleet.graph_velocity_ms",
                   "fleet.graph_other_ms", "fleet.graph_kernel_nodes",
                   "fleet.replay_host_ms", "fleet.call_idle_pct"}
    assert {m["name"] for m in core.end_to_end(man, NAME)} == {
        "replans_per_s", "setup_s"}


# ---------------------------------------------------------------------------
# the reference against the program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """A small batch of the cell, the program's plain tick run cold and
    then twice carried; the reference replans the last tick from the same
    carried start."""
    _, cfg, mix = _cell()
    mix = dict(mix, batch=8, n_batches=1)
    f = fleet.setup(cfg, mix, SEED, helpers.CPU, kernels=False)
    b = f.batches[0]
    f.tick.start([b])
    for _ in range(2):
        out = f.tick(b)
    over = {k: v.numpy() for k, v in f.tick.inputs(b).items()}
    st, ns = _sqp_stage()
    seen = []
    real_solve = ns["solve"]

    def solve(*a, **k):
        out = real_solve(*a, **k)
        seen.append((a, k, out))
        return out
    with mock.patch.dict(ns, solve=solve), \
            mock.patch.object(plan, "speed_stage", lambda _: st):
        r = plan.replan(f.ref_lat, f.ref_batches[0], f.tp, over)
    return dict(f=f, p={k: v.numpy() for k, v in out.items()}, r=r,
                over=over, solve=seen[0])


def test_reference_agrees_with_the_programs_carried_plain_tick(carried):
    p, r, g = carried["p"], carried["r"], _cell()[1]["guarantees"]
    nums = fleet.compare(p, r)
    print("sqp reference against the plain tick:", nums)
    assert nums["discrete_mismatches"] == 0
    for k in ("max_cost_rel", "max_dpos_m", "max_dv_mps"):
        assert nums[k] <= g[k], (k, nums)
    # the statuses agree slot for slot (the follow slot's is its follow QP)
    st = carried["solve"][2][1].reshape(-1, 5)
    assert np.array_equal(p["qp_status"], st[:, [0, 4, 2, 3]])
    # the carried start is the program's previous raw profile, used
    assert carried["over"]["sqp_x0"].shape == p["vx_sqp"].shape
    assert not np.allclose(carried["over"]["sqp_x0"], 20.0)


def test_reference_products_and_solve_are_the_dense_ones():
    """The reference's products through the nonzero diagonals, joined over
    blocks whose patterns differ, and its substitution with a Cholesky
    factor equal the dense products and solve."""
    _, ns = _sqp_stage()
    g = torch.Generator().manual_seed(0)
    M = torch.randn(7, 9, 6, dtype=torch.float64, generator=g) \
        * (torch.rand(7, 9, 6, generator=g) < 0.3)
    d = ns["_cat_diagonals"]([ns["_diagonals"](M[:3]),
                              ns["_diagonals"](M[3:4]),
                              ns["_diagonals"](M[4:])], [3, 1, 3])
    x = torch.randn(6, 7, dtype=torch.float64, generator=g)
    assert torch.allclose(ns["_mv"](d, x, 9), torch.einsum("rij,jr->ir",
                                                            M, x))
    n = 11
    band = torch.randn(5, n, dtype=torch.float64, generator=g)
    K = torch.diag_embed(4.0 + band.abs()) \
        + torch.diag_embed(0.5 * band[:, 1:], 1) \
        + torch.diag_embed(0.5 * band[:, 1:], -1)
    rhs = torch.randn(n, 5, dtype=torch.float64, generator=g)
    got = ns["_cholesky_solve"](ns["_diagonals"](torch.linalg.cholesky(K)),
                                rhs)
    assert torch.allclose(got, torch.linalg.solve(K, rhs.t()).t())


def _interior(qp, r):
    """The point of QP ``r`` deepest inside its inequality constraints by
    an independent LP solver (scipy's HiGHS): (its depth t, up to 1, the
    point); None where there is no feasible point."""
    from scipy.optimize import linprog
    A, l, u = qp["A"][r], qp["l"][r], qp["u"][r]
    n = A.shape[1]
    eq = l == u
    lo, hi = ~eq & (l > -1e11), ~eq & (u < 1e11)
    At = np.concatenate([A, np.ones((len(A), 1))], 1)
    Al = np.concatenate([-A, np.ones((len(A), 1))], 1)
    res = linprog(np.r_[np.zeros(n), -1.0],
                  A_ub=np.concatenate([At[hi], Al[lo]]),
                  b_ub=np.concatenate([u[hi], -l[lo]]),
                  A_eq=np.concatenate([A[eq], np.zeros((eq.sum(), 1))], 1),
                  b_eq=l[eq], bounds=[(None, None)] * n + [(None, 1.0)],
                  method="highs")
    if res.status != 0 or res.x[-1] < 0:
        return None
    return res.x[-1], res.x[:n]


def test_reference_qp_meets_its_optimality_conditions(carried):
    """Run 5,000 steps, each of the reference's QPs that has a feasible
    point (an independent LP solver decides) meets its KKT conditions:
    scaled primal feasibility and stationarity within 1e-6, the duals'
    complementarity; and its objective is no worse than at 150 steps where
    that point is feasible, nor than at the LP's point: the reference
    builds and solves the QP it states.  The QPs without a feasible point
    (a start pinned at a curve's lateral limit leaves no braking) get the
    status the hand-off zeroes or keep a residual plateau."""
    _, ns = _sqp_stage()
    (win, cap, v_start, x0_v, tp), _, _ = carried["solve"]
    m = win.shape[1]
    tire = float(tp["tire_end_mps2"])
    gg = win[..., 2:4].copy()
    gg[:, m - int(tp["tire_end_idx"]):] = tire
    qp = ns["qp_matrices"](win[..., 0], win[..., 1], gg,
                           np.asarray(tp["machines"], float), cap, v_start,
                           np.sqrt(tire * tp["veh_turn"]),
                           tp["drag_coeff"] / tp["m_veh"])
    s = qp["s"][:, None]
    x0 = np.minimum(x0_v ** 2 / s, qp["x_cap"] / s)
    s150, s5k = ns["admm"](qp, x0, 150), ns["admm"](qp, x0, 5000)

    def f(x):
        return 0.5 * np.einsum("ri,rij,rj->r", x, qp["P"], x) \
            + (qp["q"] * x).sum(-1)

    def violation(x):
        Ax = np.einsum("rij,rj->ri", qp["A"], x)
        return np.maximum(np.maximum(qp["l"] - Ax, Ax - qp["u"]), 0.0
                          ).max(-1), Ax
    viol, Ax = violation(s5k["x"])
    viol150, _ = violation(s150["x"])
    y = s5k["y"]
    # complementarity: a positive dual only at an active upper bound, a
    # negative one only at an active lower bound (an open side, +-1e12,
    # takes none)
    up, low = qp["u"] < 1e11, qp["l"] > -1e11
    slack = np.where(y > 0, np.where(up, y * (qp["u"] - Ax), y),
                     np.where(low, -y * (Ax - qp["l"]), -y)).max(-1)
    inner = {r: _interior(qp, r) for r in range(len(x0))}
    feas = [r for r, p in inner.items() if p is not None]
    deep = [r for r in feas if inner[r][0] >= DEPTH]
    print(f"{len(feas)} of {len(x0)} QPs feasible, {len(deep)} with a point "
          f"{DEPTH} inside every inequality; on those after 5,000 steps: "
          f"violation {viol[deep].max():.3g}, stationarity "
          f"{s5k['r_dual'][deep].max():.3g}, complementarity "
          f"{slack[deep].max():.3g}; the feasible rest: violation "
          f"{max(viol[r] for r in feas):.3g}")
    assert deep
    for r in deep:
        assert viol[r] <= 1e-6 and s5k["r_dual"][r] <= 1e-6, r
        assert slack[r] <= 1e-6, r
        assert s5k["f"][r] <= f(inner[r][1][None])[0] + 1e-9, r
        if viol150[r] <= 1e-6:
            assert s5k["f"][r] <= s150["f"][r] + 1e-9, r
    assert np.allclose(s5k["f"], f(s5k["x"]))


# ---------------------------------------------------------------------------
# whole carried CPU runs: sound, planted faults, the control
# ---------------------------------------------------------------------------

def fewer_steps(tick):
    """The ADMM cut from 150 steps to 100."""
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_admm
    real = cuda_admm.admm_vel

    def admm_vel(d, iters=60, **kw):
        return real(d, iters=100, **kw)

    def f(scen, **kw):
        with mock.patch.object(cuda_admm, "admm_vel", admm_vel):
            return tick(scen, **kw)
    return f


def cold_start(tick):
    """The carried warm start ignored: every tick starts cold."""
    def f(scen, **kw):
        kw.pop("sqp_x0", None)
        return tick(scen, **kw)
    return f


def swapped_thresholds(tick):
    """The status thresholds swapped: infeasible above 5e-3, inaccurate
    above 5e-2."""
    from graphbasedlocaltrajectoryplanner_torch.ops import qp

    def status(res):
        r = res["r_prim"]
        return torch.where(r > 5e-3, -3, torch.where(r > 5e-2, 2, 0)).to(
            torch.int32)

    def f(scen, **kw):
        with mock.patch.object(qp, "qp_solver_status", status):
            return tick(scen, **kw)
    return f


def test_a_sound_carried_cpu_run_is_correct():
    res, checks = helpers.run(NAME, seed=SEED)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"replans_per_s", "setup_s"}


@pytest.mark.parametrize("fault", [fewer_steps, cold_start,
                                   swapped_thresholds])
def test_sqp_fault_is_not_correct(fault):
    res, checks = helpers.run(NAME, fault=fault, seed=SEED)
    print(fault.__name__, {c["name"]: c["value"] for c in checks})
    assert not res["correct"], checks
    assert res["failed"] > 0


def test_bf16_control_is_not_correct_on_the_cpu():
    res, checks = helpers.run(NAME, control="bf16", seed=SEED)
    print("bf16 control", {c["name"]: c["value"] for c in checks})
    assert not res["correct"]


# ---------------------------------------------------------------------------
# the ADMM kernel's work count
# ---------------------------------------------------------------------------

def _admm_call(R, n, with_y=False):
    m = torch.device("meta")
    d = {k: torch.empty((R, n - 1), device=m) for k in (
        "e", "f", "rho_acc", "rho_dec", "u_acc", "u_dec")}
    d.update({k: torch.empty((R, n), device=m) for k in (
        "rho_box", "q", "x0", "l_box", "u_box")})
    res = dict(r_prim=torch.empty((R,), device=m),
               r_dual=torch.empty((R,), device=m))
    if with_y:
        res["y"] = torch.empty((R, 3 * n - 2), device=m)
    return d, (torch.empty((R, n), device=m), res)


def test_admm_vel_count_is_the_kernel_tables():
    """The SQP fleet tick's call at B=1024: 5,120 rows x 115 points, 150
    steps: 7.21e9 operations, which bound it (0.1075 ms at 67 TFLOP/s)."""
    k = work.kernel("admm_vel")
    d, out = _admm_call(5120, 115)
    nb, ops = k.count((d,), dict(iters=150, w_smooth=1e-4), out)
    assert ops == 5120 * 115 * (150 * (53 + 4 * 7) + 12 + 8 * 7 + 20)
    assert ops == pytest.approx(7.21e9, rel=1e-3)
    assert nb == 4 * 5120 * (6 * 114 + 5 * 115 + 115 + 2)
    assert work.bound_ms(nb, ops) == pytest.approx(0.1075, abs=5e-4)
    d, out = _admm_call(4, 115, with_y=True)
    nb_y, ops_y = k.count((d,), dict(iters=150, with_y=True), out)
    assert nb_y == 4 * 4 * (6 * 114 + 5 * 115 + 115 + 2 + 3 * 115 - 2)
    assert k.count((d, 150), {}, out) == (nb_y, ops_y)


def test_admm_vel_roofline_reader():
    read = core.reader("admm_vel_roofline")
    name = "void admm_vel_warp_kernel<4, false, false, false>(Args)"
    ctx = dict(kind="fleet", kernel_ms={}, work={})
    assert read(ctx) is None
    ctx["kernel_ms"] = {name: 0.5, "other_kernel": 1.0}
    assert read(ctx) is None                      # no counted call
    ctx["work"] = {"admm_vel": (0, int(67e12 * 0.5e-3 * 0.2), 1)}
    assert read(ctx) == pytest.approx(20.0)
    assert read(dict(ctx, kernel_ms={"other_kernel": 1.0})) is None


def test_the_tick_records_one_admm_call_a_tick():
    """On a recorded eager tick of the cell the ADMM's count comes from
    the tick's one call (5 QPs a scenario)."""
    _, cfg, mix = _cell()
    f = fleet.setup(cfg, helpers.small_fleet_mix(mix), 5, helpers.CPU)
    w = {}
    with work.recorded(core.PROGRAM, w):
        f.tick(f.batches[0])
    nb, ops, calls = w["admm_vel"]
    assert calls == 1
    assert ops == 8 * 5 * 115 * (150 * (53 + 4 * 7) + 12 + 8 * 7 + 20)


def test_the_mix_file_is_plain_json():
    path = os.path.join(core.HERE, "traffic", "fleet_b1024_short_h_warm.json")
    with open(path) as fh:
        assert json.load(fh) == _cell()[2]
    cp = configparser.ConfigParser()
    assert cp.read(os.path.join(core.ROOT, _cell()[1]["online_ini"]))
    assert cp.get("VP", "vp_type").strip() == "sqp"


# ---------------------------------------------------------------------------
# the readers of nested spans
# ---------------------------------------------------------------------------

SQP_SPAN_METRICS = ("sqp.graph_qp_ms", "sqp.graph_seam_ms")


def test_span_readers_read_nothing_outside_a_run_or_an_older_program(
        monkeypatch):
    from benchmark import program_trace, range_trace
    measured = []
    monkeypatch.setattr(range_trace, "measure",
                        lambda w, s: measured.append((w, s)) or {})
    for name in SQP_SPAN_METRICS:
        read = core.reader(name)
        assert read({}) is None and read({"kind": "fleet"}) is None
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "w", "--seed",
                                     "9"])
    monkeypatch.setattr(program_trace, "available", lambda: False)
    ctx = {"kind": "fleet"}
    assert all(core.reader(name)(ctx) is None for name in SQP_SPAN_METRICS)
    assert not measured


def test_span_readers_read_one_pass_at_any_depth(monkeypatch):
    """Each metric sums its ranges a tick and takes the median over the
    ticks; a program without a range gives None, never 0; the pass runs
    once a run, from the run's own arguments."""
    from benchmark import program_trace, range_trace
    ticks = [{"gltpl.velocity": 3.0, "gltpl.qp_setup": 0.25 + i / 100,
              "gltpl.qp_iters": 0.5, "gltpl.sqp_window": 0.375,
              "gltpl.sqp_handoff": 0.125 + i / 50} for i in range(5)]
    calls = []

    def measure(workload, seed):
        calls.append((workload, seed))
        return dict(ticks=ticks, seconds=1.0)
    monkeypatch.setattr(range_trace, "measure", measure)
    monkeypatch.setattr(program_trace, "available", lambda: True)
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", NAME, "--seed",
                                     str(2 ** 33 + 3)])
    ctx = {"kind": "fleet"}
    assert core.reader("sqp.graph_qp_ms")(ctx) == pytest.approx(0.77)
    assert core.reader("sqp.graph_seam_ms")(ctx) == pytest.approx(0.54)
    assert calls == [(NAME, 2 ** 33 + 3)]
    older = [{k: v for k, v in t.items() if "sqp_" not in k} for t in ticks]
    ctx = {"kind": "fleet", range_trace.KEY: dict(ticks=older, seconds=1.0)}
    assert core.reader("sqp.graph_seam_ms")(ctx) is None
    assert core.reader("sqp.graph_qp_ms")(ctx) == pytest.approx(0.77)
    assert calls == [(NAME, 2 ** 33 + 3)]
