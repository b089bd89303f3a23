"""PyTorch port, the SQP branch's own spans on the CPU: ``gltpl.sqp_window``
(the m-point windows, the follow cap, the QPs stacked) and
``gltpl.sqp_handoff`` (the status map, zeroing, the profiles placed back,
the follow bound, the warm-start store) open once a solve, beside the QP
spans and not inside them: in the fleet tick inside ``gltpl.velocity``
(cold and carried), in the facade's SQP velocity step; the fb tick opens
neither; the stage attribution puts their kernels in the velocity
stage."""

import contextlib
import os

import numpy as np
import pytest

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.parallel import profiling as pf
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)

from torch_port_common import Ev, Range, carry, jax_small_oval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEAM = ("gltpl.sqp_window", "gltpl.sqp_handoff")
QP = ("gltpl.qp_setup", "gltpl.qp_factor", "gltpl.qp_iters")
FB_RANGES = {"gltpl.object_selection", "gltpl.plan_window", "gltpl.hit_slab",
             "gltpl.window_dp", "gltpl.const_path_objects", "gltpl.backtrace",
             "gltpl.assemble", "gltpl.const_splice", "gltpl.velocity",
             "gltpl.emergency"}


@pytest.fixture
def spans(monkeypatch):
    """Every ``cuda_graph.span`` opened, in order, as (name, the span
    around it or None)."""
    log, stack = [], []
    real = cuda_graph.span

    @contextlib.contextmanager
    def span(name):
        log.append((name, stack[-1] if stack else None))
        stack.append(name)
        try:
            with real(name):
                yield
        finally:
            stack.pop()
    monkeypatch.setattr(cuda_graph, "span", span)
    return log


@pytest.fixture(scope="module")
def oval():
    lat = carry(jax_small_oval())
    return lat, tsc.random_scenarios(lat, 4, seed=0, device="cpu")


def _solve_order(log, parent):
    """The seam's and the QP's spans of ``log`` whose parent is
    ``parent``, in order, the QP's own nesting folded in."""
    return [n for n, p in log if n in SEAM + QP and p in (parent,) + QP]


@pytest.mark.parametrize("kernels", [True, False])
def test_fleet_tick_seam_spans_nest_in_velocity(oval, spans, kernels):
    lat, scen = oval
    tick = tsc.make_batched_tick(lat, kernels, device="cpu",
                                 vp_backend="sqp", sqp_m=115, tire_end_idx=2)
    out = tick(scen)                                     # cold
    cold = list(spans)
    spans.clear()
    tick(scen, sqp_x0=out["vx_sqp"])                     # carried
    for log in (cold, spans):
        names = [n for n, _ in log]
        for s in SEAM:
            assert names.count(s) == 1, names
            assert dict(log)[s] == "gltpl.velocity"
        order = [n for n in _solve_order(log, "gltpl.velocity")
                 if n != "gltpl.qp_factor"]
        want = ["gltpl.sqp_window", "gltpl.qp_setup", "gltpl.qp_iters",
                "gltpl.sqp_handoff"]
        # through the kernel's wrapper the plain ADMM opens qp_iters again
        # inside the wrapper's
        assert order == (want[:3] + want[2:] if kernels else want), order
        # nothing opens inside the seam's spans but the helpers' own work
        assert not [n for n, p in log if p in SEAM]
        assert set(names) == FB_RANGES | set(QP) | set(SEAM)


def test_fb_tick_range_set_is_unchanged(oval, spans):
    lat, scen = oval
    tsc.make_batched_tick(lat, device="cpu")(scen)
    names = [n for n, _ in spans]
    assert set(names) == FB_RANGES
    assert all(names.count(n) == 1 for n in FB_RANGES)


def test_facade_sqp_step_opens_the_seam_spans(tmp_path, spans):
    """Three ticks of the port's facade under the upstream SQP INI on the
    oval, an opponent ahead: every velocity step opens each seam span
    once, around its one QP solve (set-up, then the ADMM)."""
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": str(tmp_path / "oval.npz"),
          "ltpl_offline_param_path": os.path.join(
              ROOT, "params", "ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              ROOT, "parity", "fixtures", "ltpl_config_online_sqp.ini"),
          "graph_log_id": "spans", "log_path": str(tmp_path / "logs")}
    ltpl = GraphLTPL(pd, device="cpu", log_to_file=False)
    ltpl.graph_init()
    lat = ltpl.lattice
    refline = lat.refline.cpu().numpy()
    pos, heading = cl.start_pose(refline, 0)
    objs = cl.slow_opponent(lat.raceline.cpu().numpy(),
                            lat.normvec.cpu().numpy(),
                            lat.s_rl.cpu().numpy())
    spans.clear()
    cl.drive(ltpl, 3, pos, heading, objs)
    names = [n for n, _ in spans]
    n_solves = names.count("gltpl.qp_setup")
    assert n_solves >= 3
    for s in SEAM:
        assert names.count(s) == n_solves, names
    seq = [n for n in names if n in SEAM + ("gltpl.qp_setup",)]
    assert seq == ["gltpl.sqp_window", "gltpl.qp_setup",
                   "gltpl.sqp_handoff"] * n_solves
    assert not [n for n, p in spans if p in SEAM]


def test_stage_attribution_puts_the_seam_in_velocity():
    """A kernel launched inside either seam span (nested in
    ``gltpl.velocity``) counts in the velocity stage, as the QP set-up's
    counts in its own."""
    cpu, dev = "DeviceType.CPU", "DeviceType.CUDA"
    vel = Ev("gltpl.velocity", 1, cpu, Range(0, 100))
    win = Ev("gltpl.sqp_window", 2, cpu, Range(10, 20), vel)
    setup = Ev("gltpl.qp_setup", 3, cpu, Range(20, 30), vel)
    hand = Ev("gltpl.sqp_handoff", 4, cpu, Range(40, 60), vel)
    events = [vel, win, setup, hand,
              Ev("cudaLaunchKernel", 900, cpu, Range(11, 12), win),
              Ev("cudaLaunchKernel", 901, cpu, Range(21, 22), setup),
              Ev("cudaLaunchKernel", 902, cpu, Range(41, 42), hand),
              Ev("gather_kernel", 900, dev, Range(200, 203)),
              Ev("where_kernel", 901, dev, Range(203, 204)),
              Ev("cat_kernel", 902, dev, Range(204, 209))]
    stage_ms, scopes, unmatched = pf.attribute(events, iters=1)
    assert unmatched == 0
    assert {s: pf.SCOPE_TO_STAGE[s] for s in SEAM} == dict.fromkeys(
        SEAM, "velocity")
    assert scopes["gltpl.sqp_window"]["device_ms"] == pytest.approx(3e-3)
    assert scopes["gltpl.sqp_handoff"]["device_ms"] == pytest.approx(5e-3)
    assert stage_ms == pytest.approx(dict(velocity=8e-3, qp_setup=1e-3))
    assert np.isclose(sum(stage_ms.values()), 9e-3)
