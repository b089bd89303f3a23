"""PyTorch port, the stage profiler (``parallel/profiling.py``) and the
``gltpl.*`` ranges of the fleet tick.  On the CPU: the cumulative stage
timer's three stages, no trace attribution (the profiler sees no device
kernel here), every range of the fb tick exactly once a tick and the SQP
ranges under ``vp_backend="sqp"``, and the attribution rule on a made-up
event tree (a device kernel belongs to the innermost range around its
launch call)."""

import collections

import pytest
from torch.profiler import ProfilerActivity, profile

from graphbasedlocaltrajectoryplanner_torch.parallel import profiling as pf
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc

from torch_port_common import Ev as _Ev, Range as _Range, carry, jax_small_oval

FB_RANGES = {"gltpl.object_selection", "gltpl.plan_window", "gltpl.hit_slab",
             "gltpl.window_dp", "gltpl.const_path_objects", "gltpl.backtrace",
             "gltpl.assemble", "gltpl.const_splice", "gltpl.velocity",
             "gltpl.emergency"}
QP_RANGES = {"gltpl.qp_setup", "gltpl.qp_factor", "gltpl.qp_iters"}


@pytest.fixture(scope="module")
def oval():
    lat = carry(jax_small_oval())
    return lat, tsc.random_scenarios(lat, 4, seed=0, device="cpu")


def _ranges(fn):
    """The ``gltpl.*`` ranges of ``fn()`` under ``torch.profiler`` (read
    from the profiler's raw events: building the event tree of a plain
    tick on the CPU, about 2e5 events, takes longer than the tick)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("gltpl."))


def test_stage_timings_on_the_cpu(oval):
    lat, scen = oval
    rep = pf.stage_timings(lat, scen, iters=1, device="cpu")
    assert set(rep["stage_ms"]) == {"window", "assembly", "velocity"}
    assert all(v >= 0.0 for v in rep["stage_ms"].values())
    assert rep["total_ms"] > 0.0
    assert rep["roofline"]["batch"] == 4
    assert rep["roofline"]["p_full"] == tsc.C_PAD + tsc.default_p_max(lat)
    assert rep["roofline"]["device"] == "cpu"


def test_stage_timings_trace_sees_no_device_here(oval):
    lat, scen = oval
    assert pf.stage_timings_trace(lat, scen, iters=1, device="cpu") is None


def test_range_cost_is_measured():
    us = pf.range_cost_us(n=200)
    assert 0.0 < us < 1e4


def test_fb_tick_ranges_once_each(oval):
    lat, scen = oval
    tick = tsc.make_batched_tick(lat, device="cpu")
    seen = _ranges(lambda: tick(scen))
    assert set(seen) == FB_RANGES
    assert all(n == 1 for n in seen.values()), seen
    # without the emergency slot there is no emergency range
    tick4 = tsc.make_batched_tick(lat, device="cpu", incl_emergency=False)
    assert set(_ranges(lambda: tick4(scen))) == FB_RANGES - {
        "gltpl.emergency"}
    assert set(pf.SCOPE_TO_STAGE) == FB_RANGES | QP_RANGES


def test_sqp_tick_ranges(oval):
    """The plain ADMM fills qp_factor and qp_iters; through the kernel's
    wrapper (its plain version on the CPU) qp_iters encloses the solve."""
    lat, scen = oval
    for kernels in (False, True):
        tick = tsc.make_batched_tick(lat, device="cpu", kernels=kernels,
                                     vp_backend="sqp", sqp_m=115)
        seen = _ranges(lambda: tick(scen))
        assert set(seen) == FB_RANGES | QP_RANGES, (kernels, seen)
        assert seen["gltpl.qp_setup"] == 1 and seen["gltpl.qp_factor"] == 1
        assert seen["gltpl.qp_iters"] == (2 if kernels else 1)
        assert all(seen[r] == 1 for r in FB_RANGES), seen


def test_attribution_rule_on_a_made_up_trace():
    """Kernels go to the innermost range of their launch call, even when
    they run after the range closed; kernels without a range or without a
    launch call go to ``other``; the device spans drawn for the ranges are
    skipped; host_ms is the range's CPU duration, and other's the host time
    that no outermost range covers."""
    cpu, dev = "DeviceType.CPU", "DeviceType.CUDA"
    outer = _Ev("gltpl.plan_window", 1, cpu, _Range(0, 100))
    inner = _Ev("gltpl.window_dp", 2, cpu, _Range(10, 30), outer)
    vel = _Ev("gltpl.velocity", 3, cpu, _Range(100, 200))
    op = _Ev("aten::add", 4, cpu, _Range(40, 50), outer)
    events = [
        outer, inner, vel, op,
        _Ev("cudaLaunchKernel", 900, cpu, _Range(12, 13), inner),
        _Ev("cudaLaunchKernel", 901, cpu, _Range(41, 42), op),
        _Ev("cudaLaunchKernel", 902, cpu, _Range(150, 151), vel),
        _Ev("cudaLaunchKernel", 903, cpu, _Range(250, 251), None),
        # kernels run later than their launch, after the ranges closed
        _Ev("window_dp_kernel", 900, dev, _Range(300, 302)),
        _Ev("add_kernel", 901, dev, _Range(302, 303)),
        _Ev("vel_scan_kernel", 902, dev, _Range(303, 307)),
        _Ev("stray_kernel", 903, dev, _Range(307, 308)),
        _Ev("no_launch_kernel", 999, dev, _Range(308, 309)),
        _Ev("gltpl.window_dp", 2, dev, _Range(300, 302)),
        _Ev("ProfilerStep*", 5, dev, _Range(300, 309)),
    ]
    stage_ms, scopes, unmatched = pf.attribute(events, iters=1)
    assert scopes["gltpl.window_dp"]["device_ms"] == pytest.approx(2e-3)
    assert scopes["gltpl.plan_window"]["device_ms"] == pytest.approx(1e-3)
    assert scopes["gltpl.velocity"]["device_ms"] == pytest.approx(4e-3)
    assert scopes["other"]["device_ms"] == pytest.approx(2e-3)
    assert scopes["other"]["launches"] == 2 and unmatched == 1
    assert scopes["gltpl.plan_window"]["host_ms"] == pytest.approx(0.1)
    assert stage_ms == pytest.approx(dict(window=3e-3, velocity=4e-3,
                                          other=2e-3))
    stage2, scopes2, _ = pf.attribute(events, iters=2)
    assert scopes2["gltpl.velocity"]["launches"] == 0.5
    assert stage2["velocity"] == pytest.approx(2e-3)
    # other's host time: what the outermost ranges (0.1 + 0.1 ms) leave of
    # the run's host time
    _, scopes3, _ = pf.attribute(events, iters=1, wall_ms=0.5)
    assert scopes3["other"]["host_ms"] == pytest.approx(0.3)
