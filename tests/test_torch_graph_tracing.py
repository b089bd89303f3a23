"""PyTorch port, the measurement on the compiled-call path
(``ops/cuda_graph.py``: ``span``, ``tracing``, ``report`` and the
counters) on the CPU stand-ins of ``testing_tools/graph_standins.py``.

The stand-in graph records the aten operators of a capture and replays
them; its events read a fake device clock that each replayed node other
than an event record moves on by ``node_ms``, so a span's device ms is the
number of nodes between its two event nodes times ``node_ms``.  Held:
tracing off records no event and opens no ``gltpl.call.*`` span, and the
traced graph is the untraced one plus event-record nodes; tracing on
captures a signature of its own and tracing off replays the first graph
again; every ``gltpl.*`` range that the eager fb and sqp ticks open is
in the report as often as in the eager run; the report's ms are the fake
clock's differences; the counters across signatures and ``disabled()``;
the online handler's steps report the same way.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import handler as thandler
from graphbasedlocaltrajectoryplanner_torch.testing_tools.graph_standins \
    import EVENT_RECORD, Event, StandInCuda
from graphbasedlocaltrajectoryplanner_torch.utils.config import OnlineConfig

from test_torch_facade_graph import ONLINE_INI
from torch_port_common import carry, jax_small_oval

B = 4
NODE_MS = 0.25
TICKS = {"fb": {}, "sqp": dict(vp_backend="sqp", sqp_m=115)}


@pytest.fixture(scope="module")
def lat():
    return carry(jax_small_oval())


@pytest.fixture(scope="module")
def scen(lat):
    return tsc.random_scenarios(lat, B, seed=0, n_objects=1, device="cpu")


@pytest.fixture
def stand_in(monkeypatch):
    cuda = StandInCuda(node_ms=NODE_MS)
    monkeypatch.setattr(cuda_graph, "_cuda", cuda)
    return cuda


@pytest.fixture
def host_spans(monkeypatch):
    """Every ``record_function`` that ``ops/cuda_graph`` opens, as
    (name, argument)."""
    seen = []
    real = cuda_graph.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)
    monkeypatch.setattr(cuda_graph, "record_function", spy)
    return seen


def _call_spans(seen):
    return [s for s in seen if s[0].startswith("gltpl.call.")]


def _tick(lat, kind="fb"):
    eager = tsc.make_batched_tick(lat, device="cpu", **TICKS[kind])
    return cuda_graph.capture(eager, "cpu"), eager


def _eager_ranges(fn):
    """The ``gltpl.*`` ranges ``fn()`` opens, counted from the profiler's
    raw events (as ``test_torch_profiling``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("gltpl."))


def _is_event(op) -> bool:
    return isinstance(getattr(op[0], "__self__", None), Event)


def _clock_reading(call):
    """What a replay of traced ``call`` must report, counted from its
    graph's node list: each span's nodes between its event nodes times
    ``NODE_MS``, summed by name, with the enclosing span found by
    position; the graph's nodes; those outside every outermost span."""
    ops = call.graph.ops
    where = {id(op[0].__self__): i for i, op in enumerate(ops)
             if _is_event(op)}
    nodes_before = np.cumsum([0] + [not _is_event(op) for op in ops])
    spans = [(name, where[id(a)], where[id(b)])
             for name, _, a, b in call.spans]
    ranges = {}
    for name, i, j in spans:
        inside = [(n, a) for n, a, b in spans if a < i and j < b]
        parent = max(inside, key=lambda s: s[1])[0] if inside else None
        r = ranges.setdefault(name, dict(ms=0.0, count=0, parent=parent))
        r["ms"] += (nodes_before[j] - nodes_before[i]) * NODE_MS
        r["count"] += 1
    covered = set()
    for name, i, j in spans:
        covered.update(range(i, j))
    outside = sum(1 for k, op in enumerate(ops)
                  if not _is_event(op) and k not in covered)
    return ranges, nodes_before[-1] * NODE_MS, outside * NODE_MS


def test_tracing_off_records_no_event_and_opens_no_call_span(
        lat, scen, stand_in, host_spans):
    tick, _ = _tick(lat)
    tick(scen)
    tick(scen)
    assert stand_in.events == [] and not _call_spans(host_spans)
    (call,) = tick.graphs.values()
    rep = call.report()
    assert not rep["traced"] and rep["replays"] == 2
    assert "ranges" not in rep and "graph_ms" not in rep
    types = stand_in.made[0].node_types
    assert rep["nodes"]["event_record"] == 0
    assert rep["kernel_nodes"] == types.count(0) > 0
    assert sum(rep["nodes"].values()) == len(types)
    assert call.graph.keep_graph and call.graph.instantiated


def test_traced_graph_is_the_untraced_one_plus_event_nodes(
        lat, scen, stand_in):
    tick, eager = _tick(lat)
    plain = tick(scen)
    with cuda_graph.tracing():
        traced = tick(scen)
    g0, g1 = stand_in.made
    assert [op[0] for op in g0.ops] == [op[0] for op in g1.ops
                                        if not _is_event(op)]
    call = list(tick.graphs.values())[1]
    assert call.traced
    assert g1.node_types.count(EVENT_RECORD) == 2 * len(call.spans) + 2
    for k, v in eager(scen).items():
        assert torch.equal(plain[k], v) and torch.equal(traced[k], v), k


def test_tracing_captures_its_own_signature_and_off_replays_the_first(
        lat, scen, stand_in, host_spans):
    tick, _ = _tick(lat)
    tick(scen)
    with cuda_graph.tracing():
        tick(scen)
        tick(scen)
    assert tick.captures == 2 and len(tick.graphs) == 2
    # the capturing call (the second) and the next one, each span carrying
    # the call's number
    assert _call_spans(host_spans) == [
        ("gltpl.call.warmup", "2"), ("gltpl.call.capture", "2"),
        ("gltpl.call.copy_in", "2"), ("gltpl.call.replay", "2"),
        ("gltpl.call.clone_out", "2"), ("gltpl.call.copy_in", "3"),
        ("gltpl.call.replay", "3"), ("gltpl.call.clone_out", "3")]
    del host_spans[:]
    tick(scen)
    assert tick.captures == 2 and len(stand_in.made) == 2
    assert [g.replays for g in stand_in.made] == [2, 2]
    assert not _call_spans(host_spans)


@pytest.mark.parametrize("kind", list(TICKS))
def test_report_holds_every_range_of_the_eager_tick(lat, scen, stand_in,
                                                    kind):
    tick, eager = _tick(lat, kind)
    want = _eager_ranges(lambda: eager(scen))
    with cuda_graph.tracing():
        tick(scen)
    rep = tick.report()["graphs"][0]
    assert rep["traced"]
    assert {k: r["count"] for k, r in rep["ranges"].items()} == dict(want)
    assert rep["ranges"]["gltpl.hit_slab"]["parent"] == "gltpl.plan_window"
    assert rep["ranges"]["gltpl.object_selection"]["parent"] is None
    if kind == "sqp":
        assert rep["ranges"]["gltpl.qp_setup"]["parent"] == "gltpl.velocity"


def test_report_ms_are_the_fake_clock_differences(lat, scen, stand_in):
    tick, _ = _tick(lat)
    with cuda_graph.tracing():
        tick(scen)
        stand_in.clock += 1000.0          # the clock runs between replays
        tick(scen)
    call = list(tick.graphs.values())[0]
    rep = call.report()
    ranges, graph_ms, other_ms = _clock_reading(call)
    assert rep["ranges"] == ranges
    assert rep["graph_ms"] == graph_ms > 0.0
    assert rep["other_ms"] == other_ms
    outer = sum(r["ms"] for r in ranges.values() if r["parent"] is None)
    assert rep["other_ms"] == pytest.approx(graph_ms - outer)
    assert rep["replays"] == 2 and rep["nodes"]["event_record"] == (
        2 * len(call.spans) + 2)


def test_counters_across_signatures_and_disabled(stand_in):
    def fn(x):
        with cuda_graph.span("gltpl.double"):
            y = x * 2.0
        return y + 1.0
    f = cuda_graph.capture(fn, "cpu")
    x, y = torch.arange(3.0), torch.arange(5.0)
    f(x)
    f(x)
    f(y)
    with cuda_graph.disabled():
        f(x)
        with cuda_graph.tracing():
            f(y)
    with cuda_graph.tracing():
        f(x)
        f(x)
    assert torch.equal(f(x), x * 2.0 + 1.0)
    rep = f.report()
    assert (rep["captures"], rep["replays"], rep["eager_calls"]) == (3, 6, 2)
    assert [(g["traced"], g["replays"]) for g in rep["graphs"]] == [
        (False, 3), (False, 1), (True, 2)]
    assert rep["graphs"][2]["ranges"] == {
        "gltpl.double": dict(ms=NODE_MS, count=1, parent=None)}
    assert rep["graphs"][2]["graph_ms"] == 2 * NODE_MS
    assert rep["graphs"][2]["other_ms"] == NODE_MS
    for g in rep["graphs"]:
        assert {"warmup_ms", "capture_ms", "pool_bytes", "kernel_nodes",
                "nodes"} <= set(g)
        assert g["kernel_nodes"] == 2


def test_online_handler_steps_report_the_same_way(lat, stand_in,
                                                  monkeypatch):
    monkeypatch.setattr(cuda_graph, "capture_on_card",
                        lambda fn, device, kernels=True:
                        cuda_graph.capture(fn, device))
    h = thandler.OnlineHandler(lat, OnlineConfig.from_ini(ONLINE_INI),
                               kernels=True)
    rl = int(lat.rl_idx[0])
    args = (h._ints([0, rl, 0, 0, -1, -1, -1, -1]),
            torch.zeros((lat.L, lat.N), dtype=torch.bool),
            h._f32(np.zeros((thandler.O_PAD, 2)))[None],
            h._f32(np.zeros(thandler.O_PAD))[None],
            torch.zeros((1, thandler.O_PAD), dtype=torch.bool),
            torch.tensor([False]), h._f32(np.ones(thandler.N_LAST - 1)))
    plan = h.steps["plan"]
    want = _eager_ranges(lambda: cuda_graph.eager(plan)(*args))
    with cuda_graph.disabled():
        ref, _ = plan(*args)
    with cuda_graph.tracing():
        out, _ = plan(*args)
    rep = plan.report()
    assert (rep["captures"], rep["replays"], rep["eager_calls"]) == (1, 1, 1)
    g = rep["graphs"][0]
    assert {k: r["count"] for k, r in g["ranges"].items()} == dict(want)
    assert set(want) == {"gltpl.hit_slab", "gltpl.window_dp"}
    ranges, graph_ms, other_ms = _clock_reading(
        list(plan.graphs.values())[0])
    assert (g["ranges"], g["graph_ms"], g["other_ms"]) == (
        ranges, graph_ms, other_ms)
    assert h.signatures() == 1
    for k, v in ref.items():
        assert torch.equal(out[k], v), k


def test_stage_timings_reads_the_traced_replays(lat, scen, stand_in,
                                                monkeypatch):
    """``profiling.stage_timings``' card path: each stage the outermost
    ranges of the compiled tick's traced replays, the total the whole
    graph, each the fake clock's count of nodes."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import profiling
    made = []

    def capture_on_card(fn, device, kernels=True):
        made.append(cuda_graph.capture(fn, device))
        return made[-1]
    monkeypatch.setattr(cuda_graph, "capture_on_card", capture_on_card)
    t, total = profiling._replay_stages(lat, scen, 2, tsc.default_p_max(lat),
                                        torch.device("cpu"))
    (tick,) = made
    assert tick.captures == 1 and tick.replays == 3
    ranges, graph_ms, _ = _clock_reading(list(tick.graphs.values())[0])
    assert total == graph_ms
    for st in ("window", "assembly", "velocity"):
        want = sum(r["ms"] for name, r in ranges.items()
                   if r["parent"] is None
                   and profiling.SCOPE_TO_STAGE[name] == st)
        assert t[st] * 1e3 == pytest.approx(want) and want > 0.0, st
