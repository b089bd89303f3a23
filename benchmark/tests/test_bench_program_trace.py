"""The readers of the program's spans and counters
(``benchmark/program_trace.py``) on made-up reports and traces."""

import random
import types

import pytest

from benchmark import core, program_trace, trace

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"
NEW = ("fleet.graph_window_ms", "fleet.graph_assembly_ms",
       "fleet.graph_velocity_ms", "fleet.graph_other_ms",
       "fleet.graph_kernel_nodes", "fleet.replay_host_ms",
       "fleet.call_idle_pct")


def _ev(name, a, b, dev):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=a,
                                                                  end=b))


def _rng(ms, parent=None, count=1):
    return dict(ms=ms, parent=parent, count=count)


def test_stages_are_the_outermost_ranges():
    rep = dict(graph_ms=10.0, other_ms=1.5, ranges={
        "gltpl.object_selection": _rng(0.25),
        "gltpl.plan_window": _rng(1.0),
        # nested: inside plan_window's ms already
        "gltpl.hit_slab": _rng(0.5, "gltpl.plan_window"),
        "gltpl.window_dp": _rng(0.25, "gltpl.plan_window"),
        "gltpl.backtrace": _rng(0.5),
        "gltpl.assemble": _rng(3.0),
        "gltpl.const_splice": _rng(0.25),
        "gltpl.velocity": _rng(3.0),
        "gltpl.qp_iters": _rng(2.0, "gltpl.velocity", 2),
        "gltpl.emergency": _rng(0.0, "gltpl.velocity"),
        "gltpl.unknown": _rng(9.0)})
    st = program_trace.stage_ms(rep)
    assert st == dict(window=1.25, assembly=3.75, velocity=3.0, other=1.5,
                      graph=10.0)
    second = dict(rep, graph_ms=12.0, other_ms=3.5)
    third = dict(rep, graph_ms=11.0, other_ms=2.5,
                 ranges=dict(rep["ranges"],
                             **{"gltpl.velocity": _rng(5.0)}))
    med = program_trace.stage_medians([rep, second, third])
    assert med == dict(window=1.25, assembly=3.75, velocity=3.0, other=2.5,
                       graph=11.0)


def _plain(events):
    """Idle and call-idle unit steps inside the windows, counted one by
    one, and the replay spans' durations."""
    wins = [e for e in events if e.name == trace.WINDOW]
    ops = [e for e in events if e.device_type == CUDA
           and not e.name.startswith("gltpl.")]
    calls = [e for e in events if e.name.startswith("gltpl.call.")]
    window = idle = call_idle = 0
    replay = []
    for w in wins:
        for t in range(w.time_range.start, w.time_range.end):
            window += 1
            if any(e.time_range.start <= t < e.time_range.end for e in ops):
                continue
            idle += 1
            call_idle += any(e.time_range.start <= t < e.time_range.end
                             for e in calls)
        replay += [e.time_range.end - e.time_range.start for e in calls
                   if e.name == "gltpl.call.replay"
                   and w.time_range.start <= e.time_range.start
                   and e.time_range.end <= w.time_range.end]
    return window, idle, call_idle, sorted(replay)


@pytest.mark.parametrize("seed", range(6))
def test_call_idle_matches_a_plain_count(seed):
    rng = random.Random(seed)
    events, t = [], 0
    for _ in range(4):
        w0 = t + rng.randint(1, 20)
        w1 = w0 + rng.randint(40, 90)
        events.append(_ev(trace.WINDOW, w0, w1, CPU))
        a = w0
        while a < w1 - 6:                # one tick's host spans
            for name in ("copy_in", "replay", "clone_out"):
                b = a + rng.randint(1, 4)
                events.append(_ev(f"gltpl.call.{name}", a, b, CPU))
                a = b + rng.randint(0, 3)
        t = w1
    # a replay span astride a window's end is not counted
    events.append(_ev("gltpl.call.replay", t - 2, t + 5, CPU))
    events.append(_ev("gltpl.window_dp", 0, t, CUDA))   # a drawn span
    for k in range(40):
        a = rng.randint(0, t + 10)
        events.append(_ev(f"k{k % 5}", a, a + rng.randint(1, 9), CUDA))
    got = program_trace.call_reading(events)
    window, idle, call_idle, replay = _plain(events)
    assert got["window_s"] == pytest.approx(window / 1e6)
    assert got["idle_pct"] == pytest.approx(100.0 * idle / window)
    assert got["call_idle_pct"] == pytest.approx(100.0 * call_idle / window)
    assert got["call_idle_pct"] + got["other_idle_pct"] == pytest.approx(
        got["idle_pct"])
    assert got["replays"] == len(replay)
    mid = len(replay) // 2
    want = (replay[mid] if len(replay) % 2
            else (replay[mid - 1] + replay[mid]) / 2)
    assert got["replay_host_ms"] == pytest.approx(want / 1e3)


def test_no_window_raises():
    with pytest.raises(RuntimeError):
        program_trace.call_reading([_ev("k", 0, 1, CUDA)])


def test_nothing_is_read_outside_a_run_or_from_an_older_program(
        monkeypatch):
    measured = []
    monkeypatch.setattr(program_trace, "measure",
                        lambda w, s: measured.append((w, s)) or {})
    for name in NEW:
        read = core.reader(name)
        assert read({"kind": "fleet"}) is None
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "w", "--seed",
                                     "9"])
    monkeypatch.setattr(program_trace, "available", lambda: False)
    ctx = {"kind": "fleet"}
    assert all(core.reader(name)(ctx) is None for name in NEW)
    assert not measured


def test_the_readers_read_one_measurement(monkeypatch):
    calls = []
    stages = dict(window=0.75, assembly=3.5, velocity=2.4, other=0.4,
                  graph=7.05)

    def measure(workload, seed):
        calls.append((workload, seed))
        return dict(stages=stages, kernel_nodes=1810, replay_host_ms=0.2,
                    call_idle_pct=3.0)
    monkeypatch.setattr(program_trace, "measure", measure)
    monkeypatch.setattr(program_trace, "available", lambda: True)
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "cell",
                                     "--seed", str(2 ** 33 + 1)])
    ctx = {"kind": "fleet"}
    got = [core.reader(name)(ctx) for name in NEW]
    assert got == [0.75, 3.5, 2.4, 0.4, 1810, 0.2, 3.0]
    assert calls == [("cell", 2 ** 33 + 1)]


def test_the_new_entries_in_the_manifest():
    man = core.manifest()
    by_name = {m["name"]: m for m in man["per_layer"]}
    cells = [w["name"] for w in man["workloads"]]
    for name in NEW:
        m = by_name[name]
        assert m["moves"] == "replans_per_s" and m["workloads"] == cells
        assert m["source"] == ("program_counter" if name.endswith("nodes")
                               else "program_span")
    assert [m["name"] for m in man["per_layer"]][-len(NEW):] == list(NEW)
