"""The trace readings against a plain count on made-up traces."""

import random
import types

import pytest

from benchmark import trace

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


def _ev(name, a, b, dev):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=a,
                                                                  end=b))


def _plain(events):
    wins = [(e.time_range.start, e.time_range.end) for e in events
            if e.name == trace.WINDOW]
    ops = [e for e in events if e.device_type == CUDA]
    busy, names = 0, {}
    for w0, w1 in wins:
        for t in range(w0, w1):          # unit steps: busy if any op runs
            busy += any(e.time_range.start <= t < e.time_range.end
                        for e in ops)
    for e in ops:
        if any(e.time_range.start < w1 and e.time_range.end > w0
               for w0, w1 in wins):
            names[e.name] = names.get(e.name, 0) + (e.time_range.end
                                                    - e.time_range.start)
    return busy, names


@pytest.mark.parametrize("seed", range(6))
def test_window_reading_matches_a_plain_count(seed):
    rng = random.Random(seed)
    events, t = [], 0
    for _ in range(5):                   # windows with gaps between them
        w0 = t + rng.randint(1, 20)
        w1 = w0 + rng.randint(30, 80)
        events.append(_ev(trace.WINDOW, w0, w1, CPU))
        events.append(_ev("host_op", w0, w1, CPU))
        t = w1
    for k in range(60):
        a = rng.randint(0, t + 10)
        events.append(_ev(f"k{k % 7}", a, a + rng.randint(1, 12), CUDA))
    got = trace.window_reading(events)
    busy, names = _plain(events)
    assert got["busy_s"] == pytest.approx(busy / 1e6)
    wins = [e for e in events if e.name == trace.WINDOW]
    assert got["window_s"] == pytest.approx(
        sum(e.time_range.end - e.time_range.start for e in wins) / 1e6)
    want = sorted(([k, v / 1e6] for k, v in names.items()),
                  key=lambda kv: -kv[1])[:10]
    got_ops = dict(got["device_ops"])
    assert set(got_ops) == {k for k, _ in want}
    for k, v in want:
        assert got_ops[k] == pytest.approx(v)
    idle = (got["window_s"] - got["busy_s"])
    assert sum(g[1] for g in got["idle_gaps"]) <= idle + 1e-12
    assert all(g[0] in ("host_op", "no host op") for g in got["idle_gaps"])


def test_no_window_raises():
    with pytest.raises(RuntimeError):
        trace.window_reading([_ev("k", 0, 1, CUDA)])
