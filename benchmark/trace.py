"""Readings from a ``torch.profiler`` trace of the program: device time by
the program's ``gltpl.*`` ranges (a frozen copy of the grouping and the
attribution rule of the program's ``parallel/profiling.py``), device time
by kernel name, the device's busy time in a window, and the breakdown
that the result line carries.
"""

from __future__ import annotations

import bisect
import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the program's ranges and the fleet stage each belongs to; the SQP
# solve's ranges (nested inside ``gltpl.velocity``) count as velocity
SCOPE_TO_STAGE = {
    "gltpl.object_selection": "window",
    "gltpl.plan_window": "window",
    "gltpl.hit_slab": "window",
    "gltpl.window_dp": "window",
    "gltpl.const_path_objects": "window",
    "gltpl.backtrace": "assembly",
    "gltpl.assemble": "assembly",
    "gltpl.const_splice": "assembly",
    "gltpl.velocity": "velocity",
    "gltpl.emergency": "velocity",
    "gltpl.qp_setup": "velocity",
    "gltpl.qp_factor": "velocity",
    "gltpl.qp_iters": "velocity",
}
WINDOW = "bench.window"


def _is_range(e) -> bool:
    return e.name.startswith("gltpl.")


def _is_annotation(e) -> bool:
    """A span the profiler draws on the device for a host annotation (a
    range, its step marker, the benchmark's window), not device work."""
    return (_is_range(e) or e.name.startswith("ProfilerStep")
            or e.name.startswith("bench."))


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def device_ops(events):
    """The device operations of a trace: kernels, copies and fills."""
    return [e for e in events if _is_device(e) and not _is_annotation(e)]


def _owner(p) -> str:
    while p is not None:
        if _is_range(p):
            return p.name
        p = p.cpu_parent
    return "other"


def stage_ms(events, iters: int) -> dict:
    """Device ms a tick by stage: each device operation goes to the
    innermost ``gltpl.*`` range around the host call that launched it
    (matched by correlation id), ``other`` where none."""
    launch_of = {}
    for e in events:
        if not _is_device(e) and e.name.startswith("cu"):
            launch_of.setdefault(e.id, e)
    out = {}
    for e in device_ops(events):
        st = SCOPE_TO_STAGE.get(_owner(launch_of.get(e.id)), "other")
        out[st] = out.get(st, 0.0) + (e.time_range.end
                                      - e.time_range.start) / 1e3 / iters
    return out


def kernel_ms(events, iters: int) -> dict:
    """Device ms a tick by operation name."""
    out = {}
    for e in device_ops(events):
        out[e.name] = out.get(e.name, 0.0) + (e.time_range.end
                                              - e.time_range.start) / 1e3
    return {k: v / iters for k, v in out.items()}


def _union(intervals):
    """Merged, sorted intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def window_reading(events, top: int = 10) -> dict:
    """Busy and window seconds of the trace's ``bench.window`` spans (the
    host's), the device operations that took most time in them and the
    longest device-idle gaps, each named by the innermost host operation
    running at the gap's middle."""
    wins = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == WINDOW and not _is_device(e))
    if not wins:
        raise RuntimeError("the trace holds no bench.window span")
    ops = device_ops(events)
    host = [e for e in events if not _is_device(e) and e.name != WINDOW]
    merged = _union((e.time_range.start, e.time_range.end) for e in ops)
    starts = [a for a, _ in merged]
    busy, gaps, by_name = 0.0, [], {}
    for w0, w1 in wins:
        i, cur = max(bisect.bisect_right(starts, w0) - 1, 0), w0
        while i < len(merged) and merged[i][0] < w1:
            a, b = max(merged[i][0], w0), min(merged[i][1], w1)
            if b > a:
                if a > cur:
                    gaps.append((cur, a))
                busy += b - a
                cur = max(cur, b)
            i += 1
        if w1 > cur:
            gaps.append((cur, w1))
    w_starts = [w0 for w0, _ in wins]
    for e in ops:
        # the last window that starts before the operation ends overlaps
        # it if any does (the windows are disjoint and sorted)
        j = bisect.bisect_left(w_starts, e.time_range.end) - 1
        if j >= 0 and wins[j][1] > e.time_range.start:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e6
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        name = min(inner, key=lambda e: e.time_range.end
                   - e.time_range.start).name if inner else "no host op"
        idle.append([name, (b - a) / 1e6])
    window = sum(w1 - w0 for w0, w1 in wins) / 1e6
    return dict(
        busy_s=busy / 1e6, window_s=window,
        device_ops=sorted(([k, v] for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:top],
        idle_gaps=idle)


@contextlib.contextmanager
def traced():
    """A profiler over the CPU and the card; the caller marks each window
    with ``record_function(WINDOW)``.  The trace is read after the block
    (``prof.events()``)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def window_span():
    return record_function(WINDOW)


def require_device_time(events) -> None:
    if not device_ops(events):
        raise RuntimeError("the profiler traced no device operation")


def sync() -> None:
    torch.cuda.synchronize()
