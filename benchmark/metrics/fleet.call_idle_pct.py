"""The share of the host-span pass's window in which no device operation
runs while the host is inside one of the program's gltpl.call.* spans
(copy-in, replay, clone-out), in percent (``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.value(ctx, "call_idle_pct")
