"""Host ms a compiled fleet tick spends in the program's
gltpl.call.replay span (the graph's launch), the median over the
host-span pass's window (``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.value(ctx, "replay_host_ms")
