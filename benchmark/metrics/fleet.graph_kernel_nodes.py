"""Kernel nodes of the compiled fleet tick's untraced graph, the
program's counter read once at capture (``CapturedCall.kernel_nodes``,
``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.value(ctx, "kernel_nodes")
