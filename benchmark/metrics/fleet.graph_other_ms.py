"""Device ms of a compiled fleet tick's graph outside every gltpl.*
range: the report's graph_ms less its outermost ranges (median of the
stage pass, ``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage(ctx, "other")
