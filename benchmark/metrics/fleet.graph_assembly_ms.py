"""Device ms a compiled fleet tick in the walk, the C2-refit assembly and
the const-path splice, read from the program's own timing events inside
the traced graph (median of the stage pass,
``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage(ctx, "assembly")
