"""Device ms a compiled fleet tick in the search stage, read from the
program's own timing events inside the traced graph: the outermost
gltpl.* ranges of obstacle selection and the window (median of the stage
pass, ``benchmark/program_trace.py``)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.stage(ctx, "window")
