"""Device ms a fleet tick in the velocity stage and the emergency profile
(the SQP solve included), by the program's gltpl.* ranges on the eager
tick."""


def read(ctx):
    return _stage(ctx, "velocity")


def _stage(ctx, name):
    if ctx.get("kind") != "fleet":
        return None
    ms = ctx["stage_ms"].get(name)
    return ms if ms else None
