"""Device ms a fleet tick in the search stage (obstacle selection, slab
hit masks, window DP), by the program's gltpl.* ranges on the eager tick."""


def read(ctx):
    return _stage(ctx, "window")


def _stage(ctx, name):
    if ctx.get("kind") != "fleet":
        return None
    ms = ctx["stage_ms"].get(name)
    return ms if ms else None
