"""Device ms a fleet tick in the walk, the C2-refit assembly and the
const-path splice, by the program's gltpl.* ranges on the eager tick."""


def read(ctx):
    return _stage(ctx, "assembly")


def _stage(ctx, name):
    if ctx.get("kind") != "fleet":
        return None
    ms = ctx["stage_ms"].get(name)
    return ms if ms else None
