"""The share of the traced window of compiled fleet ticks in which no
device operation runs, in percent."""


def read(ctx):
    if ctx.get("kind") != "fleet":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
