"""The share of its roofline that the ADMM kernel reaches in the compiled
SQP fleet tick: the least time for the work of one tick's calls (counted
from their shapes, ``benchmark/kernels/admm_vel.py``) over the kernel's
device time a tick in the traced window of compiled ticks, in percent."""

from benchmark import work


def read(ctx):
    if ctx.get("kind") != "fleet":
        return None
    return work.roofline_pct(ctx, "admm_vel")
