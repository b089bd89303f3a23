"""Device ms a compiled SQP fleet tick inside the QP set-up and the ADMM
(``gltpl.qp_setup`` and ``gltpl.qp_iters``, nested in
``gltpl.velocity``), read from the program's own timing events inside
the traced graph (median over the ticks of ``benchmark/range_trace.py``'s
pass)."""

from benchmark import range_trace


def read(ctx):
    return range_trace.ranges_ms(ctx, ("gltpl.qp_setup", "gltpl.qp_iters"))
