"""Device ms a compiled SQP fleet tick in the planner's seam around the
QPs: the m-point windows, the follow cap and the QPs stacked
(``gltpl.sqp_window``), and the status hand-off, the profiles placed back
and the warm-start store (``gltpl.sqp_handoff``), both nested in
``gltpl.velocity``; read as ``sqp.graph_qp_ms`` is.  A program without
these spans gives no reading."""

from benchmark import range_trace


def read(ctx):
    return range_trace.ranges_ms(ctx, ("gltpl.sqp_window",
                                       "gltpl.sqp_handoff"))
