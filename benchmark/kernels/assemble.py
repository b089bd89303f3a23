"""The path assembly (kernel-table row 8):
``ops/cuda_assemble.assemble_path``, kernel ``assemble_kernel`` of
``csrc/assemble.cu``.  A call reads the packed edge table's rows it
gathers, H+1 rows of the table's width a path row, and ``win_layers``,
``nodes``, ``h_eff`` and ``psi_s`` once, and writes ``path``,
``n_valid``, ``node_idx`` and ``coeffs`` once: 41.3 MB at 4,096 rows x
384 points with int64 indices, 35.5 MB of it the outputs.

Operations: the resampling's a path point, as the plain version writes
them (``assemble_path_plain``): the segment parameters t and t2 (8), the
refit's position (12), first (12) and second (8) derivatives, the heading
(1), the curvature (9) and the stored edge's element length (30).  The
refit's per-edge solve, under a tenth more, is left out: the count is
low, never high, and the bytes bound the call either way."""

from benchmark.work import bound_args, nbytes

MODULE = "cuda_assemble"
ATTR = "assemble_path"
PATTERN = "assemble_kernel"
ARGS = ("packed", "win_layers", "nodes", "h_eff", "psi_s", "p_max")
POINT_OPS = 80


def count(args, kwargs, out):
    a = bound_args(ARGS, args, kwargs)
    packed, nodes = a["packed"], a["nodes"]
    R, Hp1 = nodes.shape
    rows = R * Hp1 * packed.shape[-1] * packed.element_size()
    nb = rows + nbytes(a["win_layers"], nodes, a["h_eff"], a["psi_s"],
                       out["path"], out["n_valid"], out["node_idx"],
                       out["coeffs"])
    return nb, R * out["path"].shape[1] * POINT_OPS
