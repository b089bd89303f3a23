"""Seeded calls of the path assembly (``ops/cuda_assemble``) at the shapes
and horizons the fleet tick's calls do not all reach, for the CPU tests
and the card's checks.

A case is one call ``(packed, win_layers, nodes, h_eff, psi_s, p_max)`` on
a lattice: ``rows`` node chains, four a scenario, each a random walk over
the window's layers (a lateral step of -2 .. 2 nodes a layer, -1 past its
horizon, as the backtrace leaves it), from a start layer whose window
stays on the track (unclosed tracks) and a start heading near the start
node's.  The horizon is 1 (``"one"``), about half of H (``"mid"``), H_max
(``"full"``: the full-horizon refit, PERF.md §7.1) or drawn from 1 .. H
row by row (``"mixed"``); ``p_max`` is the tick's default plus
``p_extra``; ``shared`` gives ``win_layers`` one row a scenario, read by
its four rows, else one row a row.
"""

from __future__ import annotations

import numpy as np
import torch

H_MODES = ("one", "mid", "full", "mixed")


def case(lat, packed, rows: int, h_mode: str, p_extra: int = 0,
         shared: bool = False, seed: int = 0, index_dtype=torch.int64):
    """One seeded call on ``lat`` (see the module docstring); ``packed``
    is ``pathgen.packed_edge_table(lat)``, the tensors go to its device.
    Returns the arguments of ``cuda_assemble.assemble_path``."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    if rows % 4:
        raise ValueError(f"rows: expected a multiple of 4, got {rows}")
    rng = np.random.default_rng(seed)
    L, N, H = lat.L, lat.N, lat.H_max
    scen = rows // 4
    last = L if lat.closed else L - H - 1
    sl = rng.integers(0, last, scen)
    win = (sl[:, None] + np.arange(H + 1)) % L                    # (S, H+1)
    if h_mode == "one":
        h = np.ones(rows, np.int64)
    elif h_mode == "mid":
        h = np.clip(H // 2 + rng.integers(-1, 2, rows), 1, H)
    elif h_mode == "full":
        h = np.full(rows, H, np.int64)
    elif h_mode == "mixed":
        h = rng.integers(1, H + 1, rows)
    else:
        raise ValueError(f"h_mode: one of {H_MODES}, got {h_mode!r}")
    nodes = np.empty((rows, H + 1), np.int64)
    nodes[:, 0] = rng.integers(0, N, rows)
    steps = rng.integers(-2, 3, (rows, H))
    for j in range(H):
        nodes[:, j + 1] = np.clip(nodes[:, j] + steps[:, j], 0, N - 1)
    nodes[np.arange(H + 1)[None, :] > h[:, None]] = -1
    node_psi = lat.node_psi.cpu().numpy()
    psi = node_psi[np.repeat(sl, 4), nodes[:, 0]] \
        + rng.normal(0.0, 0.05, rows)
    dev = packed.device
    win_rows = win if shared else np.repeat(win, 4, axis=0)
    return [packed,
            torch.as_tensor(win_rows, dtype=index_dtype, device=dev),
            torch.as_tensor(nodes, dtype=index_dtype, device=dev),
            torch.as_tensor(h, dtype=index_dtype, device=dev),
            torch.as_tensor(psi.astype(np.float32), device=dev),
            sc.default_p_max(lat) + p_extra]
