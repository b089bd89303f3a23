"""Vehicle-dynamics-info import — the port's own copy of the JAX package's
``utils/veh_dyn.py``, the equivalent of ``tph.import_veh_dyn_info`` used by
the reference workflow (docs/source/software/content/inputs.rst:41-55): load the
``ax_max_machines.csv`` machine-acceleration-limit table (and optionally a
``ggv.csv`` friction diagram) that callers hand to
``GraphLTPL.calc_vel_profile``.

File format (comma separated, ``#`` comment/header lines):

* ``ax_max_machines.csv`` — rows ``v_mps, ax_max_machines_mps2``; velocities
  strictly increasing from 0; linear interpolation between rows (consumed in
  ``ops/velocity.calc_vel_profile_fb``).
* ``ggv.csv`` — rows ``v_mps, ax_max_mps2, ay_max_mps2``.
"""

from __future__ import annotations

import numpy as np


def _load_table(path: str, n_cols: int, name: str) -> np.ndarray:
    arr = np.loadtxt(path, comments="#", delimiter=",", ndmin=2,
                     dtype=np.float64)
    if arr.shape[1] != n_cols:
        raise RuntimeError(f"{name} file must provide {n_cols} columns, "
                           f"got {arr.shape[1]} ({path})!")
    v = arr[:, 0]
    if v[0] < 0.0 or (arr.shape[0] > 1 and np.any(np.diff(v) <= 0.0)):
        raise RuntimeError(f"{name} velocity column must be non-negative and "
                           f"strictly increasing ({path})!")
    if np.any(arr[:, 1:] < 0.0):
        raise RuntimeError(f"{name} acceleration limits must be "
                           f"non-negative ({path})!")
    return arr


def import_veh_dyn_info(ggv_import_path: str = None,
                        ax_max_machines_import_path: str = None):
    """Return ``(ggv, ax_max_machines)`` — either may be None when the
    corresponding path is not given (mirrors the tph call used in the
    reference docs, inputs.rst:47-52)."""
    ggv = None
    ax_max_machines = None
    if ggv_import_path is not None:
        ggv = _load_table(ggv_import_path, 3, "ggv")
    if ax_max_machines_import_path is not None:
        ax_max_machines = _load_table(ax_max_machines_import_path, 2,
                                      "ax_max_machines")
    return ggv, ax_max_machines
