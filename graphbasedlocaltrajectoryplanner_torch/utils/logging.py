"""Iterative CSV data logger — equivalent of the reference's
``helper_funcs/src/Logging.py`` (semicolon-separated ``*_data.csv`` with
JSON-encoded per-field payloads, consumed by the replay tool).  The port's
own copy of the JAX package's ``utils/logging.py``."""

from __future__ import annotations

import json

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    """JSON encoder handling numpy arrays/scalars (Logging.py:129-135)."""

    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer, np.bool_)):
            return obj.item()
        return json.JSONEncoder.default(self, obj)


HEADER_FIELDS = ["time", "s_coord", "start_node", "obj_veh", "obj_zone",
                 "nodes_list", "s_list", "pos_list", "vel_list", "a_list",
                 "psi_list", "kappa_list", "traj_id", "clip_pos",
                 "action_id_prev", "traj_id_prev", "const_path_seg"]


class DataLogger:
    """Per-tick structured planner log (Logging.py:5-126)."""

    def __init__(self, graph_id: str, log_path: str):
        self._path = log_path
        self._zone_timestamps = {}
        with open(log_path, "w") as fh:
            fh.write("# graph_id: %s\n" % graph_id)
            fh.write(";".join(HEADER_FIELDS) + "\n")

    def log_onlinegraph(self, time_stamp, s_coord, start_node, obj_veh,
                        obj_zone, nodes_list, s_list, pos_list, vel_list,
                        a_list, psi_list, kappa_list, traj_id, clip_pos,
                        action_id_prev, traj_id_prev, const_path_seg):
        obj_dump = [dict(id=o.id, pos=list(map(float, o.pos)), psi=o.psi,
                         radius=o.radius, vel=o.vel,
                         prediction=o.prediction) for o in obj_veh]
        # zones logged only when updated (dedup via timestamp, Logging.py:88-98)
        zone_dump = {}
        for z in obj_zone:
            key = z.id
            stamp = self._zone_timestamps.get(key)
            if stamp is None:
                self._zone_timestamps[key] = time_stamp
                blocked = z.get_blocked_nodes()
                bl, br = z.get_bound_coords()
                zone_dump[key] = [list(map(int, blocked[0])),
                                  list(map(int, blocked[1])),
                                  np.asarray(bl), np.asarray(br)]
        row = [time_stamp, s_coord, start_node, obj_dump, zone_dump,
               nodes_list, s_list, pos_list, vel_list, a_list, psi_list,
               kappa_list, traj_id, clip_pos, action_id_prev, traj_id_prev,
               const_path_seg]
        with open(self._path, "a") as fh:
            fh.write(";".join(json.dumps(v, cls=NumpyEncoder) for v in row)
                     + "\n")


def read_data_log(path: str):
    """Parse a ``*_data.csv`` back into a list of dict rows (replay)."""
    rows = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    fields = None
    for ln in lines:
        if ln.startswith("#"):
            continue
        if fields is None:
            fields = ln.split(";")
            continue
        parts = ln.split(";")
        # JSON payloads contain no bare semicolons outside strings in our
        # writer (each field is one dumps() output) — but nested strings may;
        # re-join defensively by parsing incrementally
        vals = []
        buf = ""
        for p in parts:
            buf = p if not buf else buf + ";" + p
            try:
                vals.append(json.loads(buf))
                buf = ""
            except json.JSONDecodeError:
                continue
        rows.append(dict(zip(fields, vals)))
    return rows
