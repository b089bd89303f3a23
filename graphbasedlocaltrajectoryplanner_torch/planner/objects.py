"""Object-list and zone interface — host-side equivalent of the reference's
``data_objects/ObjectListInterface.py`` (VehObject / ZoneObject /
process_object_list / update_zone) plus the zone -> node-mask resolution
(``online_graph/src/get_zone_nodes.py``).

Vehicles and zones arrive from perception / race control at tick rate; this
module normalizes them into fixed-size arrays (padded object slots, an
(L, N) zone node mask) consumed by the planning kernels.  The port's own copy
of the JAX package's ``planner/objects.py``; lattice fields are tensors here
and are read on the host through :func:`_np`.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.planner import hostmath

LOG = logging.getLogger("local_trajectory_logger")

KNOWN_OBJ_TYPES = ("physical",)
TIME_WARNING = 0.5

def _np(x):
    """A lattice field as a host NumPy array (tensors from any device)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


# zone handling constants (gen_local_node_template.py:9-10)
UNBLOCK_N_LAYERS_WHEN_IN_ZONE = 4
BLOCK_N_LAYERS_WHEN_REMOVING_ZONE = 0


class VehObject:
    """Vehicle object (ObjectListInterface.py:240-295)."""

    def __init__(self, id_in, pos_in, psi_in, radius_in, vel_in=None,
                 prediction_in=None):
        self.id = id_in
        self.pos = np.asarray(pos_in, float)
        self.psi = float(psi_in)
        self.radius = float(radius_in)
        self.vel = float(vel_in) if vel_in is not None else 0.0
        self.prediction = (np.asarray(prediction_in, float).reshape(-1, 2)
                           if prediction_in is not None else np.zeros((0, 2)))

    # reference-compatible accessors
    def get_pos(self):
        return self.pos

    def get_psi(self):
        return self.psi

    def get_radius(self):
        return self.radius

    def get_vel(self):
        return self.vel

    def get_prediction(self):
        return self.prediction


class ZoneObject:
    """Blocked-zone object (ObjectListInterface.py:298-391)."""

    def __init__(self, id_in, ref_pos_in=None, norm_vec_in=None,
                 bound_l_in=None, bound_r_in=None,
                 blocked_layer_ids_in=None, blocked_node_ids_in=None,
                 bound_l_coord_in=None, bound_r_coord_in=None):
        self.id = id_in
        self.processed = False
        self.disabled = False
        self.fixed = False
        self._ref_pos = ref_pos_in
        self._norm_vec = norm_vec_in
        self._bound_l = bound_l_in
        self._bound_r = bound_r_in
        self._blocked_layer_ids = blocked_layer_ids_in
        self._blocked_node_ids = blocked_node_ids_in
        if ref_pos_in is not None and norm_vec_in is not None \
                and bound_l_in is not None and bound_r_in is not None:
            self._bound_l_coord = ref_pos_in + norm_vec_in * np.expand_dims(bound_l_in, 1)
            self._bound_r_coord = ref_pos_in + norm_vec_in * np.expand_dims(bound_r_in, 1)
        elif blocked_layer_ids_in is not None and blocked_node_ids_in is not None \
                and bound_l_coord_in is not None and bound_r_coord_in is not None:
            self._bound_l_coord = bound_l_coord_in
            self._bound_r_coord = bound_r_coord_in
        else:
            raise ValueError("No matching set of initialization variables!")

    def get_blocked_nodes(self, lattice=None):
        if self._blocked_layer_ids is None and lattice is not None:
            layer_ids, node_ids, succ = get_zone_nodes(
                lattice, self._ref_pos, self._norm_vec,
                self._bound_l, self._bound_r)
            if not succ:
                LOG.critical("Provided zone object '%s' does not share ANY "
                             "common normal vectors with the lattice! "
                             "Zone ignored!", self.id)
                raise ValueError("Provided zone object is not supported!")
            self._blocked_layer_ids, self._blocked_node_ids = layer_ids, node_ids
        return self._blocked_layer_ids, self._blocked_node_ids

    def update_blocked_nodes(self, layer_ids, node_ids):
        self._blocked_layer_ids = layer_ids
        self._blocked_node_ids = node_ids

    def get_bound_coords(self):
        return self._bound_l_coord, self._bound_r_coord

    def update_bound_coords(self, bound_l_coord, bound_r_coord):
        self._bound_l_coord = bound_l_coord
        self._bound_r_coord = bound_r_coord

    def set_processed(self):
        self.processed = True

    def set_disabled(self):
        self.disabled = True

    def set_fixed(self):
        self.fixed = True


def get_zone_nodes(lat, ref_pos, norm_vec, bound_l, bound_r,
                   obstacle_width: float = 0.0,
                   dist2_threshold: float = 0.1):
    """Match zone normal vectors against the lattice layers and convert the
    lateral bounds into blocked node index ranges
    (get_zone_nodes.py:38-80)."""
    refline = _np(lat.refline)
    normvec = _np(lat.normvec)
    alpha = _np(lat.alpha)
    rl_idx = _np(lat.rl_idx)
    nodes_in_layer = _np(lat.nodes_in_layer)

    infl = max(lat.veh_width / 2.0, obstacle_width / 2.0) + lat.lat_resolution / 2.0
    if bound_l[0] > bound_r[0]:
        bound_s_l = bound_l + infl
        bound_s_r = bound_r - infl
    else:
        bound_s_l = bound_l - infl
        bound_s_r = bound_r + infl

    layer_ids, node_ids = [], []
    any_match = False
    for i in range(np.size(ref_pos, axis=0)):
        d2 = np.sum((refline - ref_pos[i]) ** 2, axis=1)
        li = int(np.argmin(d2))
        if d2[li] < dist2_threshold and np.allclose(norm_vec[i], normvec[li],
                                                    atol=0.01):
            any_match = True
            steps_l = (bound_s_l[i] - alpha[li]) / lat.lat_resolution
            steps_r = (bound_s_r[i] - alpha[li]) / lat.lat_resolution
            l_idx = min(max(rl_idx[li] + int(np.ceil(steps_l)), 0),
                        int(nodes_in_layer[li]))
            r_idx = min(max(rl_idx[li] + int(np.ceil(steps_r)), 0),
                        int(nodes_in_layer[li]))
            local_nodes = list(range(min(l_idx, r_idx), max(l_idx, r_idx)))
            layer_ids.extend([li] * len(local_nodes))
            node_ids.extend(local_nodes)
    return layer_ids, node_ids, any_match


class ObjectListInterface:
    """Normalizes incoming object lists (ObjectListInterface.py:15-237)."""

    def __init__(self):
        self._vehicles = []
        self._zones = []
        self._bound1 = None
        self._bound2 = None
        self._last_timestamp = 0.0

    def set_track_data(self, refline, normvec_normalized, w_left, w_right):
        refline = np.asarray(refline)
        normvec = np.asarray(normvec_normalized)
        self._bound1 = refline + normvec * np.expand_dims(np.asarray(w_right), 1)
        self._bound2 = refline - normvec * np.expand_dims(np.asarray(w_left), 1)

    def process_object_list(self, object_list):
        if object_list is not None:
            self._last_timestamp = _time.time()
            new_vehicles = []
            for el in object_list:
                if el.get("type") not in KNOWN_OBJ_TYPES:
                    LOG.warning("Found non-supported object of type '%s' in "
                                "object list!", el.get("type"))
                    continue
                on_track = True
                if self._bound1 is not None:
                    on_track = hostmath.check_inside_bounds(
                        self._bound1, self._bound2, [el["X"], el["Y"]])
                if not on_track:
                    continue
                if "prediction" in el:
                    pred = np.asarray(el["prediction"], float)
                else:
                    # default 200 ms constant-velocity prediction
                    # (ObjectListInterface.py:117-127; heading 0 = north)
                    dt = 0.2
                    pred = np.array([[el["X"] - np.sin(el["theta"]) * el["v"] * dt,
                                      el["Y"] + np.cos(el["theta"]) * el["v"] * dt]])
                new_vehicles.append(VehObject(
                    id_in=el["id"], pos_in=[el["X"], el["Y"]],
                    psi_in=el["theta"], radius_in=el["length"] / 2.0,
                    vel_in=el["v"], prediction_in=pred))
            self._vehicles = new_vehicles
        else:
            if _time.time() - self._last_timestamp > TIME_WARNING:
                time_str = ("so far" if self._last_timestamp == 0.0 else
                            "in the last %.2fs" % (_time.time() - self._last_timestamp))
                LOG.warning("Did not receive an object list %s! Check coms!",
                            time_str)
        return self._vehicles

    def update_zone(self, zone_id, zone_data, zone_type="normals"):
        new_zones = []
        last_ids = [z.id for z in self._zones]
        if zone_id is not None:
            if zone_id in last_ids:
                i = last_ids.index(zone_id)
                new_zones.append(self._zones[i])
                last_ids[i] = None
            else:
                if zone_type == "normals":
                    info = np.reshape(zone_data, (-1, 6))
                    z = ZoneObject(zone_id, ref_pos_in=info[:, 0:2],
                                   norm_vec_in=info[:, 2:4],
                                   bound_l_in=info[:, 4], bound_r_in=info[:, 5])
                elif zone_type == "nodes":
                    z = ZoneObject(zone_id,
                                   blocked_layer_ids_in=zone_data[0],
                                   blocked_node_ids_in=zone_data[1],
                                   bound_l_coord_in=zone_data[2],
                                   bound_r_coord_in=zone_data[3])
                else:
                    raise ValueError(f"Type specifier {zone_type!r} is not "
                                     "supported!")
                new_zones.append(z)
                LOG.info("Received new zone object with ID %s!", zone_id)
        for zid in last_ids:
            if zid is not None:
                i = last_ids.index(zid)
                if self._zones[i].get_blocked_nodes()[0]:
                    self._zones[i].set_disabled()
                    self._zones[i].id = self._zones[i].id + "rmv"
                    new_zones.append(self._zones[i])
        self._zones = new_zones
        return self._zones


def zones_to_node_mask(zones, lat, start_layer: int) -> np.ndarray:
    """Resolve zone objects into the (L, N) blocked-node mask, applying the
    unblock-ahead-of-ego / retain-on-removal logic
    (gen_local_node_template.py:43-99)."""
    L, N = lat.L, lat.N
    mask = np.zeros((L, N), bool)
    for zone in zones:
        layer_ids, node_ids = zone.get_blocked_nodes(lattice=lat)
        layer_ids = list(layer_ids)
        node_ids = list(node_ids)
        if not zone.processed or zone.disabled:
            n = (UNBLOCK_N_LAYERS_WHEN_IN_ZONE if not zone.processed
                 else BLOCK_N_LAYERS_WHEN_REMOVING_ZONE)
            la = np.asarray(layer_ids)
            if (start_layer + n) <= L:
                u_l = (la >= start_layer) & (la < start_layer + n)
            else:
                u_l = ((la >= start_layer) & (la < L)) | \
                      ((la >= 0) & (la < ((start_layer + n) % (L - 1) - 1)))
            if not zone.processed:
                if u_l.any() and not zone.fixed:
                    LOG.critical("Vehicle within provided zone, unblock active!")
                    keep = ~u_l
                    layer_ids = list(la[keep])
                    node_ids = list(np.asarray(node_ids)[keep])
                zone.set_processed()
            if zone.disabled:
                if u_l.any():
                    layer_ids = list(la[u_l])
                    node_ids = list(np.asarray(node_ids)[u_l])
                else:
                    layer_ids, node_ids = [], []
                zone.update_blocked_nodes(layer_ids, node_ids)
                zone.update_bound_coords([0.0, 0.0], [0.0, 0.0])
        for l, nn in zip(layer_ids, node_ids):
            if 0 <= nn < N:
                mask[int(l), int(nn)] = True
    return mask


def vehicles_to_arrays(vehicles, o_pad: int):
    """Pack vehicles + their prediction points into padded arrays.

    :returns: (pos (O, 2), radius (O,), active (O,), owner (O,) int32 — index
              of the owning vehicle for prediction slots, -1 for empty)."""
    pos = np.zeros((o_pad, 2), np.float32)
    rad = np.zeros((o_pad,), np.float32)
    act = np.zeros((o_pad,), bool)
    owner = np.full((o_pad,), -1, np.int32)
    k = 0
    for i, v in enumerate(vehicles):
        if k >= o_pad:
            LOG.warning("Object list truncated to %d collision slots", o_pad)
            break
        pos[k] = v.pos
        rad[k] = v.radius
        act[k] = True
        owner[k] = i
        k += 1
        for p in v.prediction:
            if k >= o_pad:
                break
            pos[k] = p
            rad[k] = v.radius
            act[k] = True
            owner[k] = i
            k += 1
    return pos, rad, act, owner
