"""The fleet mixes' one generator: a batch of planning scenarios from a
seed and a traffic file's parameters, on the host, from the reference's
lattice (``benchmark/reference/lattice.py``).

The ego starts on the raceline node of a random layer at ``vel`` (with
``short_horizon_starts`` only of a layer whose planning horizon is
shorter than the lattice's longest); each of ``n_objects`` opponents
stands on a random node 5 to 14 layers ahead, moved by up to
``jitter_m`` in x and in y as a perception reading would be, at 0.4 to
0.6 times ``vel``, with ``n_pred`` prediction points 0.2 s apart along
its heading, in ``o_pad`` slots. ``steady_state`` gives each scenario
the state a running planner carries: the committed path is the last real
samples (at most ``S // 2``) of the raceline edge into the start node,
driven at ``vel``, and the previous solution's chain follows the
raceline. The arithmetic is the program's
``parallel/scenario.random_scenarios``, frozen here, with two changes:
the committed path takes the edge's real samples only (the program's
took the padding past a short edge's end, a path of one point repeated,
the ego on its start node), and the jitter: an opponent exactly on a
node lies on the normal through a raceline point, where its projection
onto the raceline ties between two segments and float rounding alone
decides.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.plan import C_ROWS, N_LAST

FIELDS = ("start_layer", "start_node", "vel_plan", "vel_est", "obj_pos",
          "obj_radius", "obj_vel", "obj_active", "obj_owner", "pos_est",
          "pos_cut", "const_path", "const_n", "cut_idx", "warm",
          "psi_start", "vel_course", "c_len", "last_nodes",
          "last_action_lr")


def batch(lat, mix: dict, seed) -> dict:
    """One batch of ``mix["batch"]`` scenarios (numpy arrays by field)."""
    rng = np.random.default_rng(seed)
    B, O, n_obj, n_pred = (mix["batch"], mix["o_pad"], mix["n_objects"],
                           mix["n_pred"])
    v_ego = float(mix["vel"])
    jit = float(mix["jitter_m"])
    L = lat.L
    rl = lat.rl_idx
    node_pos = lat.node_pos.astype(np.float32)
    node_psi = lat.node_psi.astype(np.float32)
    layers = np.arange(L)
    if mix.get("short_horizon_starts", False):
        layers = layers[lat.h_goal < lat.H_max]
    start_layer = layers[rng.integers(0, len(layers), B)].astype(np.int32)
    start_node = rl[start_layer].astype(np.int32)
    obj_pos = np.zeros((B, O, 2), np.float32)
    obj_rad = np.zeros((B, O), np.float32)
    obj_vel = np.zeros((B, O), np.float32)
    obj_act = np.zeros((B, O), bool)
    obj_owner = np.full((B, O), -1, np.int32)
    for b in range(B):
        k = 0
        for i in range(n_obj):
            if k >= O:
                break
            la = int((start_layer[b] + rng.integers(5, 15)) % L)
            nn = int(rng.integers(0, lat.nodes_in_layer[la]))
            v = v_ego * float(rng.uniform(0.4, 0.6))
            psi = float(node_psi[la, nn])
            obj_pos[b, k] = node_pos[la, nn] + rng.uniform(-jit, jit, 2)
            obj_rad[b, k], obj_vel[b, k] = 2.5, v
            obj_act[b, k], obj_owner[b, k] = True, i
            k += 1
            for j in range(n_pred):
                if k >= O:
                    break
                obj_pos[b, k] = obj_pos[b, k - 1 - j] + np.array(
                    [-np.sin(psi), np.cos(psi)]) * v * 0.2 * (j + 1)
                obj_rad[b, k], obj_vel[b, k] = 2.5, v
                obj_act[b, k], obj_owner[b, k] = True, i
                k += 1
    pos_est = node_pos[start_layer, start_node].copy()
    const_path = np.zeros((B, C_ROWS, 5), np.float32)
    const_n = np.zeros(B, np.int32)
    vel_course = np.zeros((B, C_ROWS), np.float32)
    last_nodes = np.full((B, N_LAST), -1, np.int32)
    psi_start = node_psi[start_layer, start_node].copy()
    if mix["steady_state"]:
        samples = lat.samples.astype(np.float32)
        S = lat.S
        n_c = min(C_ROWS, max(2, S // 2))
        for b in range(B):
            pl = int((start_layer[b] - 1) % L)
            n_e = int(lat.edge_npts[pl, rl[pl], start_node[b]])
            seg = samples[pl, rl[pl], start_node[b]][max(n_e - n_c, 0):n_e]
            d = np.diff(seg, axis=0)
            n = len(seg) - 1
            const_path[b, :n, 0:2] = seg[:-1]
            const_path[b, :n, 2] = np.arctan2(d[:, 1], d[:, 0]) - np.pi / 2.0
            const_path[b, :n, 4] = np.hypot(d[:, 0], d[:, 1])
            const_n[b] = n
            pos_est[b] = seg[0]
            vel_course[b, :n] = v_ego
            last_nodes[b] = rl[(start_layer[b] + np.arange(N_LAST)) % L]
    return dict(
        start_layer=start_layer, start_node=start_node,
        vel_plan=np.full(B, v_ego, np.float32),
        vel_est=np.full(B, v_ego, np.float32), obj_pos=obj_pos,
        obj_radius=obj_rad, obj_vel=obj_vel, obj_active=obj_act,
        obj_owner=obj_owner, pos_est=pos_est, pos_cut=pos_est.copy(),
        const_path=const_path, const_n=const_n,
        cut_idx=np.zeros(B, np.int32), warm=const_n > 0,
        psi_start=psi_start, vel_course=vel_course, c_len=const_n.copy(),
        last_nodes=last_nodes,
        last_action_lr=np.full(B, -1, np.int32))


def rows(b: dict, idx) -> dict:
    return {k: v[idx] for k, v in b.items()}


def concat(parts) -> dict:
    return {k: np.concatenate([p[k] for p in parts]) for k in FIELDS}
