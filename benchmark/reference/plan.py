"""The plain reference's replan of one scenario's full action set, written
from the planner's semantics, one scenario at a time, float64 NumPy (the
search sums the float32 costs its lattice keeps, in float32):

1. the obstacle: the nearest opponent ahead within the horizon, keyed on
   its last prediction point, and the node of its layer nearest to it;
2. four searches over the planning window from the start node, each a
   layer-by-layer shortest path (ties to the lower node): *straight* with
   every edge near an opponent removed, *follow* with none removed,
   *left* and *right* also kept on their side of the obstacle node at the
   obstacle's layer; the first three window edges of the previous
   solution get their cost discounted; each layer's goal cost is the
   node's distance from the raceline;
3. the action set (the upstream decision tree): which of straight,
   follow, left and right exist, their horizons and which search each
   walks;
4. each action's node chain as one C2 spline through its nodes (start and
   end headings clamped), sampled as densely as the lattice's edges,
   behind what is left of the committed path;
5. each action's speed profile by the forward-backward solver, the
   follow action's by the follow controller against the opponent's own
   braking run-out on the raceline (the ``fb`` backend; another backend's
   speed stage is a file of its own, :func:`speed_stage`);
6. the emergency profile: full braking along the base action.

Nothing here is taken from the planner's package; the lattice is the
reference's own (``benchmark/reference/lattice.py``).
"""

from __future__ import annotations

import importlib.util
import math
import os
import re

import numpy as np

from benchmark.reference import lattice as rl
from benchmark.reference import velocity as vel

STRAIGHT, FOLLOW, LEFT, RIGHT = 0, 1, 2, 3
C_ROWS = 64                  # rows kept for the committed path
N_LAST = 4                   # nodes of the previous solution's chain
OPP_ROWS = 128               # raceline points of an opponent's run-out
OPP_GG = 14.0
EMERG_DRAG, EMERG_MASS = 0.854, 1160.0
HERE = os.path.dirname(os.path.abspath(__file__))


def path_rows(lat: rl.RefLattice) -> int:
    """Rows of a planned path: H_max edges of S samples, in blocks of 64."""
    return int(math.ceil((lat.H_max * (lat.S - 1) + 1) / 64.0) * 64)


def _angle(a, b, c):
    """The angle at b from a to c, in (-pi, pi]."""
    x = math.atan2(c[1] - b[1], c[0] - b[0]) \
        - math.atan2(a[1] - b[1], a[0] - b[0])
    if x > math.pi:
        x -= 2 * math.pi
    elif x <= -math.pi:
        x += 2 * math.pi
    return x


def s_coord(line, pos, s_line, closed: bool):
    """Arc position of ``pos`` along the polyline ``line``: the nearest
    vertex, then the side whose neighbour subtends the larger angle at
    ``pos``, the foot of the perpendicular on that segment.  Returns (s,
    index of the segment's first vertex)."""
    n = len(line)
    d2 = ((line - pos) ** 2).sum(-1)
    j = int(np.argmin(d2))
    prv = (j - 1) % n if closed else max(j - 1, 0)
    nxt = (j + 1) % n if closed else min(j + 1, n - 1)
    a1 = abs(_angle(line[j], pos, line[prv]))
    a2 = abs(_angle(line[j], pos, line[nxt]))
    a, b = (prv, j) if a1 > a2 else (j, nxt)
    ab = line[b] - line[a]
    t = float(np.dot(pos - line[a], ab)) / max(float(np.dot(ab, ab)), 1e-12)
    foot = t * ab
    seg_a = prv if a1 >= a2 else j
    return s_line[a] + math.hypot(foot[0], foot[1]), seg_a


class Scenario:
    """One row of a scenario batch (numpy arrays of the batch's fields)."""

    def __init__(self, batch: dict, b: int):
        for k, v in batch.items():
            setattr(self, k, v[b])


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def obstacle(lat, sc):
    """(found, slot of the obstacle vehicle, its layer, its node)."""
    L = lat.L
    O = len(sc.obj_active)
    lay = np.array([int(np.argmin(((lat.refline - p) ** 2).sum(-1)))
                    for p in sc.obj_pos])
    h_goal = lat.h_goal[sc.start_layer]
    best, key = None, 0
    for o in range(O):
        if not sc.obj_active[o] or sc.obj_owner[o] < 0:
            continue
        if any(sc.obj_active[q] and sc.obj_owner[q] == sc.obj_owner[o]
               for q in range(o + 1, O)):
            continue                     # not the vehicle's last point
        ahead = (lay[o] - sc.start_layer) % L
        if ahead <= h_goal and (best is None or ahead < best):
            best, key = ahead, o
    found = best is not None
    owner = sc.obj_owner[key]
    first = [o for o in range(O) if sc.obj_active[o]
             and sc.obj_owner[o] == owner]
    idx = first[0] if first else 0
    layer = int(lay[key])
    d2 = ((lat.node_pos[layer] - sc.obj_pos[idx]) ** 2).sum(-1)
    node = int(np.argmin(np.where(lat.node_valid[layer], d2, np.inf)))
    return found, idx, layer, node, lay


def searches(lat, sc, lay, found, obs_layer, obs_node, w_last):
    """The four window searches: best costs (4, H+1, N) float32, back
    pointers (4, H+1, N) and goal costs (4, H+1, N) float32."""
    L, N, H = lat.L, lat.N, lat.H_max
    cfg = lat.cfg
    sl = int(sc.start_layer)
    h_goal = lat.h_goal[sl]
    inf = rl.UNREACHABLE
    p_obs = (obs_layer - sl) % L
    in_win = found and p_obs <= H
    left_side = np.arange(N) >= obs_node        # what left may not use
    # opponents that count, and the edges each blocks (its layer's and
    # the one before it)
    reach = (cfg.veh_width / 2.0)
    blocked = {}
    for o in range(len(sc.obj_active)):
        ahead = (lay[o] - sl) % L
        if not sc.obj_active[o] or not (ahead <= h_goal + 1
                                        or ahead >= L - 1):
            continue
        r2 = (float(sc.obj_radius[o]) + reach) ** 2 \
            + cfg.stepsize_approx ** 2 / 4.0
        for layer in ((lay[o] - 1) % L, lay[o]):
            d2 = ((lat.samples[layer] - sc.obj_pos[o]) ** 2).sum(-1)
            hit = d2.min(-1) <= r2
            blocked[layer] = blocked.get(layer, False) | hit
    best = np.full((4, H + 1, N), inf, np.float32)
    back = np.full((4, H + 1, N), -1, int)
    best[:, 0, sc.start_node] = 0.0
    for h in range(H):
        layer = (sl + h) % L
        w = lat.w[layer].copy()
        if h < N_LAST - 1:
            a, b = sc.last_nodes[h], sc.last_nodes[h + 1]
            if a >= 0 and b >= 0 and w[a, b] < rl.REACH_LIMIT:
                w[a, b] = np.float32(w[a, b] * np.float32(w_last[h]))
        w_clear = np.where(blocked.get(layer, False), inf, w)
        w_left, w_right = w_clear.copy(), w_clear.copy()
        if in_win and h == p_obs - 1:
            w_left[:, left_side] = inf
            w_right[:, ~left_side] = inf
        if in_win and h == p_obs:
            w_left[left_side, :] = inf
            w_right[~left_side, :] = inf
        for s, ws in enumerate((w_clear, w, w_left, w_right)):
            tot = np.minimum(best[s, h][:, None] + ws, inf)
            back[s, h + 1] = np.argmin(tot, axis=0)
            best[s, h + 1] = tot.min(axis=0)
    goal = np.repeat(lat.vg[(sl + np.arange(H + 1)) % L][None], 4, axis=0)
    if in_win:
        goal[LEFT, p_obs, left_side] = inf
        goal[RIGHT, p_obs, ~left_side] = inf
    return best, back, goal


def _horizon(ok, h_goal):
    """The largest horizon 1..h_goal at which the search reaches a goal."""
    hs = [h for h in range(1, h_goal + 1) if ok[h]]
    return hs[-1] if hs else 0


# ---------------------------------------------------------------------------
# the committed path and the action set
# ---------------------------------------------------------------------------

def vehicles(sc):
    """Slots that are a vehicle's own position (its first slot)."""
    out = []
    for o in range(len(sc.obj_active)):
        lead = o == 0 or sc.obj_owner[o] != sc.obj_owner[o - 1]
        out.append(bool(sc.obj_active[o] and sc.obj_owner[o] >= 0 and lead))
    return out


def committed(lat, sc):
    """(an opponent is beside the committed path, one is on it, the slot
    of the nearest beside it)."""
    have = sc.const_n >= 1
    s_rl = lat.s_rl
    s0, _ = s_coord(lat.raceline, sc.pos_est, s_rl, True)
    start = lat.node_pos[sc.start_layer, sc.start_node]
    s1, _ = s_coord(lat.raceline, start, s_rl, True)
    r2 = (sc.obj_radius + lat.cfg.veh_width / 2.0) ** 2
    lap = s_rl[-1]
    beside, on, near, near_d = False, False, 0, math.inf
    for o, is_veh in enumerate(vehicles(sc)):
        so, _ = s_coord(lat.raceline, sc.obj_pos[o], s_rl, True)
        inside = (s0 <= so <= s1) if s0 <= s1 else (so > s0 or so < s1)
        if not (inside and is_veh and have):
            continue
        beside = True
        pts = sc.const_path[:sc.const_n, 0:2]
        if (((pts - sc.obj_pos[o]) ** 2).sum(-1) <= r2[o]).any() \
                or ((start - sc.obj_pos[o]) ** 2).sum() <= r2[o]:
            on = True
        d = so + lap - s0 if so < s0 else so - s0
        if d < near_d:
            near, near_d = o, d
    return beside, on, near


def action_set(lat, sc, best, goal, found, obs_layer, beside, on):
    """The action set's decision tree: per output slot (straight, follow,
    left, right) whether it exists, its horizon, and which search it
    walks; and the case flags."""
    L = lat.L
    sl = int(sc.start_layer)
    h_goal = int(lat.h_goal[sl])
    reach = (best + goal).min(-1) < rl.REACH_LIMIT          # (4, H+1)
    case_a = beside or on
    case_b = not case_a and found
    case_c = not case_a and not found
    h_str = _horizon(reach[STRAIGHT], h_goal)
    h_fol = _horizon(reach[FOLLOW], h_goal)
    h_lr = h_fol                         # overtakes keep follow's horizon
    h_left = h_lr if h_lr >= 1 and reach[LEFT, h_lr] else 0
    h_right = h_lr if h_lr >= 1 and reach[RIGHT, h_lr] else 0
    h_extra = h_lr if h_lr >= 1 and reach[STRAIGHT, h_lr] else 0
    reduced = h_fol != h_goal
    obs_in = (obs_layer - sl) % L <= h_fol
    relabel = reduced and not on and found and not obs_in
    last = int(sc.last_action_lr)
    ongoing = case_a and not on and last in (LEFT, RIGHT)
    both = case_a and not on and not ongoing
    ok = [
        (case_c and h_str >= 1) or ((case_a or case_b) and relabel
                                    and h_fol >= 1),
        (case_a or case_b) and not relabel and h_fol >= 1,
        not relabel and ((case_b and h_left >= 1) or (both and h_extra >= 1)
                         or (ongoing and last == LEFT and h_extra >= 1)),
        not relabel and ((case_b and h_right >= 1)
                         or (both and h_extra >= 1)
                         or (ongoing and last == RIGHT and h_extra >= 1)),
    ]
    src = [FOLLOW if relabel else STRAIGHT, FOLLOW,
           STRAIGHT if case_a else LEFT, STRAIGHT if case_a else RIGHT]
    hz = [h_fol if relabel else h_str, h_fol,
          h_extra if case_a else h_left, h_extra if case_a else h_right]
    return dict(ok=ok, src=src, h=hz, case_a=case_a, case_c=case_c,
                relabel=relabel, h_goal=h_goal)


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

def chain(back, goal_node, h):
    nodes = [goal_node]
    for k in range(h, 0, -1):
        nodes.append(int(back[k, nodes[-1]]))
    return nodes[::-1]


def clamped_spline(pts, seg, psi0, psi1):
    """C2 cubic pieces through ``pts`` (k+1, 2), piece lengths ``seg``,
    the end tangents along ``psi0`` and ``psi1``: the inner tangents
    solve the continuity system densely."""
    k = len(seg)
    t0, t1 = rl.direction(psi0), rl.direction(psi1)
    tang = np.zeros((k + 1, 2))
    tang[0], tang[k] = t0, t1
    if k > 1:
        A = np.zeros((k - 1, k - 1))
        rhs = np.zeros((k - 1, 2))
        for j in range(1, k):
            lam = seg[j - 1] / seg[j]
            r = 3.0 * ((pts[j] - pts[j - 1]) / seg[j - 1]
                       + lam * (pts[j + 1] - pts[j]) / seg[j])
            A[j - 1, j - 1] = 2.0 * (1.0 + lam)
            if j > 1:
                A[j - 1, j - 2] = 1.0
            else:
                r = r - t0
            if j < k - 1:
                A[j - 1, j] = lam
            else:
                r = r - lam * t1
            rhs[j - 1] = r
        tang[1:k] = np.linalg.solve(A, rhs)
    return rl.from_tangents(pts, tang, seg)


def assemble(lat, sl, nodes, psi0, rows):
    """The path of a node chain: (rows, 5) [x y psi kappa el] and its
    real row count."""
    L = lat.L
    h = len(nodes) - 1
    pts = np.array([lat.node_pos[(sl + k) % L, nodes[k]]
                    for k in range(h + 1)])
    curves = [lat.edge_coeffs[(sl + k) % L, nodes[k], nodes[k + 1]]
              for k in range(h)]
    npts = [int(lat.edge_npts[(sl + k) % L, nodes[k], nodes[k + 1]])
            for k in range(h)]
    seg = np.array([max(lat.edge_len[(sl + k) % L, nodes[k], nodes[k + 1]],
                        1e-9) for k in range(h)])
    d_end, _ = rl.derivatives(curves[-1], 1.0)
    psi1 = rl.heading(d_end[0], d_end[1])
    pieces = clamped_spline(pts, seg, psi0, psi1)
    out = np.zeros((rows, 5))
    i = 0
    for k in range(h):
        u = np.arange(npts[k] - 1) / (npts[k] - 1)
        u2 = np.minimum((np.arange(npts[k] - 1) + 1) / (npts[k] - 1), 1.0)
        p = rl.evaluate(pieces[k], u)
        d, dd = rl.derivatives(pieces[k], u)
        e = rl.evaluate(curves[k], u2) - rl.evaluate(curves[k], u)
        sl_ = slice(i, i + npts[k] - 1)
        out[sl_, 0:2] = p
        out[sl_, 2] = rl.heading(d[:, 0], d[:, 1])
        out[sl_, 3] = rl.curvature(d, dd)
        out[sl_, 4] = np.hypot(e[:, 0], e[:, 1])
        i += npts[k] - 1
    d, dd = rl.derivatives(pieces[-1], 1.0)
    out[i:] = [*rl.evaluate(pieces[-1], 1.0), rl.heading(d[0], d[1]),
               rl.curvature(d, dd), 0.0]
    return out, i + 1


def splice(sc, path, n_real, total):
    """The rest of the committed path, then the planned one; rows past the
    end repeat the last real row, with no element length from it on."""
    keep = int(sc.const_n - sc.cut_idx)
    out = np.zeros((total, 5))
    out[:keep] = sc.const_path[sc.cut_idx:sc.cut_idx + keep]
    m = min(len(path), total - keep)
    out[keep:keep + m] = path[:m]
    n = n_real + keep
    out[n:] = out[n - 1]
    out[n - 1:, 4] = 0.0
    return out, n


# ---------------------------------------------------------------------------
# speeds
# ---------------------------------------------------------------------------

def opponent_runout(lat, pos, v_obj, car_opp):
    """Each opponent's braking from its raceline point (``pos`` (B, 2),
    ``v_obj`` (B,)): its stop distance, and the raceline speeds and
    cumulative distances ahead of it (B, OPP_ROWS)."""
    F = len(lat.glob)
    start = np.array([s_coord(lat.glob[:, 1:3], p, lat.glob[:, 0], True)[1]
                      for p in pos]) % (F - 1)
    idx = (start[:, None] + np.arange(OPP_ROWS)) % (F - 1)
    k, v_rl, el = lat.glob[idx, 3], lat.glob[idx, 4], lat.glob_el[idx]
    v = vel.brake(car_opp, np.abs(k), el, np.minimum(v_obj, v_rl[:, 0]))
    return vel.stop_distance(v, el), v_rl, np.cumsum(el, -1)


def _first(mask, default):
    """Index of the first True along the last axis, ``default`` where
    there is none."""
    return np.where(mask.any(-1), np.argmax(mask, -1), default)


def _at(x, i):
    return np.take_along_axis(x, np.asarray(i)[..., None], -1)[..., 0]


def speeds(tp, car, paths, n_real, b, red, v_end_rl, obj_dist, v_obj,
           opp_stop, opp_v, opp_cum):
    """The four actions' speed profiles of every scenario: ``paths`` (B, 4,
    P, 5) spliced, ``n_real``, ``red``, ``v_end_rl`` (B, 4), the follow
    target's distance and speed (B,) and run-out; ``b`` the scenarios'
    fields.  Returns s, vx, ax (B, 4, P) and whether each action keeps to
    its speed bound (B, 4)."""
    B, _, P, _ = paths.shape
    idx = np.arange(P)
    vmax = tp["vel_max"]
    c_len = b["c_len"].astype(int)
    v_plan = b["vel_plan"].astype(float)
    kap = np.abs(paths[..., 3])
    el = paths[..., 4]
    # braking into the speed limit when above it
    over = v_plan > vmax + 0.1
    pref = np.repeat(c_len[:, None], 4, 1)
    v_start = np.repeat(v_plan[:, None], 4, 1)
    el_p = np.where(idx < c_len[:, None, None], 0.0, el)
    v_decel = vel.brake(car, kap.reshape(-1, P), el_p.reshape(-1, P),
                        v_start.reshape(-1)).reshape(B, 4, P)
    first = _first(v_decel <= vmax, P - 1)
    pref = np.where(over[:, None], np.maximum(first, pref), pref)
    v_start = np.where(over[:, None], _at(v_decel, pref), v_start)
    pre = idx < pref[..., None]
    k_m = np.where(pre, 0.0, kap)
    el_m = np.where(pre, 0.0, el)
    zero = np.zeros((B, 4, 1))
    s_path = np.concatenate([zero, np.cumsum(el[..., :-1], -1)], -1)
    # where each profile ends: its real end, or 5 m short of it on a
    # reduced horizon
    last = np.maximum(n_real - 1, 0)
    short = np.cumsum(el[..., :-1], -1) < (_at(s_path, last) - 5.0)[..., None]
    j = np.argmin(short, -1) + 1
    j = np.where((j == 1) & (n_real > 1), n_real, j)
    v_idx = np.where(red, j, n_real)
    v_end = np.where(red, 0.0, v_end_rl)
    tail = idx >= v_idx[..., None] - 1
    el_n = np.where(tail, 0.0, el_m)
    v_lat = np.sqrt(car.ay / np.maximum(k_m, 1e-9))
    cap_n = np.minimum(v_lat, vmax)
    cap_n = np.where(tail, np.minimum(cap_n, v_end[..., None]), cap_n)

    def fb(k, e, cap, v0):
        """Forward then backward over rows of any leading shape."""
        sh = k.shape
        k, e, cap = (x.reshape(-1, P) for x in (k, e, cap))
        return vel.backward(car, k, e, vel.forward(
            car, k, e, cap, np.reshape(v0, -1))).reshape(sh)
    v_norm = fb(k_m, el_n, cap_n, v_start)
    v_norm = np.where(idx >= v_idx[..., None], 0.0, v_norm)
    degen = (v_idx - pref) <= 1
    v_norm = np.where(degen[..., None], 0.0, v_norm)
    bound = (np.abs(_at(v_norm, pref) - v_start) < tp["v_max_offset"]) \
        & ~degen

    # follow: brake to the controller's speed, hold it, stop short of
    # where the opponent's run-out ends
    F = FOLLOW
    kf, ef, vsf = k_m[:, F], el_m[:, F], v_start[:, F]
    safety = tp["safety_d"] + tp["veh_length"]
    ctrl_d = tp["c_p"] * tp["safety_d"] + tp["veh_length"]
    s_f = np.concatenate([np.zeros((B, 1)), np.cumsum(ef[:, :-1], -1)], -1)
    s_stop = obj_dist - safety + opp_stop
    stop = np.minimum((s_f < s_stop[:, None]).sum(-1), P - 1)
    travel = _at(s_path[:, F], last[:, F]) - _at(s_path[:, F], pref[:, F])
    gone = opp_stop - (s_stop - travel)
    run_i = np.minimum((opp_cum < gone[:, None]).sum(-1) + 1, OPP_ROWS - 1)
    v_run = np.where(gone <= 0.0, opp_v[:, 0], _at(opp_v, run_i))
    v_end_f = np.where(s_stop > s_f[:, -1], v_run, 0.0)
    v_ctrl = v_obj - tp["k_p"] * (ctrl_d - obj_dist) \
        + tp["k_d"] * (v_obj - b["vel_est"].astype(float))
    v_ctrl = np.minimum(np.maximum(v_ctrl, 0.0), vmax)
    v_brk = vel.brake(car, kf, ef, vsf)
    v_un = fb(kf, ef, np.minimum(v_lat[:, F], vmax), vsf)
    seg1 = (vsf > v_ctrl) & (stop >= 2)
    j = _first(v_brk <= v_ctrl[:, None], stop)
    i_c = np.where(seg1, np.minimum(np.where(j == 0, stop, j), stop), 0)
    v_c0 = np.where(seg1, _at(v_brk, i_c), vsf)
    e2 = np.where((idx < stop[:, None]) & (idx >= i_c[:, None]), ef, 0.0)
    cap_s = np.minimum(v_lat[:, F], v_ctrl[:, None])
    cap_s = np.where(idx >= stop[:, None],
                     np.minimum(cap_s, v_end_f[:, None]), cap_s)
    v2 = fb(kf, e2, cap_s, np.minimum(v_c0, v_ctrl))
    ok_f = (np.abs(_at(v2, i_c) - v_c0) <= 1.0) & ~(~seg1 & (stop < 2))
    v_f = np.where(idx < i_c[:, None], v_brk, v2)
    v_f = np.where(idx > stop[:, None], 0.0, v_f)
    ok_f &= np.abs(v_f[:, 0] - vsf) <= 1.0
    no_hold = vel.stop_distance(v_brk, ef) >= s_stop   # cannot stop short
    v_f = np.where(no_hold[:, None], v_brk, v_f)
    ok_f |= no_hold
    v_f = np.minimum(v_f, v_un)
    v_f = np.where(red[:, F, None], np.minimum(v_f, v_norm[:, F]), v_f)

    vx = v_norm.copy()
    vx[:, F] = v_f
    bound[:, F] = ok_f
    vx = np.where(pre, v_decel, vx)
    course = np.pad(b["vel_course"],
                    ((0, 0), (0, P - b["vel_course"].shape[1])))
    vx = np.where(idx < c_len[:, None, None], course[:, None], vx)
    ax = vel.accelerations(vx, el)
    still = (np.abs(vx[..., :-1]) <= 1e-8) & (np.abs(ax) <= 1e-8) \
        & (idx[:-1] < n_real[..., None] - 1)
    ax = np.where(still, -5.0, ax)
    ax = np.concatenate([ax, np.zeros((B, 4, 1))], -1)
    return s_path, vx, ax, bound


def emergency(traj, car_em):
    """Full braking from each action's first speed along its path:
    ``traj`` (R, P, 7)."""
    el = np.concatenate([np.diff(traj[..., 0], axis=-1),
                         np.zeros((len(traj), 1))], -1)
    v = vel.brake(car_em, np.abs(traj[..., 4]), el, traj[:, 0, 5])
    ax = np.concatenate([vel.accelerations(v, el),
                         np.zeros((len(traj), 1))], -1)
    return np.concatenate([traj[..., 0:5], v[..., None], ax[..., None]], -1)


def speed_stage(backend: str):
    """The speed stage of the velocity backend ``backend`` (the upstream
    ``vp_type``): :func:`speeds` for ``fb``; for any other the ``speeds``
    of ``vp_<backend>.py`` beside this file, loaded by its path, which
    takes :func:`speeds`' arguments and returns what it returns, and
    takes besides, as keywords, the tick inputs that the traffic carries
    from each scenario's previous tick (``sqp_x0``: numpy, a row a
    scenario).  A backend without its file raises FileNotFoundError,
    naming the file to add."""
    if backend == "fb":
        return speeds
    if not re.fullmatch(r"[A-Za-z0-9_]{1,64}", str(backend)):
        raise ValueError(f"velocity backend {backend!r}: not a name")
    path = os.path.join(HERE, f"vp_{backend}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"the velocity backend {backend!r} has no plain reference: add "
            f"benchmark/reference/vp_{backend}.py, whose speeds() takes "
            "plan.speeds' arguments and the carried inputs as keywords")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.reference._vp_{backend}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.speeds


# ---------------------------------------------------------------------------
# the whole replan
# ---------------------------------------------------------------------------

def replan(lat: rl.RefLattice, batch: dict, tp: dict,
           over: dict = None) -> dict:
    """The full action set of every scenario of ``batch`` (numpy fields as
    the traffic generator makes them); ``tp`` the tick's parameters, whose
    ``vp_backend`` picks the speed stage (:func:`speed_stage`); ``over``
    the tick inputs carried into these scenarios (numpy, a row a
    scenario), handed to that stage.  Returns the planner's outputs as
    numpy arrays: trajs (B, 5, P, 7) [s x y psi kappa vx ax], valid, cost,
    h_eff, n_valid (B, 5), case_a, relabel, em_base (B,)."""
    stage = speed_stage(tp["vp_backend"])
    B = len(batch["start_layer"])
    rows = path_rows(lat)
    P = C_ROWS + rows
    car = vel.Car(tp["gg"][0], tp["gg"][1], tp["machines"],
                  tp["drag_coeff"], tp["m_veh"], tp["dyn_model_exp"])
    car_opp = vel.Car(OPP_GG, OPP_GG, [[0, 1], [1, 1]], tp["drag_coeff"],
                      tp["m_veh"], tp["dyn_model_exp"])
    car_em = vel.Car(tp["gg"][0], tp["gg"][1], [[0, 1], [1, 1]],
                     EMERG_DRAG, EMERG_MASS, 1.0)
    out = dict(trajs=np.zeros((B, 5, P, 7)), valid=np.zeros((B, 5), bool),
               cost=np.zeros((B, 5), np.float32),
               h_eff=np.zeros((B, 5), int), n_valid=np.zeros((B, 5), int),
               case_a=np.zeros(B, bool), relabel=np.zeros(B, bool),
               em_base=np.zeros(B, int))
    L = lat.L
    paths = np.zeros((B, 4, P, 5))
    n_real = np.zeros((B, 4), int)
    red = np.zeros((B, 4), bool)
    v_end_rl = np.zeros((B, 4))
    cost = np.zeros((B, 4), np.float32)
    ok = np.zeros((B, 4), bool)
    obj_dist, v_o, pos_o = np.zeros(B), np.zeros(B), np.zeros((B, 2))
    for b in range(B):
        sc = Scenario(batch, b)
        sl = int(sc.start_layer)
        found, obs_idx, obs_layer, obs_node, lay = obstacle(lat, sc)
        best, back, goal = searches(lat, sc, lay, found, obs_layer, obs_node,
                                    tp["w_last_factors"])
        beside, on, near = committed(lat, sc)
        act = action_set(lat, sc, best, goal, found, obs_layer, beside, on)
        for j in range(4):
            s, h = act["src"][j], max(act["h"][j], 1)
            tot = best[s, h] + goal[s, h]
            g = int(np.argmin(tot))
            cost[b, j] = tot[g]
            nodes = chain(back[s], g, h)
            rl_start = sc.start_node == lat.rl_idx[sl] \
                and nodes[1] == lat.rl_idx[(sl + 1) % L]
            if sc.warm:
                psi0 = float(sc.psi_start)
            elif rl_start:
                d = lat.rl_coeffs[sl, 1]
                psi0 = math.atan2(d[1], d[0]) - math.pi / 2
            else:
                psi0 = lat.node_psi[sl, sc.start_node]
            path, n = assemble(lat, sl, nodes, psi0, rows)
            paths[b, j], n_real[b, j] = splice(sc, path, n, P)
            end_layer = (sl + h) % L
            v_rl = lat.vel_rl[end_layer]
            off = abs(nodes[-1] - lat.rl_idx[end_layer]) * lat.cfg.lat_offset
            v_end_rl[b, j] = v_rl - min(v_rl * lat.cfg.vel_decrease_lat * off,
                                        v_rl)
            red[b, j] = act["h"][j] != act["h_goal"]
        target = near if beside else obs_idx
        pos_o[b], v_o[b] = sc.obj_pos[target], float(sc.obj_vel[target])
        pf = paths[b, FOLLOW]
        s_f = np.concatenate([[0.0], np.cumsum(pf[:-1, 4])])
        if found or beside:
            obj_dist[b] = s_coord(pf[:, 0:2], pos_o[b], s_f, False)[0] \
                - s_coord(pf[:, 0:2], sc.pos_cut, s_f, False)[0]
        ok[b] = act["ok"]
        em = 0 if (act["case_c"] or act["relabel"]) else 1
        out["h_eff"][b] = np.append(act["h"], act["h"][em])
        out["case_a"][b] = act["case_a"]
        out["relabel"][b] = act["relabel"]
        out["em_base"][b] = em
    opp_stop, opp_v, opp_cum = opponent_runout(lat, pos_o, v_o, car_opp)
    s_path, vx, ax, bound = stage(tp, car, paths, n_real, batch, red,
                                  v_end_rl, obj_dist, v_o, opp_stop, opp_v,
                                  opp_cum, **(over or {}))
    ok &= bound | (np.arange(4) < 2)
    t4 = np.concatenate([s_path[..., None], paths[..., 0:4], vx[..., None],
                         ax[..., None]], -1)
    r = np.arange(B)
    em = out["em_base"]
    out["trajs"][:, :4] = t4
    out["trajs"][:, 4] = emergency(t4[r, em], car_em)
    out["valid"] = np.concatenate([ok, ok[r, em][:, None]], 1)
    out["cost"] = np.concatenate([cost, cost[r, em][:, None]], 1)
    out["n_valid"] = np.concatenate([n_real, n_real[r, em][:, None]], 1)
    return out
