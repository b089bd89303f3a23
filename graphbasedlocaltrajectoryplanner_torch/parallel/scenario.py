"""Batched scenario planning engine — the fleet tick (torch) and the port's
main path; counterpart of the JAX package's ``parallel/scenario.py``.

One scenario = (ego start node + velocity, opponent configuration, the
warm-start state of the previous tick).  ``make_batched_tick`` returns one
function that replans the full action set of a whole batch: obstacle
selection, slab hit masks, the masked 4-slot window DP, horizon selection
and the action-set decision tree, the backpointer walk, C2-refit path
assembly, the constant-path splice, the velocity stage (``fb`` or ``sqp``)
and the emergency brake profile — every stage on tensors with a leading
scenario dimension, the kernels of ``ops/cuda_*.py`` on the card.
``make_sharded_tick`` runs the same tick over a mesh of ranks
(``parallel/distributed.py``), optionally with the window DP split over a
mesh axis (``parallel/spatial.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.distributed import ReduceOp

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models.lattice import Lattice
from graphbasedlocaltrajectoryplanner_torch.ops import collision as col
from graphbasedlocaltrajectoryplanner_torch.ops import dynshift
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_backtrace
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_projection
from graphbasedlocaltrajectoryplanner_torch.parallel import spatial
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as vp

# padded collision slots (vehicles + their prediction points), the
# handler's capacity
O_PAD = 16
# constant-path-segment pad length
C_PAD = 64
# w_last_edges window chain length (3 factors + terminal node)
N_LAST = 4
# output action slots (emergency appended to the 4 search slots)
N_OUT = 5
# the previous-solution discount of w_last_edges (the reference's default)
W_LAST_FACTORS = (0.0, 0.5, 0.8)


@dataclasses.dataclass
class Scenario:
    """Per-scenario planning inputs, each tensor with a leading batch
    dimension B (fields as in the JAX package's ``Scenario``).

    ``const_path`` is the exclusive prefix of the previously planned path up
    to the plan start node, ``cut_idx`` the position-cut row within it,
    ``warm`` flags that a previous solution exists, ``last_nodes`` is the
    previous solution's window node chain for the ``w_last_edges``
    discount and ``last_action_lr`` the previous overtake action (-1 none).
    """
    start_layer: torch.Tensor     # (B,) int32
    start_node: torch.Tensor      # (B,) int32
    vel_plan: torch.Tensor        # (B,) f32
    vel_est: torch.Tensor         # (B,) f32
    obj_pos: torch.Tensor         # (B, O, 2)
    obj_radius: torch.Tensor      # (B, O)
    obj_vel: torch.Tensor         # (B, O)
    obj_active: torch.Tensor      # (B, O) bool
    obj_owner: torch.Tensor       # (B, O) int32 owning vehicle (-1 empty)
    pos_est: torch.Tensor         # (B, 2) ego position seen by planning
    pos_cut: torch.Tensor         # (B, 2) ego position at the velocity cut
    const_path: torch.Tensor      # (B, C_PAD, 5) [x y psi kappa el]
    const_n: torch.Tensor         # (B,) int32 valid const rows
    cut_idx: torch.Tensor         # (B,) int32 position-cut row
    warm: torch.Tensor            # (B,) bool
    psi_start: torch.Tensor       # (B,) f32 previous heading at the start
    vel_course: torch.Tensor      # (B, C_PAD) committed delay-comp course
    c_len: torch.Tensor           # (B,) int32 true vel_course length
    last_nodes: torch.Tensor      # (B, N_LAST) int32 (-1 pad)
    last_action_lr: torch.Tensor  # (B,) int32

    def to(self, device=None) -> "Scenario":
        dev = resolve_device(device)
        return Scenario(**{f.name: getattr(self, f.name).to(dev)
                           for f in dataclasses.fields(self)})


def scenario_from_numpy(arrays: dict, device=None) -> Scenario:
    """A :class:`Scenario` from numpy arrays of its fields (e.g. of the JAX
    package's batched ``Scenario``), dtypes kept."""
    dev = resolve_device(device)
    return Scenario(**{f.name: torch.from_numpy(
        np.array(arrays[f.name], copy=True)).to(dev)
        for f in dataclasses.fields(Scenario)})


def random_scenarios(lat: Lattice, batch: int, seed: int = 0,
                     n_objects: int = 1, vel: float = 30.0,
                     steady_state: bool = True, o_pad: int = None,
                     n_pred: int = 1, device=None) -> Scenario:
    """A batch of scenarios: ego on random raceline layers, opponents on
    random on-track nodes ahead, each with ``n_pred`` constant-velocity
    prediction points.  The same numpy generator code as the JAX package,
    so one seed gives bit-identical scenarios there and here.

    ``steady_state=True`` fills the warm-start state as a running planner
    would (const-path prefix = tail of the raceline edge into the start
    node, previous-solution chain on the raceline).

    :param o_pad: collision-slot capacity; None sizes it to the slots the
        batch needs (min 4), :data:`O_PAD` gives the handler's capacity.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if o_pad is None:
        need = max(1, n_objects) * (1 + n_pred)
        o_pad = max(4, -(-need // 4) * 4)
    L = lat.L
    rl = lat.rl_idx.cpu().numpy()
    node_pos = lat.node_pos.cpu().numpy()
    node_psi = lat.node_psi.cpu().numpy()
    nil = lat.nodes_in_layer.cpu().numpy()

    start_layer = rng.integers(0, L, batch).astype(np.int32)
    start_node = rl[start_layer].astype(np.int32)
    obj_pos = np.zeros((batch, o_pad, 2), np.float32)
    obj_rad = np.zeros((batch, o_pad), np.float32)
    obj_vel = np.zeros((batch, o_pad), np.float32)
    obj_act = np.zeros((batch, o_pad), bool)
    obj_owner = np.full((batch, o_pad), -1, np.int32)
    for b in range(batch):
        k = 0
        for i in range(n_objects):
            if k >= o_pad:
                break
            la = int((start_layer[b] + rng.integers(5, 15)) % L)
            nn = int(rng.integers(0, nil[la]))
            v = vel * float(rng.uniform(0.4, 0.6))
            psi = float(node_psi[la, nn])
            obj_pos[b, k] = node_pos[la, nn]
            obj_rad[b, k] = 2.5
            obj_vel[b, k] = v
            obj_act[b, k] = True
            obj_owner[b, k] = i
            k += 1
            for j in range(n_pred):
                if k >= o_pad:
                    break
                dt = 0.2 * (j + 1)
                obj_pos[b, k] = (obj_pos[b, k - 1 - j]
                                 + np.array([-np.sin(psi), np.cos(psi)])
                                 * v * dt)
                obj_rad[b, k] = 2.5
                obj_vel[b, k] = v
                obj_act[b, k] = True
                obj_owner[b, k] = i
                k += 1
    pos_est = node_pos[start_layer, start_node].astype(np.float32)
    const_path = np.zeros((batch, C_PAD, 5), np.float32)
    const_n = np.zeros(batch, np.int32)
    psi_start = np.zeros(batch, np.float32)
    vel_course = np.zeros((batch, C_PAD), np.float32)
    c_len = np.zeros(batch, np.int32)
    last_nodes = np.full((batch, N_LAST), -1, np.int32)
    last_lr = np.full(batch, -1, np.int32)
    psi_start[:] = node_psi[start_layer, start_node]
    if steady_state:
        samples = lat.samples_xy.cpu().numpy()
        S = lat.S
        prev_layer = (start_layer - 1) % L
        n_const = min(C_PAD, max(2, S // 2))
        for b in range(batch):
            pl_, sn = int(prev_layer[b]), int(start_node[b])
            pn = int(rl[pl_])
            pts = samples[pl_, pn, sn]
            seg = pts[S - n_const:]
            el = np.hypot(*(np.diff(seg, axis=0).T))
            const_path[b, :n_const - 1, 0:2] = seg[:-1]
            d = np.diff(seg, axis=0)
            const_path[b, :n_const - 1, 2] = \
                np.arctan2(d[:, 1], d[:, 0]) - np.pi / 2.0
            const_path[b, :n_const - 1, 4] = el
            const_n[b] = n_const - 1
            pos_est[b] = seg[0]
            vel_course[b, :n_const - 1] = vel
            c_len[b] = n_const - 1
            for i in range(N_LAST):
                last_nodes[b, i] = rl[(start_layer[b] + i) % L]
    return scenario_from_numpy(dict(
        start_layer=start_layer, start_node=start_node,
        vel_plan=np.full((batch,), vel, np.float32),
        vel_est=np.full((batch,), vel, np.float32),
        obj_pos=obj_pos, obj_radius=obj_rad, obj_vel=obj_vel,
        obj_active=obj_act, obj_owner=obj_owner, pos_est=pos_est,
        pos_cut=pos_est, const_path=const_path, const_n=const_n,
        cut_idx=np.zeros(batch, np.int32), warm=const_n > 0,
        psi_start=psi_start, vel_course=vel_course, c_len=c_len,
        last_nodes=last_nodes, last_action_lr=last_lr), dev)


def vehicle_slots(obj_active, obj_owner):
    """Mask of slots that are a vehicle position (not a prediction point):
    the first active slot of each owner."""
    lead = torch.cat([torch.ones_like(obj_owner[..., :1], dtype=torch.bool),
                      obj_owner[..., 1:] != obj_owner[..., :-1]], dim=-1)
    return obj_active & (obj_owner >= 0) & lead


def _select_obstacle(lat: Lattice, scen: Scenario):
    """Closest object -> obstacle node, per scenario: each vehicle's layer
    is keyed on its last prediction point, the closest vehicle by forward
    layer distance wins (first on ties), and the obstacle node is the node
    nearest the vehicle position within that layer."""
    B, O = scen.obj_owner.shape
    dev = lat.device
    sl = torch.arange(O, device=dev)
    owner = scen.obj_owner.long()
    act = scen.obj_active
    start = scen.start_layer.long()
    obj_layer = col.object_layers(lat.refline, scen.obj_pos)       # (B, O)
    h_goal = lat.h_goal_for_start[start].long()
    fwd = col.layer_dist_mod(start[:, None], obj_layer, lat.L)
    later_same = (owner[:, None, :] == owner[:, :, None]) \
        & (sl[None, :] > sl[:, None]) & act[:, None, :]
    is_key = act & (owner >= 0) & ~torch.any(later_same, dim=2)
    ok = is_key & (fwd <= h_goal[:, None])
    key_slot = torch.argmin(torch.where(ok, fwd, lat.L + 1), dim=1)
    obs_found = torch.any(ok, dim=1)
    key_owner = torch.gather(owner, 1, key_slot[:, None])
    first = (owner == key_owner) & act
    obs_idx = torch.argmax(first.to(torch.int32), dim=1)
    obs_layer = torch.gather(obj_layer, 1, key_slot[:, None])[:, 0]
    npos = lat.node_pos[obs_layer]                                  # (B,N,2)
    opos = torch.gather(scen.obj_pos, 1,
                        obs_idx[:, None, None].expand(B, 1, 2))
    d2 = torch.sum((npos - opos) ** 2, dim=-1)
    d2 = torch.where(lat.node_valid[obs_layer], d2, math.inf)
    obs_node = torch.argmin(d2, dim=1)
    return dict(obs_idx=obs_idx, obs_layer=obs_layer, obs_node=obs_node,
                obs_found=obs_found)


def _batched_window(lat: Lattice, scen: Scenario, zone_block,
                    w_last_factors, kernels: bool = True):
    """Obstacle selection, slab hit masks, the window DP and the per-slot
    virtual-goal vectors for the whole batch."""
    with cuda_graph.span("gltpl.object_selection"):
        obs = _select_obstacle(lat, scen)
    with cuda_graph.span("gltpl.plan_window"):
        window = pg.plan_window_kernel(
            lat, scen.start_layer, scen.start_node, zone_block, scen.obj_pos,
            scen.obj_radius, scen.obj_active, obs["obs_layer"],
            obs["obs_node"], obs["obs_found"], scen.last_nodes,
            w_last_factors, kernels=kernels)
    return obs, window


def default_machines(device) -> torch.Tensor:
    """The default machine limit ``[[0, 5], [100, 5]]`` ([v, ax] rows),
    built on ``device`` without a copy from the host."""
    return cuda_graph.const_vector([0.0, 5.0, 100.0, 5.0], torch.float32,
                                   device).reshape(2, 2)


def default_p_max(lat: Lattice) -> int:
    """Path rows for H_max edges of S samples, padded to a multiple of 64."""
    return int(np.ceil((lat.H_max * (lat.S - 1) + 1) / 64.0) * 64)


def scenario_tick(lat: Lattice, scen: Scenario,
                  vel_max: float = 70.0,
                  gg_lim=(10.0, 10.0),
                  safety_d: float = 30.0,
                  machines=None,
                  p_max: int = None,
                  dyn_model_exp: float = 1.0,
                  drag_coeff: float = 0.85,
                  m_veh: float = 1000.0,
                  zone_block=None,
                  w_last_factors=None,
                  incl_emergency: bool = True,
                  precomputed: dict = None,
                  until: str = None,
                  vp_backend: str = "fb",
                  filt_window: int = 1,
                  sqp_x0: torch.Tensor = None,
                  tire_end_idx: int = 0,
                  tire_end_mps2: float = 5.0,
                  sqp_m: int = None,
                  sqp_step: float = 2.5,
                  kernels: bool = True,
                  packed: torch.Tensor = None):
    """One full action-set replan per scenario of the batch: obstacle
    selection and the window DP, the action-set decision tree, backtrace,
    assembly, const-path splice, the velocity stage and the emergency
    profile.  Options as the JAX package's ``scenario_tick``.

    :param zone_block: ``(L, N)`` shared or ``(B, L, N)`` per-scenario zone
        mask (default none); ``w_last_factors`` the previous-solution
        discount (default the reference's ``[0, 0.5, 0.8]``).
    :param precomputed: ``dict(obs=..., window=...)``, the obstacle
        selection and window DP of :func:`_batched_window`; None computes
        them here.
    :param p_max: path rows per action (default :func:`default_p_max`);
        every output of length ``C_PAD + p_max`` follows it.
    :param incl_emergency: append the emergency slot (False: 4 slots, no
        emergency profile).
    :param until: staging cutoff of the stage profiler
        (``parallel/profiling.py``): ``"decide"`` returns ``dict(src,
        h_eff, valid)`` (B, 4) right after the decision tree,
        ``"assembly"`` returns ``dict(paths, n_valid, cost, h_eff,
        valid)`` right after the const-path splice; None runs the full
        tick.
    :param vp_backend: the velocity backend, ``"fb"`` or ``"sqp"`` (the
        reference's ``vp_type``; ``velplan.velocity_stage_scenario``).
    :param filt_window: odd moving-average window of the fb velocity
        smoothing (ignored under ``sqp``, as in the reference).
    :param sqp_x0: (B, 4, C_PAD + p_max) SQP warm-start profiles (None:
        the reference's cold 20 m/s fill); ``tire_end_idx``,
        ``tire_end_mps2``, ``sqp_m`` (the export points) and ``sqp_step``
        (the spline step) are the SQP planner's window parameters.
    :param packed: :func:`pathgen.packed_edge_table` of ``lat`` (built here
        when None).

    Output slots: [straight, follow, left, right, emergency].  Returns
    dict(trajs (B, 5, C_PAD + p_max, 7), valid (B, 5), cost (B, 5),
    h_eff (B, 5), n_valid (B, 5), case_a, relabel, em_base (B,)); under
    ``sqp`` also qp_status (B, 4) int32 and vx_sqp (B, 4, C_PAD + p_max),
    the raw profiles for the next tick's warm start.
    """
    dev = lat.device

    def f32(x):
        return cuda_graph.as_tensor(x, torch.float32, dev)
    if machines is None:
        machines = default_machines(dev)
    if p_max is None:
        p_max = default_p_max(lat)
    project = (cuda_projection.get_s_coords if kernels
               else cuda_projection.get_s_coords_plain)
    if precomputed is None:
        if zone_block is None:
            zone_block = torch.zeros((lat.L, lat.N), dtype=torch.bool,
                                     device=dev)
        if w_last_factors is None:
            w_last_factors = cuda_graph.const_vector(
                W_LAST_FACTORS, torch.float32, dev)
        obs, out = _batched_window(lat, scen, zone_block, w_last_factors,
                                   kernels=kernels)
    else:
        obs, out = precomputed["obs"], precomputed["window"]
    if packed is None:
        packed = pg.packed_edge_table(lat)
    L, N, H = lat.L, lat.N, lat.H_max
    B = scen.start_layer.shape[0]
    rows = torch.arange(B, device=dev)
    start_layer = scen.start_layer.long()
    start_node = scen.start_node.long()
    obs_idx, obs_found = obs["obs_idx"], obs["obs_found"]
    h_goal = out["h_goal"].long()

    # ---- object vs constant path segment -----------------------------------
    with cuda_graph.span("gltpl.const_path_objects"):
        # const_path is the exclusive prefix; the reference's ">= 2 rows" check
        # is const_n >= 1 here
        have_const = scen.const_n >= 1
        # the ego position, the start node and every object slot on the
        # raceline, s_objs (B, O) (one launch with the kernels)
        start_pos = lat.node_pos[start_layer, start_node]           # (B, 2)
        (s_start, _), (s_end, _), (s_objs, _) = project(
            lat.raceline, (scen.pos_est, start_pos, scen.obj_pos), lat.s_rl,
            closed=True)
        s_start_, s_end_ = s_start[:, None], s_end[:, None]
        in_seg = torch.where(s_start_ <= s_end_,
                             (s_objs >= s_start_) & (s_objs <= s_end_),
                             (s_objs > s_start_) | (s_objs < s_end_))
        in_seg = in_seg & vehicle_slots(scen.obj_active, scen.obj_owner) \
            & have_const[:, None]
        obj_besides = torch.any(in_seg, dim=1)
        cvalid = torch.arange(C_PAD, device=dev)[None, :] \
            < scen.const_n.long()[:, None]                          # (B, C)
        d2 = torch.sum((scen.const_path[:, None, :, 0:2]
                        - scen.obj_pos[:, :, None, :]) ** 2,
                       dim=-1)                                      # (B,O,C)
        ref2c = (scen.obj_radius + lat.veh_width / 2.0) ** 2
        d2s = torch.sum((start_pos[:, None, :] - scen.obj_pos) ** 2, dim=-1)
        hit_const = torch.any((d2 <= ref2c[..., None]) & cvalid[:, None, :],
                              dim=2) | (d2s <= ref2c)
        obj_in_const = torch.any(in_seg & hit_const, dim=1)
        track_len = lat.s_rl[-1]
        obj_dist_c = torch.where(s_objs < s_start_,
                                 s_objs + track_len - s_start_,
                                 s_objs - s_start_)
        obj_dist_c = torch.where(in_seg, obj_dist_c, math.inf)
        c_idx = torch.argmin(obj_dist_c, dim=1)
        follow_obj_idx = torch.where(obj_besides, c_idx, obs_idx)

    # ---- action-set decision tree ------------------------------------------
    case_a = obj_in_const | obj_besides
    case_b = (~case_a) & obs_found
    case_c = (~case_a) & (~obs_found)

    feas = pg.feasibility_vectors(out["best"], out["vg"])        # (B, 4, H+1)
    hs = torch.arange(H + 1, device=dev)

    def shrink_select(fv):
        ok = fv & (hs >= 1) & (hs <= h_goal[:, None])
        return torch.amax(torch.where(ok, hs, 0), dim=1)

    def feas_at(slot, h):
        return feas[rows, slot, h]

    h_straight = shrink_select(feas[:, pg.SLOT_STRAIGHT])
    h_follow = shrink_select(feas[:, pg.SLOT_FOLLOW])
    # overtakes inherit follow's horizon
    h_lr = h_follow
    h_left = torch.where((h_lr >= 1) & feas_at(pg.SLOT_LEFT, h_lr), h_lr, 0)
    h_right = torch.where((h_lr >= 1) & feas_at(pg.SLOT_RIGHT, h_lr), h_lr, 0)
    h_a_extra = torch.where((h_lr >= 1) & feas_at(pg.SLOT_STRAIGHT, h_lr),
                            h_lr, 0)

    # reduced-horizon relabeling
    p_obs_w = torch.remainder(obs["obs_layer"] - start_layer, L)
    goal_end = torch.remainder(start_layer + h_goal, L) == L - 1
    reduced = (h_follow != h_goal) | ((not lat.closed) & goal_end)
    obj_in_mod = p_obs_w <= h_follow
    relabel = reduced & (~obj_in_const) & obs_found & (~obj_in_mod)

    last_lr = scen.last_action_lr
    ongoing = case_a & (~obj_in_const) & \
        ((last_lr == pg.SLOT_LEFT) | (last_lr == pg.SLOT_RIGHT))
    lr_both = case_a & (~obj_in_const) & (~ongoing)

    v_straight = (case_c & (h_straight >= 1)) | \
        ((case_a | case_b) & relabel & (h_follow >= 1))
    v_follow = (case_a | case_b) & (~relabel) & (h_follow >= 1)
    v_left = (~relabel) & (
        (case_b & (h_left >= 1))
        | (lr_both & (h_a_extra >= 1))
        | (ongoing & (last_lr == pg.SLOT_LEFT) & (h_a_extra >= 1)))
    v_right = (~relabel) & (
        (case_b & (h_right >= 1))
        | (lr_both & (h_a_extra >= 1))
        | (ongoing & (last_lr == pg.SLOT_RIGHT) & (h_a_extra >= 1)))

    src_straight = torch.where(relabel, pg.SLOT_FOLLOW, pg.SLOT_STRAIGHT)
    src_left = torch.where(case_a, pg.SLOT_STRAIGHT, pg.SLOT_LEFT)
    src_right = torch.where(case_a, pg.SLOT_STRAIGHT, pg.SLOT_RIGHT)
    h_out_straight = torch.where(relabel, h_follow, h_straight)
    h_out_left = torch.where(case_a, h_a_extra, h_left)
    h_out_right = torch.where(case_a, h_a_extra, h_right)

    src4 = torch.stack([src_straight, torch.full_like(src_left,
                                                      pg.SLOT_FOLLOW),
                        src_left, src_right], dim=1)                # (B, 4)
    h4 = torch.stack([h_out_straight, h_follow, h_out_left, h_out_right],
                     dim=1)
    valid4 = torch.stack([v_straight, v_follow, v_left, v_right], dim=1)
    h_safe = torch.clamp(h4, min=1)

    if until == "decide":
        return dict(src=src4.to(torch.int32), h_eff=h4.to(torch.int32),
                    valid=valid4)

    # ---- backtrace + assembly per output slot ------------------------------
    with cuda_graph.span("gltpl.backtrace"):
        r4 = rows[:, None]
        goal_tot = out["best"][r4, src4, h_safe] + out["vg"][r4, src4, h_safe]
        goal_node = torch.argmin(goal_tot, dim=-1)                  # (B, 4)
        cost_all = torch.gather(goal_tot, 2, goal_node[..., None])[..., 0]
        # output slot j of scenario b walks the DP's table of slot src4[b, j],
        # which is one of the four slot constants
        walk = (cuda_backtrace.backtrace_walk if kernels
                else cuda_backtrace.backtrace_walk_plain)
        slots = (pg.SLOT_STRAIGHT, pg.SLOT_FOLLOW, pg.SLOT_LEFT, pg.SLOT_RIGHT)
        nodes4 = walk(out["bp"], goal_node.reshape(B * 4),
                      h_safe.reshape(B * 4), src4.reshape(B * 4),
                      slot_range=(min(slots), max(slots))
                      ).reshape(B, 4, H + 1).long()
        end_nodes = torch.gather(nodes4, 2, h_safe[..., None])[..., 0]

    with cuda_graph.span("gltpl.assemble"):
        # start heading: the previous path's heading at the start node when a
        # const segment exists, else the first edge's stored heading (raceline
        # edges reuse the periodic raceline spline)
        rl = lat.rl_idx.long()
        is_rl = (start_node == rl[start_layer])[:, None] \
            & (nodes4[:, :, 1]
               == rl[torch.remainder(start_layer + 1, L)][:, None])
        d_rl = lat.raceline_coeffs[start_layer, 1]                  # (B, 2)
        psi_rl = torch.atan2(d_rl[:, 1], d_rl[:, 0]) - math.pi / 2.0
        psi_cold = torch.where(is_rl, psi_rl[:, None],
                               lat.node_psi[start_layer, start_node][:, None])
        psi_s = torch.where(scen.warm[:, None], scen.psi_start[:, None],
                            psi_cold)
        # the four slots of scenario b read its window row b
        res_all = pg.assemble_action_kernel(
            lat, out["win_layers"], nodes4.reshape(B * 4, H + 1),
            h_safe.reshape(B * 4), psi_s.reshape(B * 4), p_max=p_max,
            packed=packed, kernels=kernels)
        path4 = res_all["path"].reshape(B, 4, p_max, 5)
        n_valid4 = res_all["n_valid"].reshape(B, 4)

    # ---- constant-path splice ----------------------------------------------
    with cuda_graph.span("gltpl.const_splice"):
        # exported row i = spliced[cut_idx + i]: the remaining const rows then
        # the freshly planned path
        P_full = C_PAD + p_max
        idxf = torch.arange(P_full, device=dev)
        cn = (scen.const_n - scen.cut_idx).long()                       # (B,)
        const_up = dynshift.shift_rows_up(scen.const_path, scen.cut_idx, C_PAD)
        const_rows = torch.cat([const_up, torch.zeros(
            (B, P_full - C_PAD, 5), dtype=const_up.dtype, device=dev)], dim=1)
        new_ext = torch.cat([path4, torch.zeros(
            (B, 4, P_full - p_max, 5), dtype=path4.dtype, device=dev)], dim=2)
        new_rows = dynshift.shift_rows_down(new_ext, cn[:, None], C_PAD)
        paths_full = torch.where(
            (idxf[None, :] < cn[:, None])[:, None, :, None],
            const_rows[:, None], new_rows)
        n_valid_full = n_valid4 + cn[:, None]
        # rows beyond the spliced length freeze at the last real row, with zero
        # element length from the last real row on
        last_i = torch.clamp(n_valid_full - 1, 0, P_full - 1)
        last_row = torch.gather(paths_full, 2,
                                last_i[..., None, None].expand(B, 4, 1, 5))
        paths_full = torch.where(
            (idxf >= n_valid_full[..., None])[..., None], last_row, paths_full)
        paths_full[..., 4] = torch.where(idxf >= n_valid_full[..., None] - 1,
                                         0.0, paths_full[..., 4])

    if until == "assembly":
        return dict(paths=paths_full, n_valid=n_valid_full.to(torch.int32),
                    cost=cost_all, h_eff=h4.to(torch.int32), valid=valid4)

    # ---- velocity stage over the spliced paths -----------------------------
    gg = cuda_graph.const_vector(gg_lim, torch.float32, dev).expand(P_full, 2)
    c_obj_pos = torch.gather(scen.obj_pos, 1,
                             follow_obj_idx[:, None, None].expand(B, 1, 2))
    c_obj_pos = c_obj_pos[:, 0]
    c_obj_vel = torch.gather(scen.obj_vel, 1, follow_obj_idx[:, None])[:, 0]
    follow_target = obs_found | obj_besides
    opp_stop_dist, roll_vel, _, roll_cum = vp.opponent_summary(
        lat.glob_rl, lat.glob_el, c_obj_pos, c_obj_vel, dyn_model_exp,
        drag_coeff, m_veh, kernels=kernels)

    with cuda_graph.span("gltpl.velocity"):
        # raceline end velocity per slot, reduced by the end node's lateral
        # displacement from the raceline
        end_layers = torch.gather(out["win_layers"].long(), 1,
                                  h_safe)                           # (B, 4)
        v_rl = lat.vel_rl[end_layers]
        rl_end = rl[end_layers]
        rl_off = torch.abs(end_nodes - rl_end).to(torch.float32) \
            * lat.lat_offset
        v_end_rl4 = v_rl - torch.minimum(v_rl * lat.vel_decrease_lat * rl_off,
                                         v_rl)
        open_goal_end = (not lat.closed) & goal_end
        red4 = (h4 != h_goal[:, None]) | open_goal_end[:, None]
        # object distance along the follow slot's spliced path relative to the
        # ego projection (its leading-zero s array, of the four slots' s
        # arrays that the velocity stage reads too); with the kernels both
        # positions in one launch, each row read once
        s4 = vp._cumsum0(paths_full[..., 4], kernels=kernels)       # (B,4,P)
        path_f = paths_full[:, pg.SLOT_FOLLOW]                      # (B,P,5)
        s_arr_f = s4[:, pg.SLOT_FOLLOW]
        (s_obj, _), (s_ego, _) = project(path_f[..., 0:2],
                                         (c_obj_pos, scen.pos_cut), s_arr_f)
        obj_dist = torch.where(follow_target, s_obj - s_ego, 0.0)
        vc_full = torch.zeros((B, P_full), dtype=torch.float32, device=dev)
        vc_full[:, :C_PAD] = scen.vel_course
        o = vp.velocity_stage_scenario(
            paths_full, n_valid_full, gg, vc_full, scen.c_len, scen.vel_plan,
            scen.vel_est, f32(vel_max), machines, f32(0.1), v_end_rl4, red4,
            obj_dist, c_obj_vel, f32(safety_d), opp_stop_dist, roll_vel,
            roll_cum, f32(lat.veh_length), f32(1.25), f32(0.025), f32(0.2),
            f32(15.0), dyn_model_exp, drag_coeff, m_veh,
            follow_slot=pg.SLOT_FOLLOW, filt_window=filt_window,
            vp_backend=vp_backend, sqp_x0=sqp_x0,
            veh_turn=f32(lat.veh_turn), tire_end_idx=tire_end_idx,
            tire_end_mps2=f32(tire_end_mps2), sqp_m=sqp_m, sqp_step=sqp_step,
            const_gg=(float(gg_lim[0]), float(gg_lim[1])), s4=s4,
            kernels=kernels)
        trajs4 = o["trajs"]
        # broken velocity constraints remove overtake actions; follow and
        # straight are always retained
        valid4 = valid4 & (o["vel_bound"] | (torch.arange(4, device=dev) < 2))

    # ---- emergency-brake trajectory on the base action ---------------------
    em_base = torch.where(case_c | relabel, 0, 1).to(torch.int32)
    if incl_emergency:
        eb = em_base.long()
        with cuda_graph.span("gltpl.emergency"):
            traj_em = vp.emergency_kernel(trajs4[rows, eb], gg,
                                          kernels=kernels)
        trajs = torch.cat([trajs4, traj_em[:, None]], dim=1)
        valid = torch.cat([valid4, valid4[rows, eb][:, None]], dim=1)
        cost5 = torch.cat([cost_all, cost_all[rows, eb][:, None]], dim=1)
        h5 = torch.cat([h4, h4[rows, eb][:, None]], dim=1)
        nv5 = torch.cat([n_valid_full, n_valid_full[rows, eb][:, None]],
                        dim=1)
    else:
        trajs, valid, cost5, h5, nv5 = (trajs4, valid4, cost_all, h4,
                                        n_valid_full)
    res = dict(trajs=trajs, valid=valid, cost=cost5,
               h_eff=h5.to(torch.int32), n_valid=nv5.to(torch.int32),
               case_a=case_a, relabel=relabel, em_base=em_base)
    if vp_backend == "sqp":
        res["qp_status"] = o["qp_status"]
        res["vx_sqp"] = o["vx_sqp"]
    return res


def make_batched_tick(lat: Lattice, kernels: bool = True, zone_block=None,
                      w_last_factors=None, *, device=None, **kw):
    """The fleet tick: ``tick(scen) -> dict`` over a batch of scenarios.

    Runs on ``device`` (default: the card; ``"cpu"`` for the plain PyTorch
    path).  On the card every stage with a Pallas kernel in the JAX package
    goes through its CUDA kernel at every batch size; ``kernels=False``
    takes the plain versions instead (the reference a kernel tick is held
    against on the same card).

    On the card with the kernels the tick is compiled, as the JAX
    package's ``jax.jit(tick)``: one CUDA graph per input signature
    (``ops/cuda_graph.capture``; the shapes, dtypes and devices of the
    scenario's fields and of tensor overrides, the values of the other
    overrides), captured at its first call and replayed after, every call
    returning fresh tensors.  ``tick.__wrapped__`` is the eager tick, which
    runs the same body op by op (the tools that read ``gltpl.*`` ranges or
    count the kernels' launches call it); ``tick.graphs`` holds the
    captured signatures.  On the CPU, and with ``kernels=False`` (whose
    plain velocity scan reads the host), the tick stays eager.

    :param zone_block: ``(L, N)`` shared zone mask or ``(B, L, N)`` per
        scenario (default: no zones).
    :param kw: options of :func:`scenario_tick` (``p_max``,
        ``incl_emergency``, ``until``, ``filt_window``, ``vp_backend="sqp"``
        and the SQP window parameters among them); ``tick(scen, **over)``
        overrides them for one call, e.g. the warm start ``sqp_x0``.  The
        scalar options the kernels take as launch constants (``gg_lim``,
        ``dyn_model_exp``, ``drag_coeff``, ``m_veh``) are Python numbers.
    """
    dev = resolve_device(device)
    if lat.device != dev:
        lat = lat.to(dev)
    if zone_block is None:
        zone_block = torch.zeros((lat.L, lat.N), dtype=torch.bool,
                                 device=dev)
    zone_block = torch.as_tensor(zone_block, device=dev).to(torch.bool)
    if w_last_factors is None:
        w_last_factors = W_LAST_FACTORS
    w_last_factors = torch.as_tensor(w_last_factors, dtype=torch.float32,
                                     device=dev)
    packed = pg.packed_edge_table(lat)

    @torch.no_grad()
    def tick(scen: Scenario, **over):
        if scen.start_layer.device != dev:
            scen = scen.to(dev)
        return scenario_tick(lat, scen, zone_block=zone_block,
                             w_last_factors=w_last_factors, kernels=kernels,
                             packed=packed, **{**kw, **over})

    return cuda_graph.capture_on_card(tick, dev, kernels)


def make_sharded_tick(lat: Lattice, mesh, kernels: bool = True,
                      zone_block=None, spatial_axis: str = None, device=None,
                      w_last_factors=None, **kw):
    """The fleet tick over a mesh of ranks (``parallel.distributed``):
    ``fn(local_scen, **over) -> (local results, stats)``, where
    ``local_scen`` is this rank's slice of the batch
    (``distributed.shard_scenarios``).

    Without ``spatial_axis`` every mesh axis is data-parallel: each rank
    runs its slice as :func:`make_batched_tick` does (obstacle selection,
    slab hits and window DP, then :func:`scenario_tick` on them).  With
    ``spatial_axis``, scenarios shard over the other axes and each
    scenario's window DP splits its steps over ``spatial_axis``
    (``parallel.spatial.spatial_dp_shard``); the rest of the tick runs
    replicated over that axis.

    Fleet statistics come out of collectives: ``fleet_min_cost`` is the
    minimum over every mesh axis of the valid actions' cost (inf where
    none), ``fleet_actions`` the count of valid actions summed over the
    data axes only (a spatial axis replicates the results, so a sum over
    it would count each action once per rank of it).

    On the card with the kernels the tick is compiled, as the JAX
    package's ``jax.jit(shard_map(...))``: :func:`compile_sharded_tick`,
    one CUDA graph per input signature holding the whole tick where the
    mesh's collectives can be captured (NCCL, or one process without a
    group), else (gloo) its collective-free stages captured with the
    collectives run between their replays.  ``tick.__wrapped__`` is the
    eager tick; on the CPU and with ``kernels=False`` the tick stays
    eager.

    :param zone_block: ``(L, N)`` shared, or ``(B, L, N)`` per scenario
        of the whole batch (each rank keeps its rows).
    :param device: default the mesh's device (the card unless the ranks
        run on the CPU).
    :param kw: options of :func:`scenario_tick`, as for
        :func:`make_batched_tick`; a per-call override must have the same
        value on every rank (a compiled tick's ranks capture together).
    """
    # distributed.py imports this module
    from graphbasedlocaltrajectoryplanner_torch.parallel import distributed
    if spatial_axis is not None and spatial_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {spatial_axis!r}")
    dev = resolve_device(device if device is not None else mesh.device)
    if lat.device != dev:
        lat = lat.to(dev)
    axes = tuple(mesh.axis_names)
    data_axes = mesh.data_axes(spatial_axis)
    if zone_block is None:
        zone_block = torch.zeros((lat.L, lat.N), dtype=torch.bool,
                                 device=dev)
    zone_block = torch.as_tensor(zone_block, device=dev).to(torch.bool)
    if zone_block.dim() == 3:
        zone_block = zone_block[distributed.local_rows(
            zone_block.shape[0], mesh, spatial_axis)]
    if w_last_factors is None:
        w_last_factors = W_LAST_FACTORS
    w_last_factors = torch.as_tensor(w_last_factors, dtype=torch.float32,
                                     device=dev)
    packed = pg.packed_edge_table(lat)

    def finish(scen, obs, window, **over):
        """The tick on the window and the statistics' local inputs."""
        res = scenario_tick(lat, scen, zone_block=zone_block,
                            w_last_factors=w_last_factors, kernels=kernels,
                            packed=packed,
                            precomputed=dict(obs=obs, window=window),
                            **{**kw, **over})
        cost = torch.where(res["valid"], res["cost"], math.inf)
        return res, cost.min(), res["valid"].sum(dtype=torch.int32)

    # the collective-free stages, each a function of tensors
    if spatial_axis is None:
        def whole(scen, **over):
            obs, window = _batched_window(lat, scen, zone_block,
                                          w_last_factors, kernels=kernels)
            return finish(scen, obs, window, **over)
        stages = dict(tick=whole)
    else:
        D, i = mesh.shape[spatial_axis], mesh.coords[spatial_axis]

        def stage_a(scen):
            with cuda_graph.span("gltpl.object_selection"):
                obs = _select_obstacle(lat, scen)
            with cuda_graph.span("gltpl.plan_window"):
                return (obs, *spatial._stage_a(
                    lat, i, D, scen.start_layer, zone_block, scen.obj_pos,
                    scen.obj_radius, scen.obj_active, obs["obs_layer"],
                    obs["obs_node"], obs["obs_found"], scen.last_nodes,
                    w_last_factors, N_LAST, kernels))

        def stage_b(start_node, w4, Pg):
            with cuda_graph.span("gltpl.plan_window"):
                return spatial._stage_b(i, start_node, w4, Pg, kernels)

        def stage_c(start_node, meta, obs_node, parts):
            with cuda_graph.span("gltpl.plan_window"):
                return spatial._stage_c(lat, start_node, zone_block, meta,
                                        obs_node, parts)
        stages = dict(a=stage_a, b=stage_b, c=stage_c, d=finish)

    def compose(st):
        """The tick from the stages ``st`` and the collectives between
        them."""
        def tick(scen: Scenario, **over):
            if scen.start_layer.device != dev:
                scen = scen.to(dev)
            with torch.no_grad():
                if spatial_axis is None:
                    res, cost_min, n_valid = st["tick"](scen, **over)
                else:
                    obs, meta, w4, P = st["a"](scen)
                    with cuda_graph.span("gltpl.plan_window"):
                        Pg = mesh.all_gather(P, spatial_axis)
                    chunk = st["b"](scen.start_node, w4, Pg)
                    with cuda_graph.span("gltpl.plan_window"):
                        parts = mesh.all_gather(chunk, spatial_axis)
                    window = st["c"](scen.start_node, meta, obs["obs_node"],
                                     parts)
                    res, cost_min, n_valid = st["d"](scen, obs, window,
                                                     **over)
                stats = dict(
                    fleet_min_cost=mesh.all_reduce(cost_min, ReduceOp.MIN,
                                                   axes),
                    fleet_actions=(mesh.all_reduce(n_valid, ReduceOp.SUM,
                                                   data_axes)
                                   if data_axes else n_valid))
            return res, stats
        return tick

    tick = compose(stages)
    tick.stages, tick.compose, tick.mesh = stages, compose, mesh
    if dev.type == "cuda" and kernels:        # cuda_graph.capture_on_card
        return compile_sharded_tick(tick, device=dev)
    return tick


class CompiledShardedTick:
    """A sharded tick compiled on the card (see :func:`compile_sharded_tick`);
    called as the eager tick is.

    :ivar form: ``"graph"`` (the whole tick, collectives included, one CUDA
        graph per input signature) or ``"staged"`` (each collective-free
        stage captured, the collectives run between their replays).
    :ivar parts: the captured callables by stage name (``"tick"`` for the
        whole graph; ``"tick"`` or ``"a"``-``"d"`` staged).
    :ivar __wrapped__: the eager tick.
    """

    def __init__(self, tick, form: str, device):
        if form not in ("graph", "staged"):
            raise ValueError(f"form {form!r}: 'graph' or 'staged'")
        self.__wrapped__ = tick
        self.form, self.mesh = form, tick.mesh
        if form == "graph":
            self.parts = dict(tick=cuda_graph.capture(tick, device))
            self._run = self.parts["tick"]
        else:
            self.parts = {name: cuda_graph.capture(fn, device)
                          for name, fn in tick.stages.items()}
            self._run = tick.compose(self.parts)

    @property
    def graphs(self) -> dict:
        """Every captured signature, ``(stage, signature) ->
        cuda_graph.CapturedCall``."""
        return {(name, spec): call for name, part in self.parts.items()
                for spec, call in part.graphs.items()}

    def __call__(self, scen, **over):
        if cuda_graph._disabled:
            return self.__wrapped__(scen, **over)
        if self.form == "graph" and self.mesh.timed:
            raise RuntimeError(
                "mesh.timed is set, but this compiled tick holds its "
                "collectives inside a CUDA graph, where the host clock "
                "cannot time them: unset it, time the eager tick "
                "(tick.__wrapped__), or read the collectives' device time "
                "from a profiled replay (distributed.collective_share)")
        return self._run(scen, **over)


def compile_sharded_tick(tick, form: str = None, device=None):
    """The eager sharded tick of :func:`make_sharded_tick` compiled as
    the JAX package jits its ``shard_map``: with ``form="graph"`` one CUDA
    graph per input signature holding the whole tick, collectives included
    (``ops/cuda_graph.capture``; every rank captures and replays the same
    signature at the same call); with ``form="staged"`` each
    collective-free stage captured on its own and the collectives run
    eagerly between the replays: the data-parallel tick's one stage (the
    tick through the statistics' local inputs) and the two reductions
    after it; the spatial tick's stages A, B and C of
    ``spatial.spatial_dp_shard`` with its two gathers between them, then
    stage D (:func:`scenario_tick` and the statistics' inputs) and the
    reductions.  The default form is the one the mesh's backend fixes:
    ``"graph"`` where ``mesh.capturable`` (NCCL, or no process group),
    ``"staged"`` on gloo, which stages card tensors through the host.

    Inside ``cuda_graph.disabled()`` every form runs the eager tick.  The
    mesh's ``timed`` collectives cannot run in a graph: a capture with it
    set raises, and so does any call of the ``"graph"`` form (the staged
    form times its eager collectives as the eager tick does).

    :param device: where the static buffers live (default the mesh's).
    """
    if form is None:
        form = "graph" if tick.mesh.capturable else "staged"
    return CompiledShardedTick(tick, form, device if device is not None
                               else tick.mesh.device)
