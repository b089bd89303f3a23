"""Stateful online trajectory handler (torch) — counterpart of the JAX
package's ``planner/handler.py``, the reference's
``OnlineTrajectoryHandler`` (graph_ltpl/online_graph/src/
OnlineTrajectoryHandler.py).

Host-side Python keeps the iterative state (warm start, cut-index
bookkeeping, backup plans, action-set assembly — OTH:289-516) in NumPy, as
the JAX handler does, with the same decisions in the same order.  The
numeric work of a tick runs on the handler's device as a few batched calls:

  * ``pathgen.plan_window_kernel`` — slab hit masks + 4-slot window DP
    (kernels 1 and 2), one scenario;
  * ``pathgen.backtrace_slot`` + ``pathgen.assemble_action_kernel`` — one
    call each over every action of the tick (kernel 3);
  * ``velplan.velocity_kernel`` — every action's profile in one call: the
    fb recurrences (kernel 5) or, under ``vp_type=sqp``, every action's
    normal and follow QP as one batched ADMM solve (``csrc/admm_vel.cu``);
    plus the opponent summary and the emergency profile (kernel 5) and the
    backup-ladder brake profile (kernel 5 for fb, one ADMM solve for sqp).

Under ``sqp`` the handler keeps the reference's cross-tick warm start: the
previous solution per ``(plan, action)``, shifted by the distance travelled
(VpSQP.py:297-340).

Each of these device steps is one of the handler's compiled calls
(``OnlineHandler.steps``), the counterparts of the JAX handler's jitted
calls: on the card with the kernels each is captured as one CUDA graph per
input signature (``ops/cuda_graph.capture_on_card``), on the CPU and on the
plain path it runs eagerly.  Inside ``cuda_graph.disabled()`` every call
runs eagerly on the card too, so the kernels' launch counters and a
recorder of their calls see each of them.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.models.lattice import Lattice
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
from graphbasedlocaltrajectoryplanner_torch.planner import hostmath
from graphbasedlocaltrajectoryplanner_torch.planner import objects as objmod
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as vp
from graphbasedlocaltrajectoryplanner_torch.utils.config import OnlineConfig

LOG = logging.getLogger("local_trajectory_logger")

# trajectory-ID scheme (OTH:13-17)
ACTION_ID_MAP = {"straight": 0, "follow": 1, "left": 2, "right": 3}

O_PAD = 16          # padded collision slots (vehicles + prediction points)
N_LAST = 4          # window chain length for w_last_edges discounting

_np = objmod._np


class OnlineHandler:
    def __init__(self,
                 lattice: Lattice,
                 online_cfg: OnlineConfig,
                 veh_param_dyn_model_exp: float = 1.0,
                 veh_param_dragcoeff: float = 0.85,
                 veh_param_mass: float = 1000.0,
                 kernels: bool = True):
        """:param lattice: the lattice on the device the handler runs on.
        :param kernels: route the stages that have a CUDA kernel through
            its wrapper (the kernel on the card, its plain version on the
            CPU); ``False`` takes the plain versions on any device."""
        self.lat = lattice
        self.dev = lattice.device
        self.kernels = kernels
        self.cfg = online_cfg
        self.dyn_model_exp = veh_param_dyn_model_exp
        self.drag_coeff = veh_param_dragcoeff
        self.m_veh = veh_param_mass

        if online_cfg.vp_type not in ("fb", "sqp"):
            raise ValueError("No valid velocity planner specified!")
        self.vp_backend = online_cfg.vp_type
        if online_cfg.max_solutions > 1:
            LOG.warning("max_solutions > 1 is not supported (single optimum "
                        "per action); continuing with 1.")

        # host copies of the lattice data the host logic reads
        lt = lattice
        self.np_node_pos = _np(lt.node_pos)
        self.np_node_psi = _np(lt.node_psi)
        self.np_node_valid = _np(lt.node_valid)
        self.np_rl_idx = _np(lt.rl_idx)
        self.np_nodes_in_layer = _np(lt.nodes_in_layer)
        self.np_refline = _np(lt.refline)
        self.np_normvec = _np(lt.normvec)
        self.np_raceline = _np(lt.raceline)
        self.np_s_rl = _np(lt.s_rl)
        self.np_vel_rl = _np(lt.vel_rl)
        self.np_wr = _np(lt.track_width_right)
        self.np_wl = _np(lt.track_width_left)
        self.np_h_goal = _np(lt.h_goal_for_start)
        self.np_raceline_coeffs = _np(lt.raceline_coeffs)
        # per-edge assembly table, once per lattice
        self.packed = pg.packed_edge_table(lattice)

        # fixed path-array size: worst-case fused path + constant segment
        self.P = int(np.ceil((lt.H_max * (lt.S - 1) + 1 + 64) / 64.0) * 64)
        self.steps = self._device_steps()

        # iterative memory (reinit_iterative_memory, OTH:161-179)
        self.calc_buffer = []
        self.traj_base_id = 0
        self.reinit_iterative_memory()
        self.em_base_id = None

        self.obj_veh = []
        self.obj_zone = []
        self.closest_obj_index = None
        self.v_start = 0.0
        self.old_gg_scale = None

    def _f32(self, x):
        """A host float array (or list of scalars) as one float32 tensor on
        the handler's device."""
        return torch.as_tensor(np.asarray(x, np.float32), device=self.dev)

    def _ints(self, x):
        """Host integers as one int64 tensor on the handler's device."""
        return torch.as_tensor(np.asarray(x, np.int64), device=self.dev)

    def _device_steps(self) -> dict:
        """The device steps of a tick, by name, each the counterpart of a
        ``jax.jit`` of the JAX handler: ``plan`` (``plan_window_kernel``
        and ``feasibility_vectors``), ``walk`` (``backtrace_slot``),
        ``assemble`` (``assemble_action_kernel``), ``opponent``
        (``opponent_summary``), ``velocity`` (``velocity_kernel``),
        ``brake_fb`` / ``brake_sqp`` (``brake_on_backup_kernel`` /
        ``brake_em_sqp_kernel``) and ``emergency`` (``emergency_kernel``).

        Each closes over what the JAX call takes as a pytree or a static
        argument (the lattice, the packed edge table, ``P``, the config's
        and the vehicle's constants), so that only its tensors and the
        ``slot_range`` of a walk (two of the slots 0-3) make its signature;
        every value that changes from tick to tick enters as a tensor.
        Each looks its function up at the call, so a wrapper put in the
        function's place later is the one called."""
        lat, kernels, cfg = self.lat, self.kernels, self.cfg
        dyn = (self.dyn_model_exp, self.drag_coeff, self.m_veh)
        sqp_m = int(cfg.nmbr_export_points)

        def plan(ints, zone_mask, opos, orad, oact, found, w_fac):
            out = pg.plan_window_kernel(
                lat, ints[0:1], ints[1:2], zone_mask, opos, orad, oact,
                ints[2:3], ints[3:4], found, ints[4:][None], w_fac,
                kernels=kernels)
            return out, pg.feasibility_vectors(out["best"], out["vg"])[0]

        def walk(best, bp, vg, h_effs, slots, slot_range):
            return pg.backtrace_slot(best, bp, vg, h_effs, kernels=kernels,
                                     slot=slots, slot_range=slot_range)

        def assemble(win_layers, nodes, h_effs, psi_s):
            # every action reads the one window row
            return pg.assemble_action_kernel(
                lat, win_layers, nodes, h_effs, psi_s, p_max=self.P,
                packed=self.packed, kernels=kernels)

        def opponent(pos, vel):
            stop_dist, roll_vel, _, roll_cum = vp.opponent_summary(
                lat.glob_rl, lat.glob_el, pos, vel, *dyn, kernels=kernels)
            return stop_dist[0], roll_vel[0], roll_cum[0]

        def velocity(path, gg, vc_pad, ints, shared, rows, machines, opp,
                     sqp_in):
            # ints [c_len, n_valid per action]; shared the tick's scalars
            # (see calc_vel_profile); rows one action a row [red_len,
            # v_end_rl, obj_dist, v_obj, is_follow]
            sqp_kw = {}
            if sqp_in is not None:
                sqp_kw = dict(sqp_in, vp_backend="sqp",
                              tire_end_idx=self._tire_end_idx(), sqp_m=sqp_m,
                              sqp_step=float(lat.sampled_resolution))
            s = shared.unbind()
            return vp.velocity_kernel(
                path, ints[1:], gg, vc_pad, ints[0], s[0], s[1], s[2], s[3],
                s[4], machines, s[5], rows[:, 4] > 0.5, rows[:, 0] > 0.5,
                rows[:, 1], rows[:, 2], rows[:, 3], s[6], *opp, s[7], s[8],
                s[9], s[10], s[11], *dyn, control_type=cfg.controller_type,
                filt_window=cfg.filt_window_width, kernels=kernels, **sqp_kw)

        def brake_fb(path, gg, vc_pad, ints, vel_plan):
            # ints [n_valid, c_len]
            return vp.brake_on_backup_kernel(path, ints[0], gg, vc_pad,
                                             ints[1], vel_plan, *dyn,
                                             kernels=kernels)

        def brake_sqp(path, gg, vc_pad, ints, vel_plan, machines, veh_turn,
                      tire_end_mps2):
            return vp.brake_em_sqp_kernel(
                path, ints[0], gg, vc_pad, ints[1], vel_plan, machines,
                veh_turn, tire_end_mps2, self.drag_coeff, self.m_veh,
                sqp_m=sqp_m, kernels=kernels)

        def emergency(traj, gg):
            return vp.emergency_kernel(traj[None], gg, kernels=kernels)[0]

        return {fn.__name__: cuda_graph.capture_on_card(fn, self.dev, kernels)
                for fn in (plan, walk, assemble, opponent, velocity, brake_fb,
                           brake_sqp, emergency)}

    def signatures(self) -> int:
        """The input signatures the compiled calls have captured so far (0
        where they run eagerly)."""
        return sum(len(getattr(f, "graphs", ())) for f in self.steps.values())

    # ------------------------------------------------------------------
    def reinit_iterative_memory(self):
        self.start_node = None          # [layer, node]
        self.last_nodes = None          # {action: [list of [layer, node]]}
        self.last_node_idx = None       # {action: [np (n_nodes,)]}
        self.last_coeff = None          # {action: [np (n_seg, 8)]}
        self.last_path_param = None     # {action: [np (n, 5)]}
        self.last_path_gg = None        # {action: [np (n, 2)]}
        self.last_red_len = None        # {action: [bool]}
        self.last_bp_action_set = None  # {action: [np (n, 7)]}
        self.last_path_timestamp = None
        self.last_cut_idx = 0
        # SQP cross-tick warm start: previous solution per (plan, action)
        # and the travelled-distance anchor of the MPC shift
        self.sqp_state = {}
        self.sqp_s_glob_old = None
        self.pos_est = None
        self.action_id_forced = None

    # ------------------------------------------------------------------
    def set_initial_pose(self, start_pos, start_heading, start_vel=0.0,
                         max_heading_offset=np.pi / 4):
        """OTH.set_initial_pose:181-270."""
        lat = self.lat
        self.v_start = float(start_vel)
        self.reinit_iterative_memory()

        bound1 = self.np_refline + self.np_normvec * self.np_wr[:, None]
        bound2 = self.np_refline - self.np_normvec * self.np_wl[:, None]
        if not hostmath.check_inside_bounds(bound1, bound2, start_pos):
            LOG.warning("Vehicle is out of track, check if correct reference "
                        "line is provided!")
            return False, True

        # closest valid node
        d2 = np.sum((self.np_node_pos - np.asarray(start_pos)) ** 2, axis=-1)
        d2[~self.np_node_valid] = np.inf
        layer, node = np.unravel_index(np.argmin(d2), d2.shape)

        # goal: raceline node two layers ahead (OTH:226-229 — including the
        # reference's modulus-(L-1) quirk)
        goal_layer = (int(layer) + 2) % (lat.L - 1)
        goal_node = int(self.np_rl_idx[goal_layer])
        self.start_node = [goal_layer, goal_node]

        end_pos = self.np_node_pos[goal_layer, goal_node]
        end_heading = float(self.np_node_psi[goal_layer, goal_node])
        heading_diff = abs(start_heading - end_heading)
        if heading_diff > np.pi:
            heading_diff = abs(2 * np.pi - heading_diff)
        if heading_diff > max_heading_offset:
            LOG.warning("Heading mismatch between vehicle and track grid!")
            return True, False

        # spline from pose to the start node (OTH:243-269)
        coeffs = spl.fit_hermite(self._f32(start_pos), self._f32(end_pos),
                                 self._f32(float(start_heading)),
                                 self._f32(end_heading))
        pts, t_vals, n_pts, _ = spl.sample_uniform(
            coeffs, lat.sampled_resolution, s_max=64)
        psi, kappa = spl.head_curv_an(coeffs, t_vals)
        n = int(n_pts)
        path = _np(pts)[:n]
        psi = _np(psi)[:n]
        kappa = _np(kappa)[:n]
        el = np.linalg.norm(np.diff(path, axis=0), axis=1)

        act_id = "straight"
        self.action_id_forced = act_id
        c = _np(coeffs)
        coeffs8 = np.concatenate([c[:, 0], c[:, 1]])[None, :]
        self.last_coeff = {act_id: [coeffs8]}
        self.last_path_param = {act_id: [np.column_stack(
            [path, psi, kappa, np.append(el, 0.0)]).astype(np.float32)]}
        self.last_nodes = {act_id: [[[None, None], list(self.start_node)]]}
        self.last_node_idx = {act_id: [np.array([0, n - 1])]}
        self.last_red_len = {act_id: [False]}
        return True, True

    # ------------------------------------------------------------------
    def update_objects(self, obj_veh, obj_zone):
        self.obj_veh = obj_veh
        self.obj_zone = obj_zone
        self.closest_obj_index = None

    # ------------------------------------------------------------------
    def _first_edge_heading(self, layer, node, node2):
        """Heading at t=0 of edge (layer,node)->(layer+1,node2) — equals the
        stored first-sample psi of the reference (spline boundary)."""
        lat = self.lat
        if node == int(self.np_rl_idx[layer]) \
                and node2 == int(self.np_rl_idx[(layer + 1) % lat.L]):
            c = self.np_raceline_coeffs[layer]
            d = c[1]
        else:
            psi = self.np_node_psi[layer, node]
            return float(psi)
        return float(np.arctan2(d[1], d[0]) - np.pi / 2)

    # ------------------------------------------------------------------
    def calc_paths(self, action_id_sel: str, idx_sel_traj: int = 0):
        """OTH.calc_paths:289-516 — warm start, path search, reassembly."""
        if action_id_sel == "emergency":
            action_id_sel = self.em_base_id
        if self.action_id_forced is not None:
            action_id_sel = self.action_id_forced
            self.action_id_forced = None

        const_path_seg_exists = (self.last_path_param is not None
                                 and action_id_sel in self.last_path_param)
        planned_once = self.last_path_timestamp is not None
        valid_solution_last_step = (
            planned_once and const_path_seg_exists
            and self.last_bp_action_set is not None
            and action_id_sel in self.last_bp_action_set
            and self.last_bp_action_set[action_id_sel][idx_sel_traj].shape[0] > 2)

        # ---- backup plan capture (OTH:326-344) ----------------------------
        if valid_solution_last_step:
            temp_id = "follow" if "follow" in self.last_nodes else "straight"
            self.backup_coeff = self.last_coeff[temp_id][0]
            self.backup_node_idx = self.last_node_idx[temp_id][0]
            self.backup_nodes = self.last_nodes[temp_id][0]
            self.backup_path_param = self.last_path_param[temp_id][0]
            self.backup_path_gg = self.last_path_gg[temp_id][0]
        else:
            self.backup_coeff = None
            self.backup_node_idx = None
            self.backup_nodes = None
            self.backup_path_param = None
            self.backup_path_gg = None

        # ---- warm start / split point (OTH:351-414) -----------------------
        last_solution_nodes = None
        if planned_once and valid_solution_last_step:
            calc_time = time.time() - self.last_path_timestamp
            self.last_path_timestamp = time.time()
            if calc_time > self.cfg.calc_time_warn_threshold:
                LOG.warning("Warning: One trajectory generation iteration "
                            "took more than %.3fs (actual: %.3fs)",
                            self.cfg.calc_time_warn_threshold, calc_time)
            if len(self.calc_buffer) >= self.cfg.calc_time_buffer_len:
                self.calc_buffer.pop(0)
            self.calc_buffer.append(calc_time)
            calc_time_avg = float(np.mean(self.calc_buffer))

            bp = self.last_bp_action_set[action_id_sel][idx_sel_traj]
            s_past = np.diff(bp[1:, 0])
            v_past = bp[1:-1, 5]
            t_approx = np.divide(s_past, v_past,
                                 out=np.full(v_past.shape[0], np.inf),
                                 where=v_past != 0)
            t_const = min(calc_time_avg * self.cfg.calc_time_safety, 0.5)
            next_idx = int((np.cumsum(t_approx) <= t_const).argmin()) + 1

            last_node_idx = self.last_node_idx[action_id_sel][idx_sel_traj]
            node_coords = self.last_path_param[action_id_sel][idx_sel_traj][
                np.asarray(last_node_idx, int), 0:2]
            predicted_pos = bp[next_idx, 1:3]
            start_node_idx = hostmath.get_s_coord(node_coords, predicted_pos,
                                                  only_index=True)[1][1]
            loc_path_start_idx = int(last_node_idx[start_node_idx])
            self.start_node = list(
                self.last_nodes[action_id_sel][idx_sel_traj][start_node_idx])
            last_solution_nodes = \
                self.last_nodes[action_id_sel][idx_sel_traj][start_node_idx:]
        else:
            self.last_path_timestamp = time.time()
            if const_path_seg_exists and \
                    self.start_node in self.last_nodes[action_id_sel][idx_sel_traj]:
                start_node_pos = self.np_node_pos[self.start_node[0],
                                                  self.start_node[1]]
                loc_path_start_idx = hostmath.closest_path_index(
                    self.last_path_param[action_id_sel][idx_sel_traj][:, 0:2],
                    start_node_pos)
                start_node_idx = self.last_nodes[action_id_sel][idx_sel_traj]\
                    .index(self.start_node)
            else:
                loc_path_start_idx = 0
                start_node_idx = 0

        const_path_seg = None
        if const_path_seg_exists:
            const_path_seg = self.last_path_param[action_id_sel][idx_sel_traj][
                :loc_path_start_idx + 1, :]

        # ---- plan (main_online_path_gen equivalent) -----------------------
        (action_set_nodes, action_set_node_idx, action_set_coeff,
         action_set_path_param, action_set_red_len, self.closest_obj_index) = \
            self._online_path_gen(
                start_node=self.start_node,
                last_action_id=action_id_sel,
                const_path_seg=const_path_seg,
                pos_est=self.pos_est,
                last_solution_nodes=last_solution_nodes)

        # ---- reassemble constant path segment (OTH:432-473) ---------------
        for action_id in list(action_set_nodes.keys()):
            if not action_set_nodes[action_id]:
                continue
            if const_path_seg_exists:
                for i in range(len(action_set_nodes[action_id])):
                    if loc_path_start_idx > 0:
                        prev = self.last_path_param[action_id_sel][idx_sel_traj]
                        action_set_path_param[action_id][i] = np.concatenate(
                            (prev[:loc_path_start_idx, :],
                             action_set_path_param[action_id][i]))
                        # edge case: cut exactly at end of previous path
                        if prev.shape[0] == loc_path_start_idx:
                            j = loc_path_start_idx - 1
                            seg = action_set_path_param[action_id][i]
                            seg[j, 4] = float(np.hypot(
                                seg[j + 1, 0] - seg[j, 0],
                                seg[j + 1, 1] - seg[j, 1]))
                    action_set_node_idx[action_id][i] = np.concatenate(
                        (np.asarray(self.last_node_idx[action_id_sel][idx_sel_traj][:start_node_idx]),
                         np.asarray(action_set_node_idx[action_id][i]) + loc_path_start_idx))
                    if start_node_idx > 0:
                        action_set_nodes[action_id][i] = \
                            list(self.last_nodes[action_id_sel][idx_sel_traj][:start_node_idx]) \
                            + list(action_set_nodes[action_id][i])
                        action_set_coeff[action_id][i] = np.concatenate(
                            (self.last_coeff[action_id_sel][idx_sel_traj][:start_node_idx],
                             action_set_coeff[action_id][i]))

        # ---- all-blocked fallback (OTH:474-506) ---------------------------
        if not any(v for v in action_set_nodes.values()):
            LOG.critical("Could not find a path solution for any of the "
                         "points in the given destination layer! Track seems "
                         "to be blocked.")
            if const_path_seg_exists and const_path_seg.shape[0] > 2:
                loc_path_start_idx += 1
                start_node_idx += 1
                action_set_path_param[action_id_sel] = [
                    self.last_path_param[action_id_sel][idx_sel_traj][:loc_path_start_idx, :]]
                action_set_node_idx[action_id_sel] = [np.asarray(
                    self.last_node_idx[action_id_sel][idx_sel_traj][:start_node_idx])]
                action_set_nodes[action_id_sel] = [list(
                    self.last_nodes[action_id_sel][idx_sel_traj][:start_node_idx])]
                action_set_coeff[action_id_sel] = [
                    self.last_coeff[action_id_sel][idx_sel_traj][:start_node_idx]]
                action_set_red_len[action_id_sel] = [True]

        self.last_nodes = action_set_nodes
        self.last_node_idx = action_set_node_idx
        self.last_coeff = action_set_coeff
        self.last_path_param = action_set_path_param
        self.last_red_len = action_set_red_len
        return (self.last_path_param, self.start_node, self.last_nodes,
                const_path_seg)

    # ------------------------------------------------------------------
    def _online_path_gen(self, start_node, last_action_id, const_path_seg,
                         pos_est, last_solution_nodes):
        """main_online_path_gen.py:11-334 on the window DP kernel."""
        lat = self.lat
        dev = self.dev
        start_layer, start_node_id = int(start_node[0]), int(start_node[1])

        # zones -> node mask (gen_local_node_template.py:43-99)
        zone_mask = objmod.zones_to_node_mask(self.obj_zone, lat, start_layer)

        # objects -> padded arrays
        opos, orad, oact, owner = objmod.vehicles_to_arrays(self.obj_veh, O_PAD)

        # closest object by layer distance (gen_local_node_template.py:164-213)
        h_goal = int(self.np_h_goal[start_layer])
        closest_obj_index = None
        closest_obj_node = None
        closest_layer_dist = None
        for i, veh in enumerate(self.obj_veh):
            # the reference keys the closest-object layer on the *last*
            # prediction point processed (obj_layer is overwritten in its
            # loop, gen_local_node_template.py:169-203)
            ref_pt = veh.prediction[-1] if veh.prediction.shape[0] else veh.pos
            d2 = np.sum((self.np_refline - ref_pt) ** 2, axis=1)
            obj_layer = int(np.argmin(d2))
            in_rng = self._obj_in_planning_range(obj_layer, start_layer,
                                                 (start_layer + h_goal) % lat.L)
            if not in_rng:
                continue
            layer_dist = (obj_layer - start_layer) % lat.L
            if layer_dist <= h_goal and (closest_layer_dist is None
                                         or layer_dist < closest_layer_dist):
                closest_layer_dist = layer_dist
                closest_obj_index = i
                closest_obj_node = [obj_layer, None]
        if closest_obj_index is not None:
            pos_l = self.np_node_pos[closest_obj_node[0]]
            d2 = np.sum((pos_l - self.obj_veh[closest_obj_index].pos) ** 2,
                        axis=1)
            d2[~self.np_node_valid[closest_obj_node[0]]] = np.inf
            closest_obj_node[1] = int(np.argmin(d2))

        # w_last_edges discount chain in window coordinates
        last_win = np.full(N_LAST, -1, np.int32)
        w_fac = np.ones(N_LAST - 1, np.float32)
        if last_solution_nodes is not None:
            k = min(len(last_solution_nodes) - 1, len(self.cfg.w_last_edges),
                    N_LAST - 1)
            for i in range(k + 1):
                if i < len(last_solution_nodes):
                    last_win[i] = last_solution_nodes[i][1]
            for i in range(k):
                w_fac[i] = self.cfg.w_last_edges[i]

        obs_layer = closest_obj_node[0] if closest_obj_node else 0
        obs_node = closest_obj_node[1] if closest_obj_node else 0
        # one scenario: the scenario tensors carry a leading 1
        out, feas = self.steps["plan"](
            self._ints(np.concatenate(
                [[start_layer, start_node_id, obs_layer, obs_node],
                 last_win])),
            torch.as_tensor(zone_mask, device=dev), self._f32(opos)[None],
            self._f32(orad)[None], torch.as_tensor(oact, device=dev)[None],
            torch.tensor([closest_obj_node is not None], device=dev),
            self._f32(w_fac))
        feas = _np(feas)

        # ---- object vs constant path segment (main_online_path_gen:76-122)
        obj_in_const_path = False
        object_besides_const_path = False
        if const_path_seg is not None and const_path_seg.shape[0] >= 2:
            pos_start = pos_est if pos_est is not None else const_path_seg[0, 0:2]
            s_start = hostmath.get_s_coord(self.np_raceline, pos_start,
                                           self.np_s_rl, closed=True)[0]
            s_end = hostmath.get_s_coord(self.np_raceline,
                                         const_path_seg[-1, 0:2],
                                         self.np_s_rl, closed=True)[0]
            smallest = np.inf
            for oi, veh in enumerate(self.obj_veh):
                s_obj = hostmath.get_s_coord(self.np_raceline, veh.pos,
                                             self.np_s_rl, closed=True)[0]
                if s_start <= s_obj <= s_end or \
                        (s_start > s_end and (s_obj > s_start or s_obj < s_end)):
                    object_besides_const_path = True
                    obj_dist = (s_obj + self.np_s_rl[-1] - s_start
                                if s_obj < s_start else s_obj - s_start)
                    if closest_obj_index is None or obj_dist < smallest:
                        closest_obj_index = oi
                        smallest = obj_dist
                    ref2 = (veh.radius + lat.veh_width / 2) ** 2
                    d2 = ((const_path_seg[:, 0] - veh.pos[0]) ** 2
                          + (const_path_seg[:, 1] - veh.pos[1]) ** 2)
                    if np.any(d2 <= ref2):
                        obj_in_const_path = True

        # ---- action-set decision tree (main_online_path_gen:124-174) ------
        # each entry: (name, slot, shrink)
        if obj_in_const_path or object_besides_const_path:
            actions = [("follow", pg.SLOT_FOLLOW, True)]
            if not obj_in_const_path and last_action_id in ("left", "right"):
                actions.append((last_action_id, pg.SLOT_STRAIGHT, False))
            elif not obj_in_const_path:
                actions.append(("left", pg.SLOT_STRAIGHT, False))
                actions.append(("right", pg.SLOT_STRAIGHT, False))
        elif closest_obj_index is not None and closest_obj_node is not None:
            actions = [("follow", pg.SLOT_FOLLOW, True),
                       ("left", pg.SLOT_LEFT, False),
                       ("right", pg.SLOT_RIGHT, False)]
        else:
            actions = [("straight", pg.SLOT_STRAIGHT, True)]

        # ---- per-action horizon selection with shared shrink --------------
        # every action's horizon follows from the feasibility vectors alone,
        # so all selected actions are walked and assembled together below
        selected = []                   # (name, slot, h_eff, reduced)
        mod_h_goal = h_goal
        for name, slot, shrink in actions:
            fv = feas[slot]
            if shrink:
                cand = np.nonzero(fv[1:mod_h_goal + 1])[0]
                h_eff = int(cand.max()) + 1 if cand.size else 0
                # the shrunk horizon is shared with subsequent actions, and
                # full infeasibility exhausts it for them too
                # (main_online_path_gen.py:187-220)
                mod_h_goal = h_eff
            else:
                h_eff = mod_h_goal if (mod_h_goal >= 1 and fv[mod_h_goal]) else 0
            if h_eff < 1:
                LOG.debug("Action set '%s' is empty! No path solution found.",
                          name)
                continue

            reduced = (h_eff != h_goal) or \
                (not lat.closed and
                 (start_layer + h_goal) % lat.L == lat.L - 1)
            if reduced:
                obj_in_mod = False
                if closest_obj_node is not None:
                    ol = closest_obj_node[0]
                    mod_goal_layer = (start_layer + h_eff) % lat.L
                    if start_layer <= mod_goal_layer:
                        obj_in_mod = start_layer <= ol <= mod_goal_layer
                    else:
                        obj_in_mod = ol >= start_layer or ol <= mod_goal_layer
                if (not obj_in_const_path and closest_obj_node is not None
                        and not obj_in_mod):
                    if name in ("follow", "straight"):
                        name = "straight"
                        LOG.info("No feasible solution for '%s'! Reduced "
                                 "planning horizon!", name)
                    else:
                        continue    # drop overtaking options
                else:
                    LOG.info("No feasible solution for '%s'! Reduced "
                             "planning horizon!", name)
            selected.append((name, slot, h_eff, reduced))

        action_set_nodes = {}
        action_set_node_idx = {}
        action_set_coeff = {}
        action_set_path_param = {}
        action_set_red_len = {}
        if not selected:
            return (action_set_nodes, action_set_node_idx, action_set_coeff,
                    action_set_path_param, action_set_red_len,
                    closest_obj_index)

        # ---- one backtrace over every selected action ---------------------
        # rows of slots and of horizons: each contiguous as the walk takes it;
        # the slots' bounds from the host, so the walk reads no slot back
        sel_np = np.array([[s[1] for s in selected],
                           [s[2] for s in selected]])
        sel = torch.as_tensor(sel_np, device=dev)
        slots, h_effs = sel[0], sel[1]
        nodes_all, _cost = self.steps["walk"](
            out["best"], out["bp"], out["vg"], h_effs, slots,
            (int(sel_np[0].min()), int(sel_np[0].max())))
        nodes_np = _np(nodes_all)
        win = (start_layer + np.arange(lat.H_max + 1)) % lat.L

        # start heading for the C2 re-fit (main_online_path_gen:299-303)
        psi_s = []
        for r, (name, slot, h_eff, reduced) in enumerate(selected):
            if const_path_seg is not None and const_path_seg.shape[0] > 0:
                psi_s.append(float(const_path_seg[-1, 2]))
            else:
                psi_s.append(self._first_edge_heading(
                    start_layer, int(nodes_np[r, 0]), int(nodes_np[r, 1])))

        # ---- one assembly over every selected action ----------------------
        res = self.steps["assemble"](out["win_layers"], nodes_all, h_effs,
                                     self._f32(psi_s))
        paths = _np(res["path"])
        n_valids = _np(res["n_valid"])
        node_idxs = _np(res["node_idx"])
        coeffs_all = _np(res["coeffs"])

        for r, (name, slot, h_eff, reduced) in enumerate(selected):
            n_valid = int(n_valids[r])
            node_chain = [[int(win[h]), int(nodes_np[r, h])]
                          for h in range(h_eff + 1)]
            action_set_nodes[name] = [node_chain]
            action_set_node_idx[name] = [node_idxs[r, :h_eff + 1]]
            action_set_coeff[name] = [coeffs_all[r, :h_eff]]
            action_set_path_param[name] = [paths[r, :n_valid]]
            action_set_red_len[name] = [reduced]

        return (action_set_nodes, action_set_node_idx, action_set_coeff,
                action_set_path_param, action_set_red_len, closest_obj_index)

    def _obj_in_planning_range(self, obj_layer, planning_start, planning_end):
        """get_intersec_edges.py:48-51 (±1 layer overlap, wrap-aware)."""
        lo = 1
        if planning_start <= planning_end:
            return planning_start - lo <= obj_layer <= planning_end + lo
        return obj_layer >= planning_start - lo or obj_layer <= planning_end + lo

    # ------------------------------------------------------------------
    def get_ref_idx(self, action_id_sel, idx_sel_traj, pos_est):
        """OTH.get_ref_idx:518-601."""
        self.pos_est = np.asarray(pos_est, float)
        planned_once = self.last_bp_action_set is not None
        valid_last = (planned_once and action_id_sel in self.last_bp_action_set
                      and self.last_bp_action_set[action_id_sel][idx_sel_traj].shape[0] > 0)
        valid_this = self.last_node_idx is not None and len(self.last_node_idx) > 0

        if planned_once and valid_last:
            bp = self.last_bp_action_set[action_id_sel][idx_sel_traj]
            idx_nb = hostmath.get_s_coord(bp[:, 1:3], pos_est, bp[:, 0],
                                          only_index=True)[1]
            cut_index = idx_nb[0]
            s_past = np.diff(bp[cut_index:, 0])
            v_past = bp[cut_index:-1, 5]
            t_approx = np.divide(s_past, v_past,
                                 out=np.full(v_past.shape[0], np.inf),
                                 where=v_past != 0)
            vel_idx = min(int((np.cumsum(t_approx) <= self.cfg.delaycomp).argmin()) + 1,
                          max(v_past.shape[0] - 1, 0))
            vel_plan = float(bp[cut_index + vel_idx, 5])
            acc_plan = float(bp[cut_index + vel_idx, 6])
            vel_course = bp[cut_index:cut_index + vel_idx, 5].copy()
            cut_index_pos = self.last_cut_idx + cut_index
            if valid_this:
                action_id_tmp = next(iter(self.last_node_idx))
                ni = np.asarray(self.last_node_idx[action_id_tmp][0])
                cut_layer = max(int(np.argmin(ni < cut_index_pos)) - 2, 0)
                cut_index_layer = int(ni[cut_layer])
            else:
                cut_layer = 0
                cut_index_layer = 0
        else:
            cut_index_pos = 0
            cut_layer = 0
            cut_index_layer = 0
            vel_course = np.array([])
            vel_plan = self.v_start
            acc_plan = 0.0

        self.last_cut_idx = cut_index_pos - cut_index_layer
        return cut_index_pos, cut_layer, vel_plan, vel_course, acc_plan

    # ------------------------------------------------------------------
    def _pad_path(self, path):
        n = path.shape[0]
        out = np.zeros((self.P, path.shape[1]), np.float32)
        out[:n] = path
        if n > 0:
            out[n:] = path[-1]
            out[n - 1:, 4] = 0.0 if path.shape[1] > 4 else out[n - 1:, -1]
        return out

    # ------------------------------------------------------------------
    def _tire_end_idx(self) -> int:
        """Grid points of the SQP window's tire-end assumption."""
        return int(np.ceil(self.cfg.delaycomp * 50
                           / float(self.lat.sampled_resolution)))

    def _sqp_warm_start(self, action_id, is_follow, param_vel, gg_pad,
                        var_friction):
        """``(key, x0, tire_end_mps2)`` of one action's SQP solve: the
        previous solution stored under ``(plan, action)`` (cold: 20 m/s,
        VpSQP:64), on the "slr" plan shifted by the distance travelled
        since the anchor, which it then moves (VpSQP.py:297-340)."""
        plan = "f" if is_follow else "slr"
        key = (plan, action_id)
        x0 = self.sqp_state.get(key)
        if x0 is None:
            x0 = np.full(self.P, 20.0, np.float32)
        if plan == "slr":
            step = float(self.lat.sampled_resolution)
            s_glob = hostmath.get_s_coord(self.np_raceline, param_vel[0, 0:2],
                                          self.np_s_rl, closed=True)[0]
            old = self.sqp_s_glob_old
            if old is None:
                push = 1
            elif np.round(s_glob) >= np.round(old):
                push = (0 if np.round(s_glob) == np.round(old)
                        else int(np.ceil((s_glob - old) / step)))
            elif old > s_glob and s_glob - old < -100:
                push = int(np.ceil((s_glob + self.np_s_rl[-1] - old) / step))
            else:
                push = 1
            push = min(max(push, 0), self.P - 1)
            if push:
                x0 = np.concatenate([x0[push:],
                                     np.full(push, x0[-1], np.float32)])
            self.sqp_s_glob_old = s_glob
        tire_end_mps2 = 3.0 if var_friction else float(gg_pad[0, 1])
        self.sqp_x0_used[action_id] = np.asarray(x0, np.float32)
        self.sqp_tire = (self._tire_end_idx(), tire_end_mps2)
        return key, np.asarray(x0, np.float32), tire_end_mps2

    def _backup_brake(self, path_pad, gg_pad, vc_pad, nb, c_len, vel_plan,
                      machines, tire_end_mps2):
        """The ladder's brake profile (P, 7) on the padded backup path of
        ``nb`` points after the ``c_len`` points of the committed course:
        the fb brake profile, or under sqp the reference's QP brake with a
        1 m/s cap (VpSQP.calc_vel_brake_em).  ``nb`` and ``c_len`` enter
        as tensors, as the JAX handler's traced arguments."""
        args = (self._f32(path_pad), self._f32(gg_pad), self._f32(vc_pad),
                self._ints([nb, c_len]), self._f32(vel_plan))
        if self.vp_backend == "sqp":
            return self.steps["brake_sqp"](*args, machines,
                                           self._f32(self.lat.veh_turn),
                                           self._f32(tire_end_mps2))
        return self.steps["brake_fb"](*args)

    def calc_vel_profile(self, cut_index_pos, cut_layer, vel_plan, acc_plan,
                         vel_course, vel_est, vel_max, ax_max_machines,
                         safety_d, gg_scale, local_gg=(5.0, 5.0),
                         incl_emerg_traj=False):
        """OTH.calc_vel_profile:603-1040."""
        lat = self.lat
        cfg = self.cfg
        sqp = self.vp_backend == "sqp"

        # normalize local gg (OTH:649-666); a dict means per-point friction
        # (the reference SQP's 3 m/s^2 tire-end assumption, VpSQP.py:74-79)
        var_friction = isinstance(local_gg, dict)
        if not isinstance(local_gg, dict):
            if not isinstance(local_gg, tuple) or len(local_gg) != 2:
                raise ValueError("Provided local_gg does not satisfy the "
                                 "requested format!")
            gg_bounds = tuple(local_gg)
            local_gg = {aid: [np.ones((p[i].shape[0], 2), np.float32) * gg_bounds
                              for i in range(len(p))]
                        for aid, p in ((a, self.last_path_param[a])
                                       for a in self.last_path_param)}

        self.traj_base_id += 10
        traj_time_stamp = time.time()

        if self.old_gg_scale is None:
            self.old_gg_scale = gg_scale

        machines = self._f32(np.atleast_2d(np.asarray(ax_max_machines,
                                                      np.float32)))
        ctrl = cfg.control_params

        new_bp = {}
        action_set_path_id = {}
        self.last_path_gg = {} if self.last_path_gg is None else self.last_path_gg
        new_path_gg = {}
        # the SQP inputs used this tick, per action (observability)
        self.sqp_x0_used = {}
        self.sqp_tire = None

        # opponent summary for follow mode (device, once per tick)
        follow_needed = "follow" in self.last_path_param and self.obj_veh
        if follow_needed and self.closest_obj_index is not None:
            c_obj = self.obj_veh[self.closest_obj_index]
            opp = self.steps["opponent"](self._f32(c_obj.pos)[None],
                                         self._f32([c_obj.vel]))
        else:
            opp = (self._f32(0.0),
                   torch.zeros((vp.F_CAP,), dtype=torch.float32,
                               device=self.dev),
                   torch.ones((vp.F_CAP,), dtype=torch.float32,
                              device=self.dev))

        prefix_became_inactive = vel_plan <= (vel_max + 0.1)

        vc_pad = np.zeros((self.P,), np.float32)
        c_len = min(len(vel_course), self.P)
        vc_pad[:c_len] = vel_course[:c_len]

        # ---- pass 1: cut every action and gather its velocity inputs ------
        # (under sqp also its warm start, in the reference's action order:
        # the first action on the "slr" plan shifts by the distance
        # travelled since the last tick, later ones by 0)
        jobs = []       # (action_id, i, n_valid, is_follow, path, gg, row,
        #                  sqp: (key, x0, tire_end_mps2) or None)
        for action_id in list(self.last_path_param.keys()):
            new_bp[action_id] = []
            new_path_gg[action_id] = []
            action_set_path_id[action_id] = (self.traj_base_id
                                             + ACTION_ID_MAP.get(action_id, 9))

            for i in range(len(self.last_path_param[action_id])):
                # ---- cut at position / layer (OTH:703-731) ---------------
                param_vel = self.last_path_param[action_id][i][cut_index_pos:, :]
                gg_vel = local_gg[action_id][i][cut_index_pos:, :]
                ni = np.asarray(self.last_node_idx[action_id][i])
                cut_index_layer = int(ni[cut_layer])
                self.last_node_idx[action_id][i] = ni[cut_layer:] - cut_index_layer
                self.last_path_param[action_id][i] = \
                    self.last_path_param[action_id][i][cut_index_layer:, :]
                new_path_gg[action_id].append(
                    local_gg[action_id][i][cut_index_layer:, :])
                self.last_coeff[action_id][i] = \
                    self.last_coeff[action_id][i][cut_layer:, :]
                self.last_nodes[action_id][i] = \
                    self.last_nodes[action_id][i][cut_layer:]

                if param_vel.shape[0] == 0:
                    new_bp[action_id].append(np.zeros((0, 7), np.float32))
                    continue
                new_bp[action_id].append(None)      # filled in pass 2

                # ---- follow-mode object distance (OTH:762-785) -----------
                is_follow = action_id == "follow"
                obj_dist = 0.0
                v_obj = 0.0
                if is_follow:
                    if self.closest_obj_index is None:
                        obj_dist = 0.0
                        v_obj = 0.0
                    else:
                        c_obj = self.obj_veh[self.closest_obj_index]
                        v_obj = c_obj.vel
                        s_arr = np.cumsum(param_vel[:, 4])
                        s_obj = hostmath.get_s_coord(param_vel[:, 0:2],
                                                     c_obj.pos, s_arr)[0]
                        s_start = hostmath.get_s_coord(param_vel[:, 0:2],
                                                       self.pos_est, s_arr)[0]
                        obj_dist = s_obj - s_start

                # ---- raceline end velocity (OTH:836-867) -----------------
                end_node = self.last_nodes[action_id][i][-1]
                rl_i = int(self.np_rl_idx[end_node[0]])
                raceline_offset = abs(end_node[1] - rl_i) * lat.lat_offset
                v_end_rl = float(self.np_vel_rl[end_node[0]])
                v_end_rl -= min(v_end_rl * lat.vel_decrease_lat * raceline_offset,
                                v_end_rl)
                red_len = bool(self.last_red_len[action_id][i])

                n_valid = param_vel.shape[0]
                path_pad = self._pad_path(param_vel)
                gg_pad = np.ones((self.P, 2), np.float32) * 5.0
                gg_pad[:gg_vel.shape[0]] = gg_vel
                if gg_vel.shape[0] and gg_vel.shape[0] < self.P:
                    gg_pad[gg_vel.shape[0]:] = gg_vel[-1]
                sqp_job = None
                if sqp:
                    sqp_job = self._sqp_warm_start(action_id, is_follow,
                                                   param_vel, gg_pad,
                                                   var_friction)
                jobs.append((action_id, i, n_valid, is_follow, path_pad,
                             gg_pad, [float(red_len), v_end_rl, obj_dist,
                                      v_obj, float(is_follow)], sqp_job))

        # ---- every action's profile in one call ---------------------------
        if jobs:
            shared = self._f32([vel_plan, vel_est, vel_max, gg_scale,
                                self.old_gg_scale, cfg.v_max_offset,
                                safety_d, lat.veh_length, ctrl["c_p"],
                                ctrl["k_d"], ctrl["k_p"],
                                ctrl.get("tan_w", 1.0)])
            sqp_in = None
            if sqp:
                sqp_in = dict(
                    sqp_x0=self._f32(np.stack([j[7][1] for j in jobs])),
                    is_overtake=torch.as_tensor(
                        [j[0] in ("left", "right") for j in jobs],
                        device=self.dev),
                    veh_turn=self._f32(lat.veh_turn),
                    tire_end_mps2=self._f32([j[7][2] for j in jobs]))
            out = self.steps["velocity"](
                self._f32(np.stack([j[4] for j in jobs])),
                self._f32(np.stack([j[5] for j in jobs])), self._f32(vc_pad),
                self._ints([c_len] + [j[2] for j in jobs]), shared,
                self._f32([j[6] for j in jobs]), machines, opp, sqp_in)
            trajs = _np(out["traj"])
            vel_bounds = _np(out["vel_bound"])
            too_close = _np(out["too_close"])
            v_controls = _np(out["follow_v_control"])
            control_d = float(out["follow_control_d"])
            if sqp:
                # the next tick's warm start; infeasible solves keep the
                # previous one (VpSQP.py:244, 433-434)
                status = _np(out["qp_status"])
                vx_sqp = _np(out["vx_sqp"])
                for r, job in enumerate(jobs):
                    if int(status[r]) != -3:
                        self.sqp_state[job[7][0]] = vx_sqp[r].astype(
                            np.float32)

        # ---- pass 2: assemble / infeasibility ladder (OTH:943-1015) -------
        for r, (action_id, i, n_valid, is_follow, _, _, row, sqp_job) in \
                enumerate(jobs):
            obj_dist, v_obj = row[2], row[3]
            vel_bound = bool(vel_bounds[r])
            if is_follow and bool(too_close[r]):
                LOG.warning("Too close to object! Entering safety "
                            "distance... [Follow-Mode]")
            # follow-mode controller log (reference
            # calc_vel_profile_follow.py:241-245)
            if is_follow and \
                    "follow_mode_logger" in logging.Logger.manager.loggerDict:
                logging.getLogger("follow_mode_logger").info(
                    "%s;%s;%s;%s;%s;%s", time.time(), obj_dist, control_d,
                    float(v_controls[r]), v_obj, vel_est)
            bp_out = trajs[r, :n_valid]

            if vel_bound or action_id in ("follow", "straight"):
                if vel_bound or self.backup_nodes is None:
                    new_bp[action_id][i] = bp_out
                else:
                    LOG.warning("Detected iterative infeasibility and "
                                "triggered deceleration on old path!")
                    bni = np.asarray(self.backup_node_idx)
                    b_cut_l = int(bni[cut_layer])
                    self.last_node_idx[action_id][i] = bni[cut_layer:] - b_cut_l
                    self.last_path_param[action_id][i] = \
                        self.backup_path_param[b_cut_l:, :]
                    new_path_gg[action_id][i] = self.backup_path_gg[b_cut_l:, :]
                    self.last_coeff[action_id][i] = self.backup_coeff[cut_layer:, :]
                    self.last_nodes[action_id][i] = list(self.backup_nodes[cut_layer:])

                    bpp = self.backup_path_param[cut_index_pos:, :]
                    bgg = self.backup_path_gg[cut_index_pos:, :]
                    nb = bpp.shape[0]
                    path_pad = self._pad_path(bpp)
                    gg_pad = np.ones((self.P, 2), np.float32) * 5.0
                    gg_pad[:nb] = bgg
                    traj = self._backup_brake(
                        path_pad, gg_pad, vc_pad, nb, c_len, vel_plan,
                        machines, sqp_job[2] if sqp else None)
                    new_bp[action_id][i] = _np(traj)[:nb]
            else:
                LOG.warning("Removed action set, since vel constraints "
                            "were broken! (Action Set: %s)", action_id)
                self.last_coeff[action_id][i] = np.zeros((0, 8))
                self.last_path_param[action_id][i] = np.zeros((0, 5))
                new_path_gg[action_id][i] = np.zeros((0, 2))
                self.last_nodes[action_id][i] = []
                self.last_node_idx[action_id][i] = np.zeros((0,), int)

        # drop empty action sets (OTH:1017-1025)
        for action_id in list(new_bp.keys()):
            if not any(len(n) > 0 for n in self.last_nodes[action_id]):
                self.last_coeff.pop(action_id)
                self.last_path_param.pop(action_id)
                new_path_gg.pop(action_id)
                self.last_nodes.pop(action_id)
                self.last_node_idx.pop(action_id)
                self.last_red_len.pop(action_id)
                new_bp.pop(action_id)
                action_set_path_id.pop(action_id)

        self.last_path_gg = new_path_gg
        if prefix_became_inactive:
            self.old_gg_scale = gg_scale

        # ---- emergency trajectory (OTH:1027-1034) -------------------------
        if incl_emerg_traj and new_bp:
            self.em_base_id = next(iter(new_bp))
            base = new_bp[self.em_base_id][0]
            nb = base.shape[0]
            traj_pad = np.zeros((self.P, 7), np.float32)
            traj_pad[:nb] = base
            if nb:
                traj_pad[nb:] = base[-1]
            gg_pad = np.ones((self.P, 2), np.float32) * 5.0
            g = local_gg.get(self.em_base_id)
            if g is not None:
                gseg = g[0][cut_index_pos:, :]
                gg_pad[:gseg.shape[0]] = gseg
            em = _np(self.steps["emergency"](self._f32(traj_pad),
                                             self._f32(gg_pad)))[:nb]
            new_bp["emergency"] = [em]
            action_set_path_id["emergency"] = action_set_path_id[self.em_base_id]

        self.last_bp_action_set = new_bp
        path_coord_list = [item[:, 1:3] for sub in new_bp.values()
                           for item in sub]
        return new_bp, action_set_path_id, traj_time_stamp, path_coord_list
