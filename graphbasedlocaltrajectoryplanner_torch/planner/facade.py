"""Public facade (torch) — counterpart of the JAX package's
``planner/facade.py``, API-compatible with the reference's ``Graph_LTPL``
class (graph_ltpl/Graph_LTPL.py:26-533): construct with a ``path_dict``,
then ``graph_init() -> set_startpos() -> loop[ calc_paths() ->
calc_vel_profile() -> log() -> visual() ]``.

The planner runs on ``device`` (default: the card; without one the
constructor raises unless ``device="cpu"`` is given).  On the card every
stage with a Pallas kernel in the JAX package goes through its CUDA kernel;
``kernels=False`` takes the plain PyTorch versions on the same device.
With ``visual_mode`` the facade draws a live plot
(``visualization/plot_handler.PlotHandler``, matplotlib) from host arrays.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys

import numpy as np

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models import lattice as latmod
from graphbasedlocaltrajectoryplanner_torch.planner.handler import (
    OnlineHandler)
from graphbasedlocaltrajectoryplanner_torch.planner import objects as objmod
from graphbasedlocaltrajectoryplanner_torch.planner import hostmath
from graphbasedlocaltrajectoryplanner_torch.utils.config import OnlineConfig
from graphbasedlocaltrajectoryplanner_torch.utils.logging import DataLogger

# tries to load a previously computed lattice, unless set to True
FORCE_RECALC = False

REQ_PATH_DICT_ENTRIES = ["globtraj_input_path", "graph_store_path",
                         "ltpl_offline_param_path", "ltpl_online_param_path",
                         "graph_log_id", "log_path"]


class GraphLTPL:
    def __init__(self, path_dict: dict, visual_mode: bool = False,
                 log_to_file: bool = True, device=None,
                 kernels: bool = True):
        self._visual_mode = visual_mode
        self._plot_handler = None
        self._device = resolve_device(device)
        self._kernels = kernels
        for entry in REQ_PATH_DICT_ENTRIES:
            if entry not in path_dict:
                if log_to_file or "log" not in entry:
                    raise ValueError("Missing path specification in path_dict "
                                     f'(Missing entry: "{entry}")!')

        self._path_dict = dict(path_dict)
        self._log_to_file = log_to_file
        self._log = logging.getLogger("local_trajectory_logger")

        if log_to_file:
            log_path = path_dict["log_path"]
            os.makedirs(os.path.join(log_path, "Graph_Objects"), exist_ok=True)
            fld = os.path.join(log_path,
                               datetime.datetime.now().strftime("%Y_%m_%d"))
            os.makedirs(fld, exist_ok=True)
            prefix = datetime.datetime.now().strftime("%H_%M_%S")
            self._path_dict["graph_log_msgs_path"] = os.path.join(
                fld, prefix + "_msg.csv")
            self._path_dict["graph_log_data_path"] = os.path.join(
                fld, prefix + "_data.csv")
            self._path_dict["graph_log_path"] = os.path.join(
                log_path, "Graph_Objects", path_dict["graph_log_id"] + ".npz")
            with open(self._path_dict["graph_log_msgs_path"], "w") as fh:
                fh.write("time;type;message\n")

            if not self._log.handlers:
                hdlr = logging.StreamHandler(sys.stdout)
                hdlr.setFormatter(logging.Formatter(
                    "%(levelname)s [%(asctime)s]: %(message)s", "%H:%M:%S"))
                hdlr.addFilter(lambda r: r.levelno < logging.CRITICAL)
                hdlr.setLevel(os.environ.get("LOGLEVEL", "INFO"))
                self._log.addHandler(hdlr)
                hdlr_e = logging.StreamHandler()
                hdlr_e.setLevel(logging.CRITICAL)
                self._log.addHandler(hdlr_e)
                fhdlr = logging.FileHandler(
                    self._path_dict["graph_log_msgs_path"])
                fhdlr.setFormatter(logging.Formatter(
                    "%(created)s;%(levelname)s;%(message)s"))
                fhdlr.setLevel(os.environ.get("LOGLEVEL", "INFO"))
                self._log.addHandler(fhdlr)
                self._log.setLevel(logging.DEBUG)

        self._online_cfg = OnlineConfig.from_ini(
            path_dict["ltpl_online_param_path"])

        if log_to_file and self._online_cfg.log_follow_mode:
            # follow-mode controller channel (reference hook
            # calc_vel_profile_follow.py:241-245 / config
            # ltpl_config_online.ini:3-7; the reference expects deployment
            # code to create this logger — we wire it natively so the
            # viewer's follow-debug figure always has data)
            self._path_dict["graph_log_follow_path"] = os.path.join(
                fld, prefix + "_follow.csv")
            with open(self._path_dict["graph_log_follow_path"], "w") as fh:
                fh.write("time;obj_dist;control_dist;v_control;"
                         "v_target;v_ego\n")
            flog = logging.getLogger("follow_mode_logger")
            for h in list(flog.handlers):   # re-point at this run's file
                flog.removeHandler(h)
                h.close()
            fh_f = logging.FileHandler(
                self._path_dict["graph_log_follow_path"])
            fh_f.setFormatter(logging.Formatter("%(message)s"))
            flog.addHandler(fh_f)
            flog.setLevel(logging.INFO)
            flog.propagate = False
        elif "follow_mode_logger" in logging.Logger.manager.loggerDict:
            # a previous run registered the channel — silence it so rows
            # don't leak into that run's file
            flog = logging.getLogger("follow_mode_logger")
            for h in list(flog.handlers):
                flog.removeHandler(h)
                h.close()
        self._obj_list_handler = objmod.ObjectListInterface()

        self._lat = None
        self._oth = None
        self._obj_veh = []
        self._obj_zone = []
        self._action_set = None
        self._action_set_id = None
        self._traj_time = 0.0
        self._pos_est = None
        self._prev_action_id = None
        self._prev_traj_idx = 0
        self._plan_start_node = None
        self._node_list = None
        self._const_path_seg = None
        self._cut_index_pos = None
        self._local_trajectories = None
        self._graph_log_handler = None

    # ------------------------------------------------------------------
    @property
    def lattice(self):
        return self._lat

    def graph_init(self, veh_param_dyn_model_exp: float = 1.0,
                   veh_param_dragcoeff: float = 0.85,
                   veh_param_mass: float = 1000.0) -> None:
        """Offline lattice setup (Graph_LTPL.graph_init:189-258)."""
        graph_id = self._path_dict.get("graph_log_id") or "torch0"
        self._lat, new_base = latmod.load_or_build(
            self._path_dict["globtraj_input_path"],
            self._path_dict["ltpl_offline_param_path"],
            self._path_dict["graph_store_path"],
            force_recalc=FORCE_RECALC,
            graph_id=graph_id)
        self._lat = self._lat.to(self._device)

        self._oth = OnlineHandler(
            self._lat, self._online_cfg,
            veh_param_dyn_model_exp=veh_param_dyn_model_exp,
            veh_param_dragcoeff=veh_param_dragcoeff,
            veh_param_mass=veh_param_mass, kernels=self._kernels)

        self._obj_list_handler.set_track_data(
            refline=self._oth.np_refline,
            normvec_normalized=self._oth.np_normvec,
            w_left=self._oth.np_wl,
            w_right=self._oth.np_wr)

        if self._log_to_file:
            # archive the lattice next to the logs for replay
            gl = self._path_dict.get("graph_log_path")
            if gl and not os.path.isfile(gl):
                latmod.save_lattice(self._lat, gl)
            self._graph_log_handler = DataLogger(
                graph_id=graph_id,
                log_path=self._path_dict["graph_log_data_path"])

        if self._visual_mode:
            from graphbasedlocaltrajectoryplanner_torch.visualization \
                .plot_handler import PlotHandler
            self._plot_handler = PlotHandler(
                plot_title="Local Trajectory - Online Graph",
                include_timeline=True)
            self._plot_handler.plot_lattice(self._lat)

    # ------------------------------------------------------------------
    def set_startpos(self, pos_est, heading_est, vel_est: float = 0.0) -> bool:
        """Returns True if out of track (retry semantics,
        Graph_LTPL.set_startpos:262-296)."""
        if self._oth is None:
            raise ValueError("Could not set start position, since graph is "
                             "not initialized yet. Call graph_init() first!")
        self._pos_est = np.asarray(pos_est, float)
        self._action_set = {"straight": []}
        in_track, cor_heading = self._oth.set_initial_pose(
            start_pos=self._pos_est,
            start_heading=float(np.asarray(heading_est).reshape(-1)[0]),
            start_vel=vel_est,
            max_heading_offset=self._online_cfg.max_heading_offset)
        return not in_track or not cor_heading

    # ------------------------------------------------------------------
    def calc_paths(self, prev_action_id: str, prev_traj_idx: int = 0,
                   object_list: list = None,
                   blocked_zones: dict = None) -> dict:
        """Graph_LTPL.calc_paths:300-340."""
        self._prev_action_id = prev_action_id
        self._prev_traj_idx = prev_traj_idx
        self._obj_veh = self._obj_list_handler.process_object_list(object_list)
        if blocked_zones is not None:
            for zone_id in blocked_zones.keys():
                self._obj_zone = self._obj_list_handler.update_zone(
                    zone_id=zone_id, zone_data=blocked_zones[zone_id],
                    zone_type="nodes")
        self._oth.update_objects(obj_veh=self._obj_veh,
                                 obj_zone=self._obj_zone)
        path_dict, self._plan_start_node, self._node_list, self._const_path_seg = \
            self._oth.calc_paths(action_id_sel=self._prev_action_id,
                                 idx_sel_traj=self._prev_traj_idx)
        return path_dict

    # ------------------------------------------------------------------
    def calc_vel_profile(self, pos_est, vel_est, vel_max: float = 100.0,
                         gg_scale: float = 1.0, local_gg=(5.0, 5.0),
                         ax_max_machines=np.atleast_2d([100.0, 5.0]),
                         safety_d: float = 30.0,
                         incl_emerg_traj: bool = False):
        """Graph_LTPL.calc_vel_profile:344-408."""
        self._pos_est = np.asarray(pos_est, float)
        self._cut_index_pos, cut_layer, vel_plan, vel_course, acc_plan = \
            self._oth.get_ref_idx(action_id_sel=self._prev_action_id,
                                  idx_sel_traj=self._prev_traj_idx,
                                  pos_est=self._pos_est)
        (self._action_set, self._action_set_id, self._traj_time,
         self._local_trajectories) = self._oth.calc_vel_profile(
            cut_index_pos=self._cut_index_pos,
            cut_layer=cut_layer,
            vel_plan=vel_plan,
            acc_plan=acc_plan,
            vel_course=vel_course,
            vel_est=vel_est,
            vel_max=vel_max,
            gg_scale=gg_scale,
            local_gg=local_gg,
            ax_max_machines=ax_max_machines,
            safety_d=safety_d,
            incl_emerg_traj=incl_emerg_traj)

        # trim to export length (Graph_LTPL.py:400-406)
        n_exp = self._online_cfg.nmbr_export_points
        for action_id in self._action_set:
            for i in range(len(self._action_set[action_id])):
                self._action_set[action_id][i] = \
                    self._action_set[action_id][i][:n_exp, :]
        return self._action_set, self._action_set_id, self._traj_time

    # ------------------------------------------------------------------
    def log(self) -> None:
        """Graph_LTPL.log:412-461."""
        if not self._log_to_file or self._graph_log_handler is None:
            return
        s_list, pos_list, vel_list, a_list, psi_list, kappa_list = \
            {}, {}, {}, {}, {}, {}
        for key, trajs in self._action_set.items():
            s_list[key] = [t[:, 0] for t in trajs]
            pos_list[key] = [t[:, 1:3] for t in trajs]
            psi_list[key] = [t[:, 3] for t in trajs]
            kappa_list[key] = [t[:, 4] for t in trajs]
            vel_list[key] = [t[:, 5] for t in trajs]
            a_list[key] = [t[:, 6] for t in trajs]
        s_ego = hostmath.get_s_coord(self._oth.np_raceline,
                                     tuple(self._pos_est),
                                     self._oth.np_s_rl, closed=True)[0]
        const_seg = self._const_path_seg
        if const_seg is not None:
            const_seg = const_seg[self._cut_index_pos:, :]
            self._const_path_seg = const_seg
        self._graph_log_handler.log_onlinegraph(
            time_stamp=self._traj_time, s_coord=s_ego,
            start_node=self._plan_start_node, obj_veh=self._obj_veh,
            obj_zone=self._obj_zone, nodes_list=self._node_list,
            s_list=s_list, pos_list=pos_list, vel_list=vel_list,
            a_list=a_list, psi_list=psi_list, kappa_list=kappa_list,
            traj_id=self._action_set_id, clip_pos=list(self._pos_est),
            action_id_prev=self._prev_action_id,
            traj_id_prev=self._prev_traj_idx,
            const_path_seg=const_seg)

    # ------------------------------------------------------------------
    def visual(self) -> None:
        """Graph_LTPL.visual:465-533 (lightweight live plot); every argument
        is a host array the handler already returned."""
        if not self._visual_mode or self._plot_handler is None:
            return
        self._plot_handler.update_tick(
            trajectories=self._local_trajectories,
            obj_veh=self._obj_veh,
            obj_zone=self._obj_zone,
            pos_est=self._pos_est,
            action_id=self._prev_action_id,
            action_set=self._action_set)
