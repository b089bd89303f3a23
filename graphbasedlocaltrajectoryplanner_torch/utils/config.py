"""Configuration (``ltpl_config_offline.ini``, ``ltpl_config_online.ini``,
``driving_task.ini``) — the port's own copy of the JAX package's
``utils/config.py`` (key names and defaults match the reference INIs;
dicts and lists are JSON-parsed as in Graph_LTPL.py:168-173)."""

from __future__ import annotations

import configparser
import dataclasses
import hashlib
import json


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass
class OfflineConfig:
    """Lattice / offline-build parameters (ltpl_config_offline.ini)."""
    # LATTICE
    lat_resolution: float = 0.5
    variable_heading: bool = True
    lon_straight_step: float = 30.0
    lon_curve_step: float = 10.0
    curve_thr: float = 0.008
    lat_offset: float = 0.25
    virt_goal_n: bool = True
    min_vel_race: float = 0.5
    closure_detection_dist: float = 20.0
    # PLANNINGTARGET
    vel_decrease_lat: float = 0.1
    min_plan_horizon: float = 300.0
    plan_horizon_mode: str = "distance"
    # SAMPLING
    stepsize_approx: float = 2.5
    # VEHICLE
    veh_width: float = 2.8
    veh_length: float = 4.7
    veh_turn: float = 7.0
    # COST
    w_raceline: float = 1.0
    w_raceline_sat: float = 1.0
    w_length: float = 0.0
    w_curv_avg: float = 7500.0
    w_curv_peak: float = 2500.0
    w_virt_goal: float = 10000.0

    @classmethod
    def from_ini(cls, path: str) -> "OfflineConfig":
        cp = configparser.ConfigParser()
        if not cp.read(path):
            raise ValueError(f"offline config {path!r} does not exist or is empty")
        g = cls()
        sec = {
            "LATTICE": ["lat_resolution", "variable_heading", "lon_straight_step",
                        "lon_curve_step", "curve_thr", "lat_offset", "virt_goal_n",
                        "min_vel_race", "closure_detection_dist"],
            "PLANNINGTARGET": ["vel_decrease_lat", "min_plan_horizon",
                               "plan_horizon_mode"],
            "SAMPLING": ["stepsize_approx"],
            "VEHICLE": ["veh_width", "veh_length", "veh_turn"],
            "COST": ["w_raceline", "w_raceline_sat", "w_length", "w_curv_avg",
                     "w_curv_peak", "w_virt_goal"],
        }
        for section, keys in sec.items():
            if section not in cp:
                continue
            for key in keys:
                if key not in cp[section]:
                    continue
                cur = getattr(g, key)
                if isinstance(cur, bool):
                    setattr(g, key, cp.getboolean(section, key))
                elif isinstance(cur, float):
                    setattr(g, key, cp.getfloat(section, key))
                else:
                    setattr(g, key, cp.get(section, key))
        return g


@dataclasses.dataclass
class OnlineConfig:
    """Online planning parameters (ltpl_config_online.ini)."""
    # GENERAL
    cost_dep_color: bool = False
    log_follow_mode: bool = True
    # VESTIGIAL: declared in the reference INI (ltpl_config_online.ini:10)
    # but never read by any reference code path — parsed here only for INI
    # compatibility, intentionally unused.
    max_pos_offset: float = 16.0
    max_heading_offset: float = 0.8
    # VP
    vp_type: str = "fb"
    # ACTIONSET
    v_max_offset: float = 0.1
    max_solutions: int = 1
    max_cost_diff: float = 1.0
    # FOLLOW
    controller_type: str = "PD"
    control_params_PD: dict = dataclasses.field(
        default_factory=lambda: {"c_p": 1.25, "k_d": 0.025, "k_p": 0.2})
    control_params_PDtan: dict = dataclasses.field(
        default_factory=lambda: {"c_p": 1.15, "k_d": 0.025, "k_p": 0.2,
                                 "tan_w": 15.0})
    # SMOOTHING
    filt_window_width: int = 1
    # DELAY
    delaycomp: float = 0.100
    # COST
    w_last_edges: tuple = (0.0, 0.5, 0.8)
    # OBJECTS
    # VESTIGIAL: declared in the reference INI (ltpl_config_online.ini:76)
    # but never read by any reference code path — parsed here only for INI
    # compatibility, intentionally unused.
    zone_opp_width: float = 5.0
    # EXPORT
    nmbr_export_points: int = 115
    # CALC_TIME
    calc_time_warn_threshold: float = 0.1
    calc_time_safety: float = 2.0
    calc_time_buffer_len: int = 5

    @property
    def control_params(self) -> dict:
        return (self.control_params_PD if self.controller_type == "PD"
                else self.control_params_PDtan)

    @classmethod
    def from_ini(cls, path: str) -> "OnlineConfig":
        cp = configparser.ConfigParser()
        if not cp.read(path):
            raise ValueError(f"online config {path!r} does not exist or is empty")
        g = cls()
        getters = {
            ("GENERAL", "cost_dep_color"): lambda: cp.getboolean("GENERAL", "cost_dep_color"),
            ("GENERAL", "log_follow_mode"): lambda: cp.getboolean("GENERAL", "log_follow_mode"),
            ("GENERAL", "max_pos_offset"): lambda: cp.getfloat("GENERAL", "max_pos_offset"),
            ("GENERAL", "max_heading_offset"): lambda: cp.getfloat("GENERAL", "max_heading_offset"),
            ("VP", "vp_type"): lambda: cp.get("VP", "vp_type"),
            ("ACTIONSET", "v_max_offset"): lambda: cp.getfloat("ACTIONSET", "v_max_offset"),
            ("ACTIONSET", "max_solutions"): lambda: cp.getint("ACTIONSET", "max_solutions"),
            ("ACTIONSET", "max_cost_diff"): lambda: cp.getfloat("ACTIONSET", "max_cost_diff"),
            ("FOLLOW", "controller_type"): lambda: cp.get("FOLLOW", "controller_type"),
            ("FOLLOW", "control_params_PD"): lambda: json.loads(cp.get("FOLLOW", "control_params_PD")),
            ("FOLLOW", "control_params_PDtan"): lambda: json.loads(cp.get("FOLLOW", "control_params_PDtan")),
            ("SMOOTHING", "filt_window_width"): lambda: cp.getint("SMOOTHING", "filt_window_width"),
            ("DELAY", "delaycomp"): lambda: cp.getfloat("DELAY", "delaycomp"),
            ("COST", "w_last_edges"): lambda: tuple(json.loads(cp.get("COST", "w_last_edges"))),
            ("OBJECTS", "zone_opp_width"): lambda: cp.getfloat("OBJECTS", "zone_opp_width"),
            ("EXPORT", "nmbr_export_points"): lambda: cp.getint("EXPORT", "nmbr_export_points"),
            ("CALC_TIME", "calc_time_warn_threshold"): lambda: cp.getfloat("CALC_TIME", "calc_time_warn_threshold"),
            ("CALC_TIME", "calc_time_safety"): lambda: cp.getfloat("CALC_TIME", "calc_time_safety"),
            ("CALC_TIME", "calc_time_buffer_len"): lambda: cp.getint("CALC_TIME", "calc_time_buffer_len"),
        }
        for (section, key), fn in getters.items():
            if section in cp and key in cp[section]:
                setattr(g, key, fn())
        return g


def read_track_name(driving_task_ini: str) -> str:
    cp = configparser.ConfigParser()
    if not cp.read(driving_task_ini):
        raise ValueError(f"driving task config {driving_task_ini!r} missing")
    return json.loads(cp.get("DRIVING_TASK", "track"))
