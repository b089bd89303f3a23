"""Offline configuration (ltpl_config_offline.ini) — the port's own copy of
the JAX package's ``utils/config.OfflineConfig`` (key names and defaults
match the reference INI)."""

from __future__ import annotations

import configparser
import dataclasses


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
