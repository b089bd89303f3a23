"""Closed-loop drive of a ``GraphLTPL`` facade, recorded and replayed.

:func:`drive` runs the reference's loop ``calc_paths -> vdc_dummy ->
calc_vel_profile -> log`` for a number of ticks under a fake clock that
advances 0.1 s per tick, and records each tick's inputs (previous action,
object list, zones, ego position and velocity) and outputs (the action set
and its node chains).  Given a recorded stream it replays those inputs
open-loop instead of closing the loop, so a second planner (another
backend, or the plain versions on the same device) sees exactly the first
one's inputs and deviations cannot compound through the vehicle dummy.
Both runs read the same clock readings, so the calc-time feedback of the
handler (constant path split, trajectory stamps) is identical too.

The drive is duck-typed over the facade; it works with any object that has
the ``GraphLTPL`` API and a ``_oth.last_nodes`` action-node map.
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.testing_tools.vdc_dummy import (
    vdc_dummy)

TICK_DT = 0.1
VEL_MAX = 70.0
MACHINES = np.array([[0.0, 5.0], [100.0, 5.0]], np.float32)
SAFETY_D = 30.0
ACTION_PRIORITY = ("right", "left", "straight", "follow")


class FakeClock:
    def __init__(self, t0: float = 1_000_000.0):
        self.t = t0

    def time(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StepClock(FakeClock):
    """A fake clock that a loop reads once a tick: each call advances it by
    ``dt`` and returns the new time, so the loop's vehicle moves ``dt`` a
    tick; ``time()`` reads it without advancing (for ``fake_time``)."""

    def __init__(self, dt: float = TICK_DT, t0: float = 1_000_000.0):
        super().__init__(t0)
        self.dt = dt

    def __call__(self) -> float:
        self.advance(self.dt)
        return self.t


@contextlib.contextmanager
def fake_time(clock: FakeClock):
    """``time.time`` reads ``clock`` inside the block (every module that
    calls ``time.time()`` sees it)."""
    real = time.time
    time.time = clock.time
    try:
        yield clock
    finally:
        time.time = real


def start_pose(refline: np.ndarray, i: int = 0):
    """The pose at reference-line point ``i``, heading along the line
    (0 = north)."""
    pos = np.asarray(refline[i, :], float).copy()
    heading = float(np.arctan2(refline[i + 1, 1] - refline[i, 1],
                               refline[i + 1, 0] - refline[i, 0]) - np.pi / 2)
    return pos, heading


def slow_opponent(raceline: np.ndarray, normvec: np.ndarray,
                  s_rl: np.ndarray):
    """Object list per tick: none before tick 8, then one opponent replaying
    the raceline at 9 m/s from 170 m on; from tick 14 on it runs 2.5 m to
    the right of the raceline (along the track normal).  On the raceline
    only a right overtake fits past it on the built-in oval; shifted, a
    left one does, so the drive reaches every action kind."""
    track_len = float(s_rl[-1])
    v_opp = 9.0

    def obj_list(tick):
        if tick < 8:
            return []
        s = (170.0 + v_opp * TICK_DT * tick) % track_len
        i = int(np.argmin(np.abs(s_rl - s)))
        off = 2.5 if tick >= 14 else 0.0
        x, y = raceline[i] + normvec[i] * off
        return [{"X": float(x), "Y": float(y), "theta": 0.0,
                 "type": "physical", "id": 1, "length": 4.7, "v": v_opp}]
    return obj_list


def left_half_zone(nodes_in_layer: np.ndarray):
    """A static zone blocking the left half of layers 30-32, in the
    facade's ``blocked_zones`` format (zone type "nodes")."""
    lay, nod = [], []
    for la in (30, 31, 32):
        for n in range(int(nodes_in_layer[la]) // 2):
            lay.append(la)
            nod.append(n)
    return {"z1": [lay, nod, np.zeros((2, 2)), np.zeros((2, 2))]}


def drive(ltpl, n_ticks: int, pos, heading, obj_list=None, zones=None,
          replay=None, on_tick=None, fake_clock: bool = True, timings=None,
          vel_kw=None):
    """Drive ``ltpl`` (``graph_init`` done) for ``n_ticks`` ticks under a
    fresh fake clock (or the real one, ``fake_clock=False``), with the
    emergency trajectory in every action set.

    :param obj_list: ``tick -> object list`` (default: none).
    :param zones: ``blocked_zones`` passed every tick (default: none).
    :param replay: a record list of an earlier drive; its inputs are
        replayed open-loop (``pos``, ``heading``, ``obj_list`` and ``zones``
        then only set the start).
    :param on_tick: called as ``on_tick(tick)`` after each tick.
    :param timings: a list that receives each tick's host-clock seconds of
        ``calc_paths`` + ``calc_vel_profile`` (the planner's work; the
        vehicle dummy and the log are outside).
    :param vel_kw: ``vel_kw(tick, ltpl) -> dict`` of ``calc_vel_profile``
        arguments that replace the defaults (``vel_max``, ``gg_scale``,
        ``local_gg``) on that tick — a dynamic-parameter schedule, computed
        from each planner's own state on replay too.
    :returns: record list, one dict per tick: ``sel``, ``objects``,
        ``pos``, ``vel`` (inputs), ``traj_set`` and ``nodes`` (outputs).
    """
    clock = FakeClock()
    records = []
    with (fake_time(clock) if fake_clock else contextlib.nullcontext()):
        if ltpl.set_startpos(pos_est=pos, heading_est=heading):
            raise RuntimeError("start pose is off the track or misaligned")
        traj_set = {"straight": None}
        vel = 0.0
        for tick in range(n_ticks):
            if replay is not None:
                rec = replay[tick]
                sel, objs = rec["sel"], rec["objects"]
            else:
                sel = next(a for a in ACTION_PRIORITY if a in traj_set)
                objs = obj_list(tick) if obj_list is not None else []
            t0 = time.perf_counter()
            ltpl.calc_paths(prev_action_id=sel, object_list=objs,
                            blocked_zones=zones)
            t_paths = time.perf_counter() - t0
            if replay is not None:
                pos, vel = rec["pos"], rec["vel"]
            elif traj_set[sel] is not None:
                t = traj_set[sel][0]
                pos, vel = vdc_dummy(pos, t[:, 0], t[:, 1:3], t[:, 5],
                                     TICK_DT)
            t0 = time.perf_counter()
            kw = dict(vel_max=VEL_MAX, ax_max_machines=MACHINES,
                      safety_d=SAFETY_D, incl_emerg_traj=True)
            if vel_kw is not None:
                kw.update(vel_kw(tick, ltpl))
            traj_set = ltpl.calc_vel_profile(pos_est=pos, vel_est=vel,
                                             **kw)[0]
            if timings is not None:
                timings.append(t_paths + time.perf_counter() - t0)
            ltpl.log()
            records.append(dict(
                sel=sel, objects=copy.deepcopy(objs), pos=pos, vel=vel,
                traj_set={k: [np.array(t) for t in v]
                          for k, v in traj_set.items()},
                nodes={k: [[list(n) for n in chain] for chain in v]
                       for k, v in ltpl._oth.last_nodes.items()}))
            if on_tick is not None:
                on_tick(tick)
            clock.advance(TICK_DT)
    return records


def compare(rec_a, rec_b):
    """Tick-by-tick comparison of two drives over the same inputs.

    Raises AssertionError at the first tick whose action-set keys, node
    chains or trajectory lengths differ.  Returns the maxima over every
    tick and action: ``d_pos`` (s, x, y in m) and ``d_vx`` (m/s), and the
    set of action names seen."""
    if len(rec_a) != len(rec_b):
        raise AssertionError(f"{len(rec_a)} ticks != {len(rec_b)} ticks")
    d_pos = d_vx = 0.0
    seen = set()
    for tick, (a, b) in enumerate(zip(rec_a, rec_b)):
        if list(a["traj_set"]) != list(b["traj_set"]):
            raise AssertionError(f"tick {tick}: action sets "
                                 f"{list(a['traj_set'])} != "
                                 f"{list(b['traj_set'])}")
        if a["nodes"] != b["nodes"]:
            raise AssertionError(f"tick {tick}: node chains differ")
        for k, trajs in a["traj_set"].items():
            seen.add(k)
            for ta, tb in zip(trajs, b["traj_set"][k]):
                if ta.shape != tb.shape:
                    raise AssertionError(f"tick {tick} {k}: shape "
                                         f"{ta.shape} != {tb.shape}")
                if ta.size == 0:
                    continue
                d = np.abs(ta.astype(np.float64) - tb.astype(np.float64))
                d_pos = max(d_pos, float(d[:, 0:3].max()))
                d_vx = max(d_vx, float(d[:, 5].max()))
    return d_pos, d_vx, seen
