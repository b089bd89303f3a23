"""Opponent object-list dummy — replays the global raceline at scaled speed
(reference testing_tools/src/objectlist_dummy.py:60-210).  Callable
in-process or published over ZMQ (``publish_loop``) to mimic the vehicle's
perception interface (PUB tcp://*:47209, topic ``v2x_to_all``)."""

from __future__ import annotations

import time

import numpy as np

from graphbasedlocaltrajectoryplanner_torch.models.track import (
    GlobalTrajectory, import_globtraj_csv)


def _heading_num_np(path: np.ndarray, el_lengths: np.ndarray) -> np.ndarray:
    """Numpy heading of a closed polyline (same chord semantics as
    ops.heading.calc_head_curv_num, psi-step 1 m); the dummy is a host-side
    tool and touches no device."""
    step = max(round(1.0 / float(np.mean(el_lengths))), 1)
    d = np.roll(path, -step, axis=0) - np.roll(path, step, axis=0)
    psi = np.arctan2(d[:, 1], d[:, 0]) - np.pi / 2.0
    return np.mod(psi + np.pi, 2.0 * np.pi) - np.pi


class ObjectlistDummy:
    def __init__(self, dynamic: bool, vel_scale: float = 0.5, s0: float = 0.0,
                 globtraj: GlobalTrajectory = None,
                 globtraj_path: str = None,
                 clock=None):
        """:param clock: injectable time source (defaults to wall clock) so
        simulations can run faster than real time."""
        self._dynamic = dynamic
        self._clock = clock if clock is not None else time.time
        if dynamic:
            if globtraj is None:
                if globtraj_path is None:
                    raise ValueError("dynamic mode needs a global trajectory")
                globtraj = import_globtraj_csv(globtraj_path)
            raceline = globtraj.raceline
            self._raceline = raceline
            self._s_rl = np.cumsum(globtraj.el_lengths)
            psi = _heading_num_np(np.asarray(raceline),
                                  np.asarray(globtraj.el_lengths))
            self._psi_rl = np.where(psi < 0.0, psi + 2 * np.pi, psi)
            self._vel_rl = globtraj.vel_rl * vel_scale
        self._tic = self._clock()
        self.s = s0

    def get_objectlist(self):
        if not self._dynamic:
            return [{"X": 127.0, "Y": 82.0, "theta": 0.0, "type": "physical",
                     "id": 1, "length": 5.0, "width": 2.5, "v": 0.0}]
        toc = self._clock() - self._tic
        self._tic = self._clock()
        t = 0.0
        dt = 0.001
        while t < toc:
            self.s += np.interp(self.s, self._s_rl, self._vel_rl) * dt
            t += dt
            if self.s >= self._s_rl[-1]:
                self.s = 0.0
        pos = [float(np.interp(self.s, self._s_rl, self._raceline[:, 0])),
               float(np.interp(self.s, self._s_rl, self._raceline[:, 1]))]
        psi = float(np.interp(self.s, self._s_rl, self._psi_rl))
        if psi > np.pi:
            psi -= 2 * np.pi
        vel = float(np.interp(self.s, self._s_rl, self._vel_rl))
        return [{"X": pos[0], "Y": pos[1], "theta": psi, "type": "physical",
                 "id": 1, "length": 5.0, "v": vel}]


def publish_tick(sock, dummy, topic: str = "v2x_to_all"):
    """One publisher iteration: advance the dummy, send [topic, json] as a
    two-part message (reference objectlist_dummy.py:204-207 wire format).
    Shared by :func:`publish_loop` and the loopback wire test
    (tests/test_zmq_wire.py).  Returns the sent list."""
    import zmq
    obj_list = dummy.get_objectlist()
    sock.send_string(topic, zmq.SNDMORE)
    sock.send_json(obj_list)
    return obj_list


def publish_loop(globtraj_path: str, vel_scale: float = 0.5,
                 port: int = 47209, topic: str = "v2x_to_all"):
    """Standalone ZMQ publisher (reference objectlist_dummy.py:192-210).
    Requires pyzmq; degrades with a clear error if unavailable."""
    try:
        import zmq
    except ImportError as e:       # pragma: no cover
        raise RuntimeError("pyzmq is not installed in this environment; use "
                           "ObjectlistDummy in-process instead") from e
    ctx = zmq.Context()
    sock = ctx.socket(zmq.PUB)
    sock.bind(f"tcp://*:{port}")
    dummy = ObjectlistDummy(dynamic=True, vel_scale=vel_scale,
                            globtraj_path=globtraj_path)
    try:
        while True:
            publish_tick(sock, dummy, topic)
            time.sleep(0.1)
    except KeyboardInterrupt:
        # graceful shutdown: clear all zones/objects twice before closing
        # (reference objectlist_dummy.py:40-53 SIGINT handler)
        print("Clearing all zones and objects...")
        for _ in range(2):
            sock.send_string(topic, zmq.SNDMORE)
            sock.send_json([])
            time.sleep(0.5)
    finally:
        sock.close()
        ctx.term()


def main():       # pragma: no cover - thin CLI (reference __main__ block)
    import argparse
    ap = argparse.ArgumentParser(
        description="standalone ZMQ object-list publisher")
    ap.add_argument("--track", required=True)
    ap.add_argument("--vel-scale", type=float, default=0.5)
    ap.add_argument("--port", type=int, default=47209)
    args = ap.parse_args()
    publish_loop(args.track, vel_scale=args.vel_scale, port=args.port)


if __name__ == "__main__":       # pragma: no cover
    main()
