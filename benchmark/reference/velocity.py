"""Velocity profiles of the plain reference: the forward-backward solver's
passes over point sequences (friction circle of the local gg, machine
acceleration limit, drag), many rows at once, float64 NumPy.

A row is a sequence of points with curvature ``k``, the distance ``ds``
to the next point and a speed cap; every pass returns the speed at every
point."""

from __future__ import annotations

import numpy as np


class Car:
    """The longitudinal model: local gg ``(ax, ay)``, machine limit table
    ``machines`` ([v, ax] rows, linear between, constant outside), drag
    ``v^2 * drag / mass`` and the friction shape exponent."""

    def __init__(self, ax, ay, machines, drag, mass, exp=1.0):
        self.ax, self.ay = float(ax), float(ay)
        self.machines = np.asarray(machines, float)
        self.drag, self.mass, self.exp = float(drag), float(mass), float(exp)

    def tires(self, v, k):
        """Longitudinal acceleration the tires have left at speed v on
        curvature |k|."""
        used = np.clip(v * v * np.abs(k) / max(self.ay, 1e-9), 0.0, 1.0)
        return self.ax * np.maximum(1.0 - used ** self.exp, 0.0) \
            ** (1.0 / self.exp)

    def drag_acc(self, v):
        return v * v * self.drag / self.mass

    def machine(self, v):
        return np.interp(v, self.machines[:, 0], self.machines[:, 1])


def forward(car: Car, k, ds, cap, v0):
    """Accelerate from ``v0`` as far as tires, machine and ``cap`` allow:
    ``k``, ``ds``, ``cap`` (R, T) -> (R, T) with column 0 ``min(v0,
    cap[:, 0])``."""
    R, T = k.shape
    v = np.empty((R, T))
    v[:, 0] = np.minimum(v0, cap[:, 0])
    for i in range(T - 1):
        u = v[:, i]
        acc = np.minimum(car.tires(u, k[:, i]), car.machine(u)) \
            - car.drag_acc(u)
        v[:, i + 1] = np.minimum(
            np.sqrt(np.maximum(u * u + 2 * acc * ds[:, i], 0.0)),
            cap[:, i + 1])
    return v


def brake(car: Car, k, ds, v0):
    """Full braking from ``v0`` (tires and drag), no cap."""
    R, T = k.shape
    v = np.empty((R, T))
    v[:, 0] = v0
    for i in range(T - 1):
        u = v[:, i]
        dec = car.tires(u, k[:, i]) + car.drag_acc(u)
        v[:, i + 1] = np.sqrt(np.maximum(u * u - 2 * dec * ds[:, i], 0.0))
    return v


def backward(car: Car, k, ds, v_fwd):
    """Walk back from the last point of ``v_fwd``: the speed at point i is
    the most from which the car can still brake to the speed at i+1, the
    deceleration the lesser of the tires' at i+1 and at the estimate at i,
    and never above ``v_fwd``."""
    R, T = k.shape
    v = np.empty((R, T))
    v[:, T - 1] = v_fwd[:, T - 1]
    for i in range(T - 2, -1, -1):
        u = v[:, i + 1]
        dec = car.tires(u, k[:, i + 1]) + car.drag_acc(u)
        est = np.sqrt(u * u + 2 * dec * ds[:, i])
        dec2 = car.tires(est, k[:, i]) + car.drag_acc(est)
        v[:, i] = np.minimum(
            np.sqrt(np.maximum(u * u + 2 * np.minimum(dec, dec2) * ds[:, i],
                               0.0)), v_fwd[:, i])
    return v


def stop_distance(v, ds, v_min: float = 0.1):
    """Distance covered while the speed stays above ``v_min``."""
    return np.where(v > v_min, ds, 0.0).sum(-1)


def accelerations(v, ds):
    """(v[i+1]^2 - v[i]^2) / (2 ds[i]), zero where ds is zero; one fewer
    column."""
    dv2 = v[..., 1:] ** 2 - v[..., :-1] ** 2
    d = ds[..., :-1]
    return np.where(d > 1e-9, dv2 / np.maximum(2 * d, 1e-9), 0.0)
