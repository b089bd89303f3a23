"""Whole runs on the CPU (the program's plain path, no look for a card)
with the timed path broken underneath: each fault the cell can have makes
``correct`` come out false (the cell runs on one card: no exchange
between chips to leave out)."""

import dataclasses

import pytest
import torch

from benchmark.tests import helpers


def stale(tick):
    """Each call returns the previous call's outputs (its state unchanged)."""
    prev = {}

    def f(scen, **kw):
        out = tick(scen, **kw)
        old = prev.get("out", out)
        prev["out"] = out
        return old
    return f


def half(tick):
    """Half of the batch left out: the first half's answers stand for the
    second half too."""
    def f(scen, **kw):
        h = scen.start_layer.shape[0] // 2
        sub = dataclasses.replace(scen, **{
            k.name: getattr(scen, k.name)[:h]
            for k in dataclasses.fields(scen)})
        out = tick(sub, **kw)
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return f


def altered(tick):
    """Every trajectory moved 5 mm where it is produced."""
    def f(scen, **kw):
        out = dict(tick(scen, **kw))
        t = out["trajs"].clone()
        t[..., 1] += 0.005
        out["trajs"] = t
        return out
    return f


@pytest.mark.parametrize("fault", [stale, half, altered])
def test_fleet_fault_is_not_correct(fault):
    res, checks = helpers.run(fault=fault)
    assert not res["correct"], checks
    assert res["failed"] > 0
