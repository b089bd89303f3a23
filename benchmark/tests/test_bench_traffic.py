"""The generator makes the same inputs from the same seed, and other
inputs from another, for any whole seed."""

import numpy as np
import pytest

from benchmark import core, fleet, scenarios
from benchmark.tests import helpers


def _equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in scenarios.FIELDS)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5])
def test_fleet_batches_repeat_from_the_seed(seed):
    _, cfg, mix = helpers.cell()
    mix = helpers.small_fleet_mix(mix)
    lat = helpers.ref_lattice(cfg["name"])
    a = fleet.make_batches(lat, mix, seed)
    b = fleet.make_batches(lat, mix, seed)
    c = fleet.make_batches(lat, mix, seed + 1)
    assert len(a) == mix["n_batches"]
    assert all(_equal(x, y) for x, y in zip(a, b))
    assert not _equal(a[0], c[0])
    assert not _equal(a[0], a[1])
    # every seed gives the same shapes (one signature)
    assert all(x[k].shape == y[k].shape for x, y in zip(a, c)
               for k in scenarios.FIELDS)


def test_short_horizon_starts_and_committed_paths():
    _, cfg, mix = helpers.cell()
    lat = helpers.ref_lattice(cfg["name"])
    b = scenarios.batch(lat, dict(mix, batch=512), 3)
    assert mix["short_horizon_starts"]
    assert (lat.h_goal[b["start_layer"]] < lat.H_max).all()
    full = scenarios.batch(lat, dict(core.traffic("fleet_b1024"), batch=512),
                           3)
    assert (lat.h_goal[full["start_layer"]] == lat.H_max).any()
    # the committed path is real edge samples: the ego is behind its start
    # node, never on it
    start = lat.node_pos[b["start_layer"], b["start_node"]]
    assert (np.hypot(*(b["pos_est"] - start).T) > 1.0).all()
    assert (b["const_path"][np.arange(512), b["const_n"] - 1, 4] > 0).all()
    # opponents are jittered off the nodes
    d = b["obj_pos"][:, 0, None, None] - lat.node_pos[None]
    assert (np.hypot(d[..., 0], d[..., 1]).min(axis=(1, 2)) > 0).all()


def test_checked_rows_repeat_from_the_seed():
    a = fleet.sample_rows(9, 16, 1024, 64)
    assert all(np.array_equal(x, y)
               for x, y in zip(a, fleet.sample_rows(9, 16, 1024, 64)))
    assert all(len(set(x)) == 64 and x.max() < 1024 for x in a)
    assert not np.array_equal(a[0], fleet.sample_rows(10, 16, 1024, 64)[0])


def test_track_csv_is_the_configured_oval():
    _, cfg, _ = helpers.cell()
    lat = helpers.ref_lattice(cfg["name"])
    want = cfg["lattice"]
    assert (lat.L, lat.N, lat.S, lat.H_max, lat.closed) == (
        want["L"], want["N"], want["S"], want["H_max"], want["closed"])
    csv = core.track_csv(cfg)
    assert core.track_csv(cfg) == csv
