"""PyTorch port, offline lattice: the carry-across of a JAX lattice, the
JAX npz artifact format, and the port's own builder against the JAX
builder on the small oval and the in-repo unclosed Monteblanco track."""

import numpy as np
import pytest

from graphbasedlocaltrajectoryplanner_tpu.models import lattice as jlat
from graphbasedlocaltrajectoryplanner_torch.models import lattice as tlat
from graphbasedlocaltrajectoryplanner_torch.models import track as ttrack
from graphbasedlocaltrajectoryplanner_torch.utils.config import OfflineConfig

from torch_port_common import (SMALL_OVAL, SMALL_OVAL_CFG, UNCLOSED_CSV,
                               carry, jax_small_oval, jax_unclosed)

EXACT_FIELDS = ["edge_valid", "edge_npts", "rl_idx", "nodes_in_layer",
                "h_goal_for_start", "node_valid", "end_layer_for_start"]


@pytest.fixture(scope="module")
def jax_lattices():
    return {"oval": jax_small_oval(), "unclosed": jax_unclosed()}


def _port_build(track):
    if track == "oval":
        return tlat.build_lattice(ttrack.make_oval_track(**SMALL_OVAL),
                                  OfflineConfig(**SMALL_OVAL_CFG))
    return tlat.build_lattice(ttrack.import_globtraj_csv(UNCLOSED_CSV),
                              OfflineConfig())


def test_carry_across_is_bit_equal(jax_lattices):
    ja = jax_lattices["oval"]
    lat = carry(ja)
    for k in tlat.ARRAY_FIELDS:
        a = np.asarray(getattr(ja, k))
        b = getattr(lat, k).numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in tlat.META_FIELDS:
        assert getattr(lat, k) == getattr(ja, k), k


def test_jax_npz_loads_in_port(jax_lattices, tmp_path):
    ja = jax_lattices["unclosed"]
    path = str(tmp_path / "lat.npz")
    jlat.save_lattice(ja, path)
    lat = tlat.load_lattice(path)
    assert lat is not None
    for k in tlat.ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ja, k)),
                                      getattr(lat, k).numpy(), err_msg=k)
    for k in tlat.META_FIELDS:
        assert getattr(lat, k) == getattr(ja, k), k
    # and the port's own artifact round-trips
    path2 = str(tmp_path / "lat2.npz")
    tlat.save_lattice(lat, path2)
    lat2 = tlat.load_lattice(path2)
    for k in tlat.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(lat, k).numpy(),
                                      getattr(lat2, k).numpy(), err_msg=k)


@pytest.mark.parametrize("track", ["oval", "unclosed"])
def test_builder_matches_jax(jax_lattices, track):
    ja = jax_lattices[track]
    lat = _port_build(track)
    for k in ("L", "N", "S", "H_max", "closed"):
        assert getattr(lat, k) == getattr(ja, k), k
    for k in EXACT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ja, k)),
                                      getattr(lat, k).numpy(), err_msg=k)
    worst = {}
    for k in tlat.ARRAY_FIELDS:
        a = np.asarray(getattr(ja, k))
        if a.dtype.kind != "f":
            continue
        b = getattr(lat, k).numpy()
        assert a.dtype == b.dtype, k
        # absent edges / invalid nodes carry the same INF sentinel
        fin = np.abs(a) < 1e29
        np.testing.assert_array_equal(fin, np.abs(b) < 1e29, err_msg=k)
        d = np.abs(np.where(fin, a - b, 0.0))
        worst[k] = float(d.max()) if d.size else 0.0
        if k == "w":
            rel = d / np.maximum(np.abs(np.where(fin, a, 1.0)), 1e-30)
            assert float(rel.max()) <= 1e-6, (k, float(rel.max()))
        else:
            assert worst[k] <= 1e-5, (k, worst[k])
    print(f"{track}: max |port - jax| per float field: "
          f"{ {k: v for k, v in worst.items() if v > 0} }")
