"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py): small
lattices built by the JAX package and carried across to the port bit for
bit, so both sides of a comparison run on identical data."""

import os

import numpy as np

from graphbasedlocaltrajectoryplanner_tpu.models import lattice as jlat
from graphbasedlocaltrajectoryplanner_tpu.models import track as jtrack
from graphbasedlocaltrajectoryplanner_tpu.utils.config import (
    OfflineConfig as JaxOfflineConfig)
from graphbasedlocaltrajectoryplanner_torch.models import lattice as tlat

UNCLOSED_CSV = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))),
    "parity", "fixtures", "traj_ltpl_unclosed_monteblanco.csv")

# the small oval of __graft_entry__._small_lattice (L=45, N=24, S=14, H=20)
SMALL_OVAL = dict(n=200, r=50.0, straight=150.0)
SMALL_OVAL_CFG = dict(min_plan_horizon=200.0)


def jax_small_oval():
    return jlat.build_lattice(jtrack.make_oval_track(**SMALL_OVAL),
                              JaxOfflineConfig(**SMALL_OVAL_CFG),
                              md5_params="graft")


def jax_unclosed():
    return jlat.build_lattice(jtrack.import_globtraj_csv(UNCLOSED_CSV),
                              JaxOfflineConfig(), md5_params="open")


def carry(jax_lattice):
    """The port's lattice holding the JAX lattice's arrays bit for bit."""
    arrays = {k: np.asarray(getattr(jax_lattice, k))
              for k in tlat.ARRAY_FIELDS}
    meta = {k: getattr(jax_lattice, k) for k in tlat.META_FIELDS}
    return tlat.lattice_from_numpy(arrays, meta)
