"""Shared inputs of the PyTorch-port tests (tests/test_torch_*.py): small
lattices built by the JAX package and carried across to the port bit for
bit, so both sides of a comparison run on identical data; made-up profiler
events for the attribution rules of ``parallel/profiling``; the JAX
package's path assembly with the full-horizon refit as the port has it
(:func:`jax_refit_repaired`), the JAX side of comparisons whose rows reach
the full horizon."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from graphbasedlocaltrajectoryplanner_tpu.models import lattice as jlat
from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
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


def jax_fit_with_end_term(points, el, psi_s, psi_e, n_seg, H):
    """The JAX package's ``pathgen._fit_clamped_chain_padded`` (one row)
    with the port's repair: a row with ``n_seg == H`` pins no equation,
    and the last inner equation's term in the end tangent goes to its
    right-hand side (``upper`` 0), as ``ops/splines.fit_clamped_chain``
    has it.  A row with ``n_seg < H`` pins its last equation, which the
    two added selects leave as the package computes it."""
    seg_len = jnp.maximum(el, 1e-9)
    m0 = jpg.heading_to_dir(psi_s)
    mn = jpg.heading_to_dir(psi_e)
    lam = seg_len[:-1] / seg_len[1:]
    dp_over_l = (points[1:] - points[:-1]) / seg_len[:, None]
    rhs = 3.0 * (dp_over_l[:-1] + lam[:, None] * dp_over_l[1:])
    rhs = rhs.at[0].add(-m0)
    lower = jnp.concatenate([jnp.zeros((1,)), jnp.ones((lam.shape[0] - 1,))])
    diag = 2.0 * (1.0 + lam)
    upper = lam
    j = jnp.arange(lam.shape[0])
    pin = j >= (n_seg - 1)
    lower = jnp.where(pin, 0.0, lower)
    diag = jnp.where(pin, 1.0, diag)
    upper = jnp.where(pin, 0.0, upper)
    rhs = jnp.where(pin[:, None], mn[None, :], rhs)
    full = n_seg == H
    rhs = rhs.at[-1].set(jnp.where(full, rhs[-1] + (-lam[-1] * mn), rhs[-1]))
    upper = jnp.where(full & (j == lam.shape[0] - 1), 0.0, upper)
    u = jpg.spl._thomas(lower, diag, upper, rhs)
    m = jnp.concatenate([m0[None], u, mn[None]], axis=0)
    m = jnp.where((jnp.arange(H + 1) >= n_seg)[:, None], mn[None, :], m)
    m = m.at[0].set(m0)
    return jpg.spl._coeffs_from_tangents(points, m, seg_len)


@contextlib.contextmanager
def jax_refit_repaired():
    """Inside the block the JAX package's path assembly fits with
    :func:`jax_fit_with_end_term` (the package itself is not edited: its
    module attribute is swapped and put back).  JAX's caches are cleared
    on entry and on exit, so that no trace made with one fit is reused
    with the other."""
    real = jpg._fit_clamped_chain_padded
    jax.clear_caches()
    jpg._fit_clamped_chain_padded = jax_fit_with_end_term
    try:
        yield
    finally:
        jpg._fit_clamped_chain_padded = real
        jax.clear_caches()


def carry(jax_lattice):
    """The port's lattice holding the JAX lattice's arrays bit for bit."""
    arrays = {k: np.asarray(getattr(jax_lattice, k))
              for k in tlat.ARRAY_FIELDS}
    meta = {k: getattr(jax_lattice, k) for k in tlat.META_FIELDS}
    return tlat.lattice_from_numpy(arrays, meta)


@dataclasses.dataclass
class Range:
    start: float
    end: float


@dataclasses.dataclass
class Ev:
    """A profiler event with the fields ``parallel/profiling`` reads."""
    name: str
    id: int
    device_type: str
    time_range: Range
    cpu_parent: object = None
