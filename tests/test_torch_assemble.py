"""PyTorch port, the path assembly's wrapper (``ops/cuda_assemble``) on the
CPU, where it takes its plain version:

- on seeded chains (``testing_tools/assemble_cases``) of the small oval and
  of the unclosed track, at horizons 1, about H/2 and H_max (the
  full-horizon refit of PERF.md §7.1, kept as it is), at the tick's
  ``p_max`` and 64 rows more, with one window row a row and one a
  scenario: the wrapper, ``assemble_action_kernel`` with and without the
  kernels and the plain version ``torch.equal`` on every output; the
  shared window form equal to the same rows with the window repeated; the
  JAX package's ``assemble_action_kernel`` on every row (``n_valid`` and
  ``node_idx`` exact, x and y within 2 mm);
- the kernel route on stand-ins (meta tensors, a recording C entry point):
  the argument checks raise before any launch, the ``launches`` counter
  moves by one a call and the entry point gets the call's shape;
- the fleet tick hands the wrapper its window rows unrepeated and its
  ``kernels`` flag.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_assemble as ca
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    assemble_cases as ac)

from torch_port_common import carry, jax_small_oval, jax_unclosed

TOL_POS = 2e-3
ROWS = 8
OUTPUTS = ("path", "n_valid", "node_idx", "coeffs")


@pytest.fixture(scope="module")
def tracks():
    out = {}
    for name, build in (("oval", jax_small_oval), ("unclosed", jax_unclosed)):
        ja = build()
        lat = carry(ja)
        out[name] = dict(ja=ja, lat=lat, packed=tpg.packed_edge_table(lat),
                         jax_fns={})
    return out


def _equal(a, b):
    return all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in OUTPUTS)


def _jax_rows(tr, args):
    """The JAX package's assembly of every row (one compiled vmap a
    p_max)."""
    packed, win, nodes, h, psi, p_max = args
    fn = tr["jax_fns"].get(p_max)
    if fn is None:
        fn = tr["jax_fns"][p_max] = jax.jit(jax.vmap(
            lambda w, n, he, ps: jpg.assemble_action_kernel(
                tr["ja"], w, n, he, ps, p_max)))
    k = nodes.shape[0] // win.shape[0]
    win = win.repeat_interleave(k, dim=0)
    return fn(jnp.asarray(win.numpy().astype(np.int32)),
              jnp.asarray(nodes.numpy().astype(np.int32)),
              jnp.asarray(h.numpy().astype(np.int32)),
              jnp.asarray(psi.numpy()))


@pytest.mark.parametrize("shared", [False, True], ids=["win_rows",
                                                       "win_shared"])
@pytest.mark.parametrize("p_extra", [0, 64], ids=["p_max", "p_max_64"])
@pytest.mark.parametrize("h_mode", ["one", "mid", "full"])
@pytest.mark.parametrize("track", ["oval", "unclosed"])
def test_assemble_wrapper_is_the_plain_version(tracks, track, h_mode,
                                               p_extra, shared):
    tr = tracks[track]
    lat, H = tr["lat"], tr["lat"].H_max
    args = ac.case(lat, tr["packed"], ROWS, h_mode, p_extra, shared,
                   seed=len(h_mode) + p_extra)
    ref = ca.assemble_path_plain(*args)
    R = args[2].shape[0]
    assert ref["path"].shape == (R, tsc.default_p_max(lat) + p_extra, 5)
    assert ref["path"].dtype == torch.float32
    assert ref["n_valid"].dtype == torch.int64
    assert ref["node_idx"].shape == (R, H + 1)
    assert ref["node_idx"].dtype == torch.int32
    assert ref["coeffs"].shape == (R, H, 8)
    launches = ca.assemble_path.launches
    assert _equal(ca.assemble_path(*args), ref)
    pos = (lat, args[1], args[2], args[3], args[4], args[5])
    assert _equal(tpg.assemble_action_kernel(*pos, packed=tr["packed"]),
                  ref)
    assert _equal(tpg.assemble_action_kernel(*pos, packed=tr["packed"],
                                             kernels=False), ref)
    assert ca.assemble_path.launches == launches      # no card here
    if shared:
        rows = [args[0], args[1].repeat_interleave(4, dim=0)] + args[2:]
        assert _equal(ca.assemble_path_plain(*rows), ref)
    if h_mode == "one":             # one edge: its own sample count
        win = args[1].long().repeat_interleave(R // args[1].shape[0], dim=0)
        nodes = args[2].long()
        npts = args[0][win[:, 0], nodes[:, 0], nodes[:, 1], 0]
        assert torch.equal(ref["n_valid"], npts.long())

    jr = _jax_rows(tr, args)
    np.testing.assert_array_equal(ref["n_valid"].numpy(),
                                  np.asarray(jr["n_valid"]))
    np.testing.assert_array_equal(ref["node_idx"].numpy(),
                                  np.asarray(jr["node_idx"]))
    d = np.abs(ref["path"].numpy()[..., 0:2].astype(np.float64)
               - np.asarray(jr["path"])[..., 0:2])
    print(f"assemble {track} h={h_mode} p+{p_extra} shared={shared}: "
          f"max |d x,y| = {d.max():.3g} m against JAX")
    assert d.max() <= TOL_POS


# ---- the kernel route on stand-ins -----------------------------------------

class _Entry:
    """A stand-in for the kernel's C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *a):
        self.calls.append(a)
        return 0


def _require_anywhere(t, dtype, shape, what):
    """``cuda_build.require`` without its device check."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)}")


@pytest.fixture
def stand_in(monkeypatch):
    entry = _Entry()
    monkeypatch.setattr(cb, "load", lambda name: entry)
    monkeypatch.setattr(cb, "stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(cb, "require", _require_anywhere)
    return entry


def _meta_args(R=8, R0=2, H=5, L=7, N=4, P=40):
    """The arguments of a call on the meta device (the kernel route)."""
    m = dict(device="meta")
    return [torch.empty((L, N, N, 10), dtype=torch.float32, **m),
            torch.empty((R0, H + 1), dtype=torch.int64, **m),
            torch.empty((R, H + 1), dtype=torch.int32, **m),
            torch.empty((R,), dtype=torch.int64, **m),
            torch.empty((R,), dtype=torch.float32, **m), P]


def test_assemble_launches_once_a_call(stand_in):
    before = ca.assemble_path.launches
    for _ in range(2):
        out = ca.assemble_path(*_meta_args())
    assert ca.assemble_path.launches == before + 2
    assert len(stand_in.calls) == 2
    # R, rows a window row, H, L, N, P, and the index widths: win int64
    # (bit 0), nodes int32, h_eff int64 (bit 2)
    assert stand_in.calls[0][9:16] == (8, 4, 5, 7, 4, 40, 0b101)
    assert out["path"].shape == (8, 40, 5)
    assert out["n_valid"].dtype == torch.int64
    assert out["node_idx"].shape == (8, 6)
    assert out["node_idx"].dtype == torch.int32
    assert out["coeffs"].shape == (8, 5, 8)


def _spoiled(i):
    a = _meta_args()
    m = dict(device="meta")
    if i == 0:
        a[0] = a[0].double()                            # packed dtype
    elif i == 1:
        a[0] = torch.empty((7, 4, 5, 10), **m)          # packed not N x N
    elif i == 2:
        a[1] = torch.empty((3, 6), dtype=torch.int64, **m)   # R0 | R
    elif i == 3:
        a[1] = torch.empty((2, 5), dtype=torch.int64, **m)   # H + 1
    elif i == 4:
        a[2] = a[2].float()                             # nodes dtype
    elif i == 5:
        a[3] = torch.empty((7,), dtype=torch.int64, **m)     # h_eff shape
    elif i == 6:
        a[4] = a[4].double()                            # psi_s dtype
    elif i == 7:
        a[5] = 0                                        # p_max
    elif i == 8:
        a[2] = torch.empty((8, 2), dtype=torch.int32, **m)   # H < 2
        a[1] = torch.empty((2, 2), dtype=torch.int64, **m)
    return a


@pytest.mark.parametrize("i", range(9), ids=[
    "packed_dtype", "packed_shape", "win_rows", "win_width", "nodes_dtype",
    "h_eff_shape", "psi_dtype", "p_max", "h_below_2"])
def test_assemble_checks_raise_before_launch(stand_in, i):
    before = ca.assemble_path.launches
    with pytest.raises(ValueError):
        ca.assemble_path(*_spoiled(i))
    assert not stand_in.calls
    assert ca.assemble_path.launches == before


def test_fleet_tick_passes_window_rows_and_kernels(tracks, monkeypatch):
    """The tick's one assembly call gets the (B, H+1) window rows (no
    repeated copy) and goes to the wrapper only with the kernels."""
    lat = tracks["oval"]["lat"]
    scen = tsc.random_scenarios(lat, 2, seed=3, n_objects=1, device="cpu")
    seen = {}
    for kernels in (True, False):
        calls = []
        orig = ca.assemble_path

        def rec(*a, **k):
            calls.append(a)
            return orig(*a, **k)
        monkeypatch.setattr(ca, "assemble_path", rec)
        seen[kernels] = (tsc.make_batched_tick(lat, kernels,
                                                 device="cpu")(scen), calls)
        monkeypatch.setattr(ca, "assemble_path", orig)
    (out_k, calls_k), (out_p, calls_p) = seen[True], seen[False]
    assert len(calls_k) == 1 and not calls_p
    assert tuple(calls_k[0][1].shape) == (2, lat.H_max + 1)
    assert tuple(calls_k[0][2].shape) == (8, lat.H_max + 1)
    for k in out_p:
        assert torch.equal(out_k[k], out_p[k]), k
