"""PyTorch port, the path assembly's wrapper (``ops/cuda_assemble``) on the
CPU, where it takes its plain version:

- the padded refit ``_fit_clamped_chain_padded`` against the unpadded
  ``ops/splines.fit_clamped_chain`` on seeded chains of every segment
  count 1..H, for H = 6 and H = 27: at ``n_seg == H`` no equation is
  pinned and the end tangent's term goes to the right-hand side (the JAX
  package's padded fit drops it; the port departs from it there);
- on seeded chains (``testing_tools/assemble_cases``) of the small oval and
  of the unclosed track, at horizons 1, about H/2 and H_max, at the tick's
  ``p_max`` and 64 rows more, with one window row a row and one a
  scenario: the wrapper, ``assemble_action_kernel`` with and without the
  kernels and the plain version ``torch.equal`` on every output; the
  shared window form equal to the same rows with the window repeated; the
  JAX package's ``assemble_action_kernel`` on every row (``n_valid`` and
  ``node_idx`` exact, x and y within 2 mm), except x and y at H_max, which
  are held within 2 mm to the plain version refitted row by row with the
  unpadded fit;
- the fleet tick on the small oval, its scenarios on the layers whose
  horizon is H_max: its trajectories within 2 mm of the same tick refitted
  with the unpadded fit, and the assembly's ``full_horizon_rows`` counter
  under ``cuda_graph.tracing()``;
- the kernel route on stand-ins (meta tensors, a recording C entry point):
  the argument checks raise before any launch, the ``launches`` counter
  moves by one a call and the entry point gets the call's shape;
- the fleet tick hands the wrapper its window rows unrepeated and its
  ``kernels`` flag.
"""

import ctypes
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.planner import pathgen as jpg
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_assemble as ca
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as tpg
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    assemble_cases as ac)

from torch_port_common import carry, jax_small_oval, jax_unclosed

TOL_POS = 2e-3
ROWS = 8
OUTPUTS = ("path", "n_valid", "node_idx", "coeffs")
PADDED_FIT = ca._fit_clamped_chain_padded


def _unpadded_fit(points, el, psi_s, psi_e, n_seg, H):
    """The padded fit's rows refitted with ``splines.fit_clamped_chain``
    on their own ``n_seg`` segments (segments past them as the padded fit
    leaves them)."""
    out = PADDED_FIT(points, el, psi_s, psi_e, n_seg, H).clone()
    for r, n in enumerate(n_seg.tolist()):
        out[r, :n] = spl.fit_clamped_chain(
            points[r, :n + 1], psi_s[r], psi_e[r],
            torch.clamp(el[r, :n], min=1e-9))
    return out


def _chains(H, n, rows=4):
    """Seeded chains of ``n`` segments (2-5 m, headings wandering), padded
    to H as the assembly pads them: the end point repeated, length 1."""
    g = torch.Generator().manual_seed(1000 * H + n)
    el = 2.0 + 3.0 * torch.rand((rows, n), generator=g)
    ang = torch.cumsum(0.2 * (torch.rand((rows, n), generator=g) - 0.5), 1)
    steps = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * el[..., None]
    pts = torch.cat([torch.zeros(rows, 1, 2), torch.cumsum(steps, 1)], 1)
    psi_s = 0.1 * torch.randn(rows, generator=g) - math.pi / 2
    psi_e = ang[:, -1] - math.pi / 2 + 0.1 * torch.randn(rows, generator=g)
    points = torch.cat([pts, pts[:, -1:].expand(rows, H - n, 2)], 1)
    el_pad = torch.cat([el, torch.ones(rows, H - n)], 1)
    return pts, el, points, el_pad, psi_s, psi_e


@pytest.mark.parametrize("H,n", [(H, n) for H in (6, 27)
                                 for n in range(1, H + 1)],
                         ids=lambda v: str(v))
def test_padded_fit_is_the_unpadded_fit(H, n):
    pts, el, points, el_pad, psi_s, psi_e = _chains(H, n)
    rows = pts.shape[0]
    got = ca._fit_clamped_chain_padded(points, el_pad, psi_s, psi_e,
                                       torch.full((rows,), n), H)
    assert got.shape == (rows, H, 4, 2)
    ref = torch.stack([spl.fit_clamped_chain(pts[r], psi_s[r], psi_e[r],
                                             el[r]) for r in range(rows)])
    torch.testing.assert_close(got[:, :n], ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


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
    oracle, what = np.asarray(jr["path"]), "JAX"
    if h_mode == "full":            # the JAX package's refit drops a term
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ca, "_fit_clamped_chain_padded", _unpadded_fit)
            oracle = ca.assemble_path_plain(*args)["path"].numpy()
        what = "the unpadded fit"
    d = np.abs(ref["path"].numpy()[..., 0:2].astype(np.float64)
               - oracle[..., 0:2])
    print(f"assemble {track} h={h_mode} p+{p_extra} shared={shared}: "
          f"max |d x,y| = {d.max():.3g} m against {what}")
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


def test_fleet_tick_full_horizon_rows(tracks, monkeypatch):
    """Scenarios on the small oval's H_max layers: the tick's paths are
    those of the unpadded refit within 2 mm, every discrete output equal,
    and the assembly counts its full-horizon rows under tracing only."""
    lat = tracks["oval"]["lat"]
    H = lat.H_max
    scen = tsc.random_scenarios(lat, 48, seed=5, n_objects=1, device="cpu")
    full = (lat.h_goal_for_start[scen.start_layer.long()] == H).nonzero()[:, 0]
    assert len(full) >= 2
    scen = dataclasses.replace(scen, **{
        f.name: getattr(scen, f.name)[full[:4]]
        for f in dataclasses.fields(scen)})
    tick = tsc.make_batched_tick(lat, device="cpu")
    out = tick(scen)
    n_full = int((out["h_eff"][:, :4] == H).sum())     # the 4 assembled
    assert n_full > 0
    with monkeypatch.context() as mp:
        mp.setattr(ca, "_fit_clamped_chain_padded", _unpadded_fit)
        ref = tick(scen)
    for k in ("valid", "h_eff", "n_valid"):
        assert torch.equal(out[k], ref[k]), k
    live = ref["valid"][..., None] & (
        torch.arange(out["trajs"].shape[2]) < ref["n_valid"][..., None])
    d = torch.where(live[..., None], (out["trajs"] - ref["trajs"]).abs(),
                    0.0)[..., 0:3]
    print(f"fleet tick, {n_full} full-horizon rows: max |d s,x,y| = "
          f"{float(d.max()):.3g} m against the unpadded fit")
    assert float(d.max()) <= TOL_POS
    with cuda_graph.tracing() as counts:
        assert torch.equal(tick(scen)["trajs"], out["trajs"])
    assert {k: int(v) for k, v in counts.items()} == {
        "full_horizon_rows": n_full}
