"""PyTorch port, the fleet tick's arc-length projections
(``ops/cuda_projection``, kernel ``csrc/projection.cu``): the seeded cases
of ``testing_tools/projection_cases`` reach what they name (ties, wraps,
clamps, equal angles, padded rows, a polyline longer than the kernel
stages); on the CPU the wrapper is its plain version (``get_s_coord`` once
a set, which ``test_torch_ops.py`` holds against JAX on the same cases);
the kernel route on stand-ins (the argument block's strides, counts and
outputs, checks before the launch, the C struct field for field); the
fleet tick's calls (three a tick, fb and sqp, each set of the six sites
once; none on the plain path) and ``opponent_summary``'s one.

``-m card``: the kernel bit-equal to the plain version on every seeded case
and on every recorded call of the fb and the sqp tick at B=1024 and of the
facade's opponent step, and the launch counts there.  This file imports no
JAX, so that it runs on a machine with the card: ``python -m pytest
--noconftest -o markers=card -m card tests/test_torch_projection.py``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_torch import entry
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_projection as cpj
from graphbasedlocaltrajectoryplanner_torch.ops import projection as proj
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    profile_stages)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    projection_cases as pc)

# the kernel's launches a fleet tick: the raceline (ego, start node, object
# slots), the follow path (object, ego), the fine raceline (opponent)
TICK_LAUNCHES = 3


@pytest.fixture(autouse=True)
def _launch_counts():
    """Leave every kernel wrapper's launch count as the test found it."""
    saved = {n: w.launches for n, w in cb.wrappers().items()}
    yield
    for n, w in cb.wrappers().items():
        w.launches = saved[n]


def _parts(line, p, s, closed):
    """What ``get_s_coord`` decides on the way: the closest vertex, its
    neighbours and the two angle magnitudes."""
    n = line.shape[-2]
    nb, d2 = proj.closest_path_index(line, p)
    if closed:
        i1, i2 = torch.remainder(nb - 1, n), torch.remainder(nb + 1, n)
    else:
        i1, i2 = torch.clamp(nb - 1, min=0), torch.clamp(nb + 1, max=n - 1)
    pn = proj._take(line, nb)
    ang1 = torch.abs(proj._angle3pt(pn, p, proj._take(line, i1)))
    ang2 = torch.abs(proj._angle3pt(pn, p, proj._take(line, i2)))
    return nb, d2, i1, i2, ang1, ang2


def _tie(line, p, s, closed):
    nb, d2, *_ = _parts(line, p, s, closed)
    srt = torch.sort(d2, dim=-1).values
    tied = srt[..., 0] == srt[..., 1]
    return bool(tied.any()) and bool((nb[tied] < d2.shape[-1] - 1).all())


def _wraps(v):
    def check(line, p, s, closed):
        nb, _, i1, i2, *_ = _parts(line, p, s, closed)
        n = line.shape[-2]
        at = nb == (0 if v == "first" else n - 1)
        wrapped = (i1 == n - 1) if v == "first" else (i2 == 0)
        return closed and bool(at.any()) and bool(wrapped[at].all())
    return check


def _clamps(line, p, s, closed):
    nb, _, i1, i2, *_ = _parts(line, p, s, closed)
    n = line.shape[-2]
    return (not closed and bool((nb == 0).any())
            and bool((nb == n - 1).any())
            and bool((i1[nb == 0] == 0).all())
            and bool((i2[nb == n - 1] == n - 1).all()))


def _equal_angles(line, p, s, closed):
    _, _, _, _, ang1, ang2 = _parts(line, p, s, closed)
    return bool((ang1 == ang2).any()) and bool((ang1 != ang2).any())


def _padded(line, p, s, closed):
    """Some position's closest vertex is a row's first frozen sample (the
    lowest of the repeated ones) with the row's frozen tail after it."""
    nb, *_ = _parts(line, p, s, closed)
    pt = proj._take(line, nb)
    nxt = proj._take(line, torch.clamp(nb + 1, max=line.shape[-2] - 1))
    frozen = torch.all(pt == nxt, dim=-1) & (nb < line.shape[-2] - 1)
    return bool(frozen.any())


def _long(line, p, s, closed):
    src = (cb.CSRC / "projection.cu").read_text()
    stage = int(re.search(r"MAX_STAGE = (\d+);", src).group(1))
    return line.dim() == 2 and line.shape[0] > stage


def _nan(line, p, s, closed):
    nb, *_ = _parts(line, p, s, closed)
    bad = torch.isnan(p).any(-1)
    return bool(bad.any()) and bool((nb[bad] == 0).all())


# case -> what it must reach (in its first position set)
REACHES = {"tie": _tie, "wrap_first": _wraps("first"),
           "wrap_last": _wraps("last"), "clamp_ends": _clamps,
           "equal_angles": _equal_angles, "padded_rows": _padded,
           "long_line": _long, "nan_position": _nan}


@pytest.mark.parametrize("name", list(REACHES))
def test_case_reaches_what_it_names(name):
    line, pos, s, closed = pc.case(name)
    assert REACHES[name](line, pos[0], s, closed)


def test_cases_cover_both_polyline_forms_and_every_set_count():
    forms = {pc.case(n)[0].dim() for n in pc.CASES}
    sets = {len(pc.case(n)[1]) for n in pc.CASES}
    assert forms == {2, 3} and sets == {1, 2, 3}


@pytest.mark.parametrize("name", list(pc.CASES))
def test_on_cpu_the_wrapper_is_get_s_coord_per_set(name):
    """On CPU tensors the wrapper is ``get_s_coord`` of each set, bit for
    bit, and launches nothing."""
    line, pos, s, closed = pc.case(name)
    before = cpj.get_s_coords.launches
    got = cpj.get_s_coords(line, pos, s, closed)
    want = tuple(proj.get_s_coord(line, p, s, closed=closed) for p in pos)
    ok, what = pc.compare(got, want)
    assert ok, what
    assert cpj.get_s_coords.launches == before


# ---- the kernel route on stand-ins ------------------------------------------

class _Entry:
    """A stand-in for the kernel's C entry point: records the argument
    block's fields."""

    def __init__(self):
        self.calls = []

    def __call__(self, ref, stream):
        a = ref._obj
        self.calls.append({name: (list(v) if isinstance(v, ctypes.Array)
                                  else v)
                           for name, v in ((f, getattr(a, f))
                                           for f, _ in a._fields_)})
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    entry_point = _Entry()
    monkeypatch.setattr(cb, "load", lambda name: entry_point)
    monkeypatch.setattr(cb, "stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(cb, "require_card", lambda t, what: None)
    return entry_point


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


B, O, P, F = 8, 4, 448, 352
# route -> (ref_line, positions, s_array, closed) and the fields wanted:
# (line_sr, line_si, line_sc, s_sr, s_si, n, closed, counts, pos strides)
ROUTES = {
    "raceline": (lambda: (_meta(61, 2), (_meta(B, 2), _meta(B, 2),
                                         _meta(B, O, 2)), _meta(61), True),
                 (0, 2, 1, 0, 1, 61, 1, [B, B, B * O], [(2, 1)] * 3)),
    "follow": (lambda: (_meta(B, 4, P, 5)[:, 1, :, 0:2],
                        (_meta(B, 1, 2)[:, 0], _meta(B, 2)),
                        _meta(B, 4, P)[:, 1], False),
               (4 * P * 5, 5, 1, 4 * P, 1, P, 0, [B, B], [(2, 1)] * 2)),
    "fine_raceline": (lambda: (_meta(F, 5)[:, 1:3], (_meta(1, 2),),
                               _meta(F, 5)[:, 0], True),
                      (0, 5, 1, 0, 5, F, 1, [1], [(2, 1)])),
    # positions as strided views, passed as they are
    "strided_positions": (lambda: (_meta(30, 2), (_meta(B, 5)[:, 1:3],
                                                  _meta(O, B, 2)[1]),
                                   _meta(30), False),
                          (0, 2, 1, 0, 1, 30, 0, [B, B], [(5, 1), (2, 1)])),
    "no_positions": (lambda: (_meta(30, 2), (_meta(0, 2),), _meta(30),
                              False),
                     (0, 2, 1, 0, 1, 30, 0, [0], [(2, 1)])),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_route_passes_strides_and_sets(stand_in, route):
    """One launch a call: the polyline's row, element and coordinate
    strides (row 0 for a shared one), each set's count and strides as the
    positions come (no copy), the outputs ``(s, (idx_a, idx_b))`` of each
    set's leading shape, float32 and int64."""
    make, (lsr, lsi, lsc, ssr, ssi, n, closed, counts, strides) = \
        ROUTES[route]
    line, pos, s, cl = make()
    before = cpj.get_s_coords.launches
    outs = cpj.get_s_coords(line, pos, s, cl)
    assert cpj.get_s_coords.launches == before + 1
    (a,) = stand_in.calls
    assert (a["line_sr"], a["line_si"], a["line_sc"], a["s_sr"],
            a["s_si"], a["n"], a["closed"], a["sets"]) == \
        (lsr, lsi, lsc, ssr, ssi, n, closed, len(pos))
    k = len(pos)
    assert a["count"][:k] == counts and a["items"] == max(counts)
    assert list(zip(a["pos_sq"][:k], a["pos_sc"][:k])) == strides
    assert len(outs) == k
    for p, (s_k, (ia, ib)) in zip(pos, outs):
        assert s_k.shape == ia.shape == ib.shape == p.shape[:-1]
        assert (s_k.dtype, ia.dtype, ib.dtype) == (torch.float32,
                                                   torch.int64, torch.int64)


def test_kernel_args_place_inputs_and_outputs(monkeypatch):
    """The argument block points at the caller's tensors (no copy) and at
    the outputs it returns, set by set."""
    monkeypatch.setattr(cb, "require_card", lambda t, what: None)
    table = torch.zeros(F, 5)
    pos = (torch.zeros(B, 2), torch.zeros(B, O, 2), torch.zeros(3, 2))
    a, outs, _keep = cpj.kernel_args(table[:, 1:3], pos, table[:, 0], True)
    assert a.line == table[:, 1:3].data_ptr() and a.s == table.data_ptr()
    for k, (p, (s, (ia, ib))) in enumerate(zip(pos, outs)):
        assert a.pos[k] == p.data_ptr()
        assert (a.s_out[k], a.idx_a[k], a.idx_b[k]) == (
            s.data_ptr(), ia.data_ptr(), ib.data_ptr())
    assert a.items == B * O and a.sets == 3


SPOILED = {
    "dtype": lambda: (_meta(30, 2).double(), (_meta(4, 2),), _meta(30)),
    "coords": lambda: (_meta(30, 3), (_meta(4, 2),), _meta(30)),
    "no_vertices": lambda: (_meta(0, 2), (_meta(4, 2),), _meta(0)),
    "s_shape": lambda: (_meta(30, 2), (_meta(4, 2),), _meta(29)),
    "position_coords": lambda: (_meta(30, 2), (_meta(4, 3),), _meta(30)),
    "position_dtype": lambda: (_meta(30, 2), (_meta(4, 2).double(),),
                               _meta(30)),
    "per_row_positions": lambda: (_meta(B, P, 2), (_meta(B, O, 2),),
                                  _meta(B, P)),
    "per_row_count": lambda: (_meta(B, P, 2), (_meta(B + 1, 2),),
                              _meta(B, P)),
    "no_sets": lambda: (_meta(30, 2), (), _meta(30)),
    "too_many_sets": lambda: (_meta(30, 2),
                              (_meta(4, 2),) * (cpj.MAX_SETS + 1),
                              _meta(30)),
    "batched_4d": lambda: (_meta(2, B, P, 2), (_meta(2, B, 2),),
                           _meta(2, B, P)),
}


@pytest.mark.parametrize("what", list(SPOILED))
def test_kernel_checks_raise_before_launch(stand_in, what):
    before = cpj.get_s_coords.launches
    line, pos, s = SPOILED[what]()
    with pytest.raises(ValueError):
        cpj.get_s_coords(line, pos, s)
    assert not stand_in.calls
    assert cpj.get_s_coords.launches == before


def test_kernel_args_refuse_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        cpj.kernel_args(torch.zeros(30, 2), (torch.zeros(4, 2),),
                        torch.zeros(30))


def test_c_struct_is_the_wrapper_s():
    """``ProjArgs`` is ``proj::Args`` of the kernel's source, field for
    field; the set limit is the kernel's; the kernel is registered."""
    src = (cb.CSRC / "projection.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        code = line.split("//")[0].strip().rstrip(";")
        if not code:
            continue
        arr = code.endswith("[MAX_SETS]")
        code = code.removesuffix("[MAX_SETS]")
        if "*" in code:
            kind, names = "ptr", code.rsplit("*", 1)[1]
        else:
            m = re.match(r"(long long|int) (.*)", code)
            kind, names = m.group(1).replace(" ", ""), m.group(2)
        for name in names.split(","):
            fields.append((name.strip(), kind + ("[]" if arr else "")))
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "longlong",
                   ctypes.c_int: "int"}

    def kind(t):
        if issubclass(t, ctypes.Array):
            assert t._length_ == cpj.MAX_SETS
            return ctypes_kind[t._type_] + "[]"
        return ctypes_kind[t]
    assert fields == [(n, kind(t)) for n, t in cpj.ProjArgs._fields_]
    assert f"constexpr int MAX_SETS = {cpj.MAX_SETS};" in src
    assert "projection" in cb.SOURCES
    assert cb.KERNEL_WRAPPERS["projection"].wrapper == \
        "cuda_projection.get_s_coords"


# ---- the fleet tick's calls -------------------------------------------------

@pytest.fixture(scope="module")
def small():
    lat = entry.small_lattice("cpu")
    scen = tsc.random_scenarios(lat, 4, seed=3, n_objects=2, o_pad=5,
                                device="cpu")
    return lat, scen


def _call_forms(calls):
    """Each recorded call as (polyline shape, closed, position shapes)."""
    return sorted((tuple(a[0].shape), kw["closed"],
                   tuple(tuple(p.shape) for p in a[1])) for a, kw in calls)


@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_tick_projects_in_three_calls(small, backend):
    """The tick calls the wrapper three times, each of the six projections
    once (the raceline's three sets, the follow path's two, the fine
    raceline's one), and never without the kernels; the outputs are the
    plain tick's."""
    lat, scen = small
    kw = profile_stages.sqp_options(lat) if backend == "sqp" else {}
    out_k, calls = pc.recorded(
        lambda: tsc.make_batched_tick(lat, True, device="cpu", **kw)(scen))
    out_p, calls_p = pc.recorded(
        lambda: tsc.make_batched_tick(lat, False, device="cpu", **kw)(scen))
    assert len(calls) == TICK_LAUNCHES and not calls_p
    for k in out_p:
        assert torch.equal(out_k[k], out_p[k]), k
    Bn, On = scen.obj_pos.shape[:2]
    Pn = tsc.C_PAD + tsc.default_p_max(lat)
    F_ = lat.glob_rl.shape[0]
    assert _call_forms(calls) == sorted([
        ((lat.raceline.shape[0], 2), True, ((Bn, 2), (Bn, 2), (Bn, On, 2))),
        ((Bn, Pn, 2), False, ((Bn, 2), (Bn, 2))),
        ((F_, 2), True, ((Bn, 2),))])


def test_opponent_summary_projects_once(small):
    """``opponent_summary`` (the facade's opponent step at B=1, the fleet
    tick's at B) makes one wrapper call with the kernels, none without,
    with the same outputs."""
    lat, scen = small
    for Bn in (1, 4):
        args = (lat.glob_rl, lat.glob_el, scen.obj_pos[:Bn, 0],
                scen.obj_vel[:Bn, 0], 1.0, 0.85, 1000.0)
        out_k, calls = pc.recorded(lambda: tvp.opponent_summary(*args))
        out_p, calls_p = pc.recorded(
            lambda: tvp.opponent_summary(*args, kernels=False))
        assert len(calls) == 1 and not calls_p
        for x, y in zip(out_k, out_p):
            assert torch.equal(x, y)


# ---- on the card ------------------------------------------------------------

def _held(calls):
    """Every recorded call's kernel against its plain version on the
    card, bit for bit."""
    for a, kw in calls:
        want = cpj.get_s_coords_plain(*a, **kw)
        for s, (ia, ib) in want:       # spoil the outputs' future memory
            for x in (s, ia, ib):
                torch.empty_like(x).view(torch.uint8).fill_(0xA5)
        got = cpj.get_s_coords(*a, **kw)
        torch.cuda.synchronize()
        ok, what = pc.compare(got, want)
        assert ok, (tuple(a[0].shape), what)


@pytest.mark.card
def test_kernel_is_the_plain_version_on_every_case():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    for name in pc.CASES:
        line, pos, s, closed = pc.case(name, "cuda")
        before = cpj.get_s_coords.launches
        _held([((line, pos, s), dict(closed=closed))])
        assert cpj.get_s_coords.launches == before + 1, name


@pytest.mark.card
@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_tick_calls_on_the_card(backend):
    """The eager tick at B=1024 on the small oval (three opponents in 16
    slots): three launches with the kernels, none without; every recorded
    call bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    lat = entry.small_lattice("cuda")
    scen = tsc.random_scenarios(lat, 1024, seed=5, n_objects=3,
                                o_pad=tsc.O_PAD, device="cuda")
    kw = profile_stages.sqp_options(lat) if backend == "sqp" else {}
    for kernels, want in ((True, TICK_LAUNCHES), (False, 0)):
        tick = cuda_graph.eager(tsc.make_batched_tick(lat, kernels,
                                                      device="cuda", **kw))
        _, launches = cb.counted(lambda: tick(scen), "cuda")
        assert launches["projection"] == want, (kernels, launches)
    tick = cuda_graph.eager(tsc.make_batched_tick(lat, device="cuda", **kw))
    _, calls = pc.recorded(lambda: tick(scen))
    assert len(calls) == TICK_LAUNCHES
    _held(calls)


@pytest.mark.card
def test_opponent_step_on_the_card():
    """The facade's opponent step (``opponent_summary`` at B=1): one
    launch, bit-equal to the plain version, the summary equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    lat = entry.small_lattice("cuda")
    rng = np.random.default_rng(3)
    rl = lat.raceline.cpu().numpy()
    for i in rng.integers(0, len(rl), 8):
        pos = torch.as_tensor(rl[i] + rng.normal(0, 2.0, 2),
                              dtype=torch.float32, device="cuda")[None]
        vel = torch.full((1,), 30.0, device="cuda")
        args = (lat.glob_rl, lat.glob_el, pos, vel, 1.0, 0.85, 1000.0)
        (out_k, calls), launches = cb.counted(
            lambda: pc.recorded(lambda: tvp.opponent_summary(*args)), "cuda")
        assert len(calls) == 1 and launches["projection"] == 1
        _held(calls)
        for x, y in zip(out_k, tvp.opponent_summary(*args, kernels=False)):
            assert torch.equal(x, y)
