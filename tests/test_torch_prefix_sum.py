"""PyTorch port, the velocity stage's blocked prefix sums
(``ops/cuda_prefix``, kernel ``csrc/prefix_sum.cu``): the wrapper on the
CPU is its plain version (the specification, in the reference's
summation order, which ``test_torch_ops.py`` holds against JAX); the
kernel route on meta-device stand-ins (strides passed as they are, checks
before the launch, ``launches``); the fleet tick's calls, each distinct sum
once (fb three, sqp two, none on the plain path) with the shared sums
equal bit for bit to the ones they replace.

``-m card``: the same counts on the card, each call bit-equal to the plain
version there.  This file imports no JAX, so that it runs on a machine
with the card: ``python -m pytest --noconftest -o markers=card -m card
tests/test_torch_prefix_sum.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_torch import entry
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_prefix as cp
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import pathgen as pg
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    profile_stages)

B = 4
# the kernel's launches a tick: fb s4, the follow slot's masked s and the
# opponent's window; sqp no masked follow s
TICK_LAUNCHES = {"fb": 3, "sqp": 2}


def _bits(x):
    return x.contiguous().view(torch.int32)


def _row_values(shape, seed):
    """Seeded rows with negatives, runs of +0.0 and -0.0 and ordinary
    element lengths."""
    rng = np.random.default_rng(seed)
    pick = np.array([-0.0, 0.0, 2.5, -1.25, 1e-3, -7.0], np.float32)
    x = np.where(rng.random(shape) < 0.5, rng.choice(pick, shape),
                 rng.normal(0.0, 3.0, shape)).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 16, 17, 128, 257, 447, 4097])
def test_blocked_cumsum_on_cpu_is_the_plain_version(n):
    """On a CPU tensor the wrapper is the plain version, bit for bit
    (signed zeros included), on a strided view too and in the leading-zero
    form, and launches nothing."""
    before = cp.blocked_cumsum.launches
    paths = _row_values((3, 2, n, 5), n)
    for x in (paths[..., 4], paths[..., 4].contiguous(), paths[0, 1, :, 2]):
        ref = cp.blocked_cumsum_plain(x)
        assert torch.equal(_bits(cp.blocked_cumsum(x)), _bits(ref))
        z = torch.zeros(x.shape[:-1] + (1,))
        got0 = cp.blocked_cumsum(x, leading_zero=True)
        assert torch.equal(_bits(got0), _bits(torch.cat([z, ref], dim=-1)))
        # velplan's forms, with and without the kernels, are the same sums
        for kernels in (True, False):
            assert torch.equal(_bits(tvp._cumsum(x, kernels=kernels)),
                               _bits(ref))
            if n > 1:
                assert torch.equal(
                    _bits(tvp._cumsum0(x, kernels=kernels)),
                    _bits(torch.cat([z, cp.blocked_cumsum_plain(
                        x[..., :-1])], dim=-1)))
    assert cp.blocked_cumsum.launches == before


# ---- the kernel route on stand-ins ------------------------------------------

class _Entry:
    """A stand-in for the kernel's C entry point: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *a):
        self.calls.append(a)
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


# (input, leading zero) -> (rows, row stride, element stride, n, lead, out)
ROUTES = {
    "rows": (lambda: _meta(6, 447), False, (6, 447, 1, 447, 0, (6, 447))),
    "paths_el": (lambda: _meta(8, 4, 448, 5)[..., 4][..., :-1], True,
                 (32, 448 * 5, 5, 447, 1, (8, 4, 448))),
    "follow_slot": (lambda: _meta(8, 4, 448)[:, 1][..., :-1], True,
                    (8, 4 * 448, 1, 447, 1, (8, 448))),
    "window_col": (lambda: _meta(8, 128, 3)[..., 2], False,
                   (8, 384, 3, 128, 0, (8, 128))),
    "one_row": (lambda: _meta(12), True, (1, 12, 1, 12, 1, (13,))),
    "no_rows": (lambda: _meta(0, 3, 447), True, (0, 447, 1, 447, 1,
                                                 (0, 3, 448))),
    # leading axes that do not merge: one copy, contiguous rows
    "unmergeable": (lambda: _meta(4, 8, 448, 5).transpose(0, 1)[..., 4],
                    False, (32, 448, 1, 448, 0, (8, 4, 448))),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_route_takes_strides_as_they_are(stand_in, route):
    """The kernel gets the rows' and the elements' strides of the input as
    it is (no copy where the leading axes merge), ``launches`` moves by
    one a call."""
    make, lead, (rows, rs, es, n, lz, out_shape) = ROUTES[route]
    before = cp.blocked_cumsum.launches
    out = cp.blocked_cumsum(make(), leading_zero=lead)
    assert cp.blocked_cumsum.launches == before + 1
    (args,) = stand_in.calls
    assert args[2:7] == (rows, rs, es, n, lz)
    assert tuple(out.shape) == out_shape and out.dtype == torch.float32


SPOILED = {
    "dtype": lambda: _meta(4, 20).double(),
    "empty_row": lambda: _meta(4, 0),
    "too_long": lambda: _meta(2, cp.MAX_N + 1),
    "scalar": lambda: _meta(),
    "int": lambda: torch.empty((4, 20), dtype=torch.int32, device="meta"),
}


@pytest.mark.parametrize("what", list(SPOILED))
def test_kernel_checks_raise_before_launch(stand_in, what):
    before = cp.blocked_cumsum.launches
    with pytest.raises(ValueError):
        cp.blocked_cumsum(SPOILED[what]())
    assert not stand_in.calls
    assert cp.blocked_cumsum.launches == before


def test_kernel_args_refuse_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        cp.kernel_args(torch.zeros(3, 20))


def test_longest_row_is_the_kernel_s():
    src = (cb.CSRC / "prefix_sum.cu").read_text()
    assert f"constexpr int MAX_N = {cp.MAX_N};" in src
    assert "prefix_sum" in cb.SOURCES
    assert cb.KERNEL_WRAPPERS["prefix_sum"].wrapper == \
        "cuda_prefix.blocked_cumsum"


# ---- the fleet tick's calls -------------------------------------------------

@pytest.fixture(scope="module")
def small():
    lat = entry.small_lattice("cpu")
    scen = tsc.random_scenarios(lat, B, seed=3, n_objects=1, device="cpu")
    return lat, scen


def _tick_options(lat, backend):
    return profile_stages.sqp_options(lat) if backend == "sqp" else {}


def _recorded(fn, monkeypatch):
    """``fn()`` with every call of the wrapper recorded: [(x, lead, out)]."""
    calls, orig = [], cp.blocked_cumsum

    def rec(x, leading_zero=False):
        out = orig(x, leading_zero)
        calls.append((x.clone(), leading_zero, out.clone()))
        return out
    rec.launches = 0
    monkeypatch.setattr(cp, "blocked_cumsum", rec)
    try:
        res = fn()
    finally:
        monkeypatch.setattr(cp, "blocked_cumsum", orig)
    return res, calls


@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_tick_computes_each_distinct_sum_once(small, monkeypatch, backend):
    """The tick calls the wrapper three times (fb) or twice (sqp), not at
    all without the kernels, with the same outputs; the four slots' sums
    ``s4`` stand bit for bit for the follow slot's s array and for the
    stage's ``cum``, the sums of the same element lengths in the same
    order."""
    lat, scen = small
    kw = _tick_options(lat, backend)
    out_k, calls = _recorded(
        lambda: tsc.make_batched_tick(lat, True, device="cpu", **kw)(scen),
        monkeypatch)
    out_p, calls_p = _recorded(
        lambda: tsc.make_batched_tick(lat, False, device="cpu", **kw)(scen),
        monkeypatch)
    assert len(calls) == TICK_LAUNCHES[backend] and not calls_p
    for k in out_p:
        assert torch.equal(out_k[k], out_p[k]), k
    P = tsc.C_PAD + tsc.default_p_max(lat)
    (x4, lead4, s4), = [c for c in calls if c[0].shape == (B, 4, P - 1)]
    assert lead4 and s4.shape == (B, 4, P)
    # the parent's s_arr_f = _cumsum0(path_f[..., 4]) and cum =
    # _cumsum(el[..., :-1]), from the same element lengths
    z = torch.zeros((B, 1))
    s_arr_f = torch.cat(
        [z, cp.blocked_cumsum_plain(x4[:, pg.SLOT_FOLLOW])], dim=-1)
    assert torch.equal(_bits(s4[:, pg.SLOT_FOLLOW]), _bits(s_arr_f))
    assert torch.equal(_bits(s4[..., 1:]),
                       _bits(cp.blocked_cumsum_plain(x4)))
    # the trajectories' s column is s4
    assert torch.equal(_bits(out_k["trajs"][:, :4, :, 0]), _bits(s4))
    shapes = sorted(tuple(c[0].shape) for c in calls)
    want = [(B, 4, P - 1), (B, tvp.F_CAP)]
    if backend == "fb":
        want.append((B, P - 1))
    assert shapes == sorted(want)


def test_velocity_stage_computes_s4_without_the_caller(small, monkeypatch):
    """``velocity_stage_scenario`` given no ``s4`` computes it itself (the
    facade-free callers' form): the same trajectories."""
    lat, scen = small
    got = {}
    orig = tvp.velocity_stage_scenario
    for drop in (False, True):
        def stage(*a, _drop=drop, **kw):
            if _drop:
                kw["s4"] = None
            return orig(*a, **kw)
        monkeypatch.setattr(tvp, "velocity_stage_scenario", stage)
        got[drop] = tsc.make_batched_tick(lat, device="cpu")(scen)
    monkeypatch.setattr(tvp, "velocity_stage_scenario", orig)
    for k in got[False]:
        assert torch.equal(got[False][k], got[True][k]), k


# ---- on the card ------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_tick_launches_on_the_card(backend):
    """On the card the eager kernel tick launches the kernel three times
    (fb) or twice (sqp) and the plain tick never; every call's output is
    bit-equal to the plain version on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    lat = entry.small_lattice("cuda")
    scen = tsc.random_scenarios(lat, 64, seed=5, n_objects=1, device="cuda")
    kw = _tick_options(lat, backend)
    for kernels, want in ((True, TICK_LAUNCHES[backend]), (False, 0)):
        tick = cuda_graph.eager(tsc.make_batched_tick(lat, kernels,
                                                      device="cuda", **kw))
        _, launches = cb.counted(lambda: tick(scen), "cuda")
        assert launches["prefix_sum"] == want, (kernels, launches)
    with pytest.MonkeyPatch.context() as mp:
        tick = cuda_graph.eager(tsc.make_batched_tick(lat, device="cuda",
                                                      **kw))
        _, calls = _recorded(lambda: tick(scen), mp)
    assert len(calls) == TICK_LAUNCHES[backend]
    for x, lead, out in calls:
        ref = cp.blocked_cumsum_plain(x, lead)
        assert torch.equal(_bits(out), _bits(ref)), tuple(x.shape)


@pytest.mark.card
def test_kernel_is_the_plain_version_on_the_card():
    """Lengths from 1 to 5,000 (every seventh, and each side of every
    recursion boundary) on random and signed-zero rows, strided and in the
    leading-zero form, bit-equal to the plain version on the card
    (``chip_smoke.py`` takes every length)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    edges = {k + d for k in (16, 256, 4096) for d in (-1, 0, 1)}
    for n in sorted(set(range(1, 5001, 7)) | edges | {5000}):
        paths = _row_values((3, n, 5), n).cuda()
        x = paths[..., 4]
        for lead in (False, True):
            assert torch.equal(
                _bits(cp.blocked_cumsum(x, leading_zero=lead)),
                _bits(cp.blocked_cumsum_plain(x, lead))), (n, lead)
