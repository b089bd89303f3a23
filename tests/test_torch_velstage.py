"""PyTorch port, the fb velocity stage's glue kernels
(``ops/cuda_velstage``, kernels ``csrc/vel_stage.cu``): on the CPU the plain
version, composed as the kernel route composes the wrappers (four level
launches around the four scans, the follow path's arc lengths from level
1's rows, one epilogue), gives the stage's outputs bit for bit on recorded
fleet-tick calls (both fb cells' lattice and mixes at B=8) and on the
seeded cases of ``testing_tools/velstage_cases``; the sqp tail through
the epilogue's plain version, the same; the kernel route on meta-device
stand-ins (launch counts per stage, no stack, cat or flip between the
levels, none for the facade's gg streams, ``kernels=False`` or the CPU;
checks before the launch; the C argument block field for field).

``-m card``: each kernel bit-equal to its plain version on the card (the
follow path's stopping distance within its stated bound) on the fb tick's
recorded calls at B=1024 and on every seeded case, and the stage with the
kernels equal to the stage without them.  This file imports no JAX, so
that it runs on a machine with the card: ``python -m pytest --noconftest
-o markers=card -m card tests/test_torch_velstage.py``.
"""

import ctypes
import re

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
from graphbasedlocaltrajectoryplanner_torch.models import track as tt
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_build as cb
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velstage as vs
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.planner import velplan as tvp
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    velstage_cases as vc)
from graphbasedlocaltrajectoryplanner_torch.utils.config import OfflineConfig

# launches of a fb stage: a level kernel and a scan a level, one epilogue,
# the follow path's arc lengths (and s4 where the caller has none)
FB_STAGE = dict(vel_stage_level=4, vel_scan_cgg=4, vel_stage_epilogue=1,
                prefix_sum=1)


_route = vc.route


def _assert_route_is_the_stage(args, kw):
    want = tvp.velocity_stage_scenario(*args, **dict(kw, kernels=False))
    trajs, vel_bound, too_close = _route(args, kw)
    assert torch.equal(trajs, want["trajs"])
    assert torch.equal(vel_bound, want["vel_bound"])
    assert torch.equal(too_close, want["too_close"])
    return want


def _stage_calls(lat, scen, **tick_kw):
    """The arguments of every ``velocity_stage_scenario`` call of one
    fleet tick."""
    return vc.stage_calls(lambda: tsc.make_batched_tick(
        lat, device="cpu", **tick_kw)(scen))


@pytest.fixture(autouse=True)
def _launch_counts():
    """Leave every kernel wrapper's launch count as the test found it:
    the stand-in routes below launch, and tests of other files read the
    counts as they are."""
    saved = {n: w.launches for n, w in cb.wrappers().items()}
    yield
    for n, w in cb.wrappers().items():
        w.launches = saved[n]


@pytest.fixture(scope="module")
def oval():
    return tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                            md5_params="oval")


# both fb cells' mixes: one opponent, and three in the 16 collision slots
MIXES = {"1opp": dict(n_objects=1), "3opp_o16": dict(n_objects=3,
                                                     o_pad=tsc.O_PAD)}


@pytest.mark.parametrize("mix", list(MIXES))
def test_plain_route_is_the_stage_on_recorded_ticks(oval, mix):
    """On the default oval at B=8 (the fb cells' lattice and mixes) the
    plain version composed as the kernel route composes the wrappers gives
    the stage's trajectories, bounds and ``too_close`` bit for bit."""
    scen = tsc.random_scenarios(oval, 8, seed=4, device="cpu", **MIXES[mix])
    (args, kw), = _stage_calls(oval, scen)
    _assert_route_is_the_stage(args, kw)


@pytest.mark.parametrize("case", range(len(vc.CASES) - 1))
def test_plain_route_is_the_stage_on_seeded_cases(case):
    """The same on the seeded cases (all but the B=1000 one), which hold
    every branch: the prefix active and not, reduced horizons, a follow
    stop index below 2, an ego brake that cannot hold, too close."""
    N, P, fs = vc.CASES[case]
    args, kw = vc.stage_case(N, P, fs, seed=case)
    _assert_route_is_the_stage(args, kw)


def test_seeded_cases_reach_every_branch():
    """Across the seeded cases each branch of the glue occurs both ways."""
    seen = {k: set() for k in ("prefix", "red_len", "seg1", "stop_lt_2",
                               "cannot_hold", "too_close")}
    for i, (N, P, fs) in enumerate(vc.CASES[:-1]):
        args, kw = vc.stage_case(N, P, fs, seed=i)
        out, calls = vc.recorded(lambda: _route(args, kw))
        a, k = calls["vel_stage_level"][2]
        st = dict(zip(vs.FOLLOW_STATE,
                      vs.fb_level_plain(*a, **k)[6:]))
        seen["prefix"] |= set((args[5] > args[7] + 0.1).tolist())
        seen["red_len"] |= set(args[11].reshape(-1).tolist())
        seen["seg1"] |= set(st["seg1_active"].tolist())
        seen["stop_lt_2"] |= set((st["stop_idx"] < 2).tolist())
        seen["cannot_hold"] |= set(st["cannot_hold"].tolist())
        seen["too_close"] |= set(st["too_close"].tolist())
    assert all(v == {False, True} for v in seen.values()), seen


@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_epilogue_plain_is_the_tail(backend):
    """The epilogue's plain version is the stage's tail on the tail's own
    inputs: the fb profiles' (from the scans) and the sqp backend's (QP
    profiles, the course's end and the planned velocity broadcast)."""
    args, kw = vc.stage_case(5, 18, 1, seed=7, backend=backend)
    got = {}
    orig = vs.tail_plain

    def rec(**t):
        got.update(t)
        return orig(**t)
    vs.tail_plain = rec
    try:
        want = tvp.velocity_stage_scenario(*args, **kw)
    finally:
        vs.tail_plain = orig
    if backend == "sqp":
        trajs, vel_bound = vs.epilogue(
            **{k: got[k] for k in ("paths", "s", "n_valid", "c_len",
                                   "vel_course", "red_len", "v_max_offset",
                                   "fs", "v_idx", "pref_idx", "vel_start",
                                   "vx_normal", "vx_follow",
                                   "follow_bound")})
    else:
        (_, calls) = vc.recorded(lambda: _route(args, kw))
        (a, k), = calls["vel_stage_epilogue"]
        trajs, vel_bound = vs.epilogue(*a, **k)
    assert torch.equal(trajs, want["trajs"])
    assert torch.equal(vel_bound, want["vel_bound"])


def test_wrappers_on_the_cpu_are_the_plain_versions():
    """On CPU tensors each wrapper is its plain version and launches
    nothing; the recorded route's calls replay to the same outputs."""
    args, kw = vc.stage_case(5, 18, 1, seed=2)
    before = (vs.fb_level.launches, vs.epilogue.launches)
    _, calls = vc.recorded(lambda: _route(args, kw))
    assert [c[0][0] for c in calls["vel_stage_level"]] == [0, 1, 2, 3]
    assert len(calls["vel_stage_epilogue"]) == 1
    for name, cs in calls.items():
        for a, k in cs:
            ok, what, _ = vc.compare(name, a, k, vc.kernel_of(name)(*a, **k),
                                     vc.plain_of(name)(*a, **k))
            assert ok, (name, what)
    assert (vs.fb_level.launches, vs.epilogue.launches) == before


# ---- the kernel route on stand-ins ------------------------------------------

class _Entry:
    """A stand-in for a C entry point: records its arguments (the argument
    block of a ``vel_stage`` entry point)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *a):
        self.calls.append(a[0]._obj if len(a) == 2 else a)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    entries = {}

    def load(name):
        return entries.setdefault(name, _Entry())
    monkeypatch.setattr(cb, "load", load)
    monkeypatch.setattr(cb, "stream", lambda: ctypes.c_void_p(0))
    monkeypatch.setattr(cb, "require_card", lambda t, what: None)
    return entries


def _meta(x):
    if torch.is_tensor(x):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


def _meta_case(backend="fb", N=3, P=20):
    args, kw = vc.stage_case(N, P, 1, seed=1, backend=backend)
    args = tuple(_meta(a) for a in args)
    return args, {k: _meta(v) for k, v in kw.items()}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def _launches(fn):
    ws = cb.wrappers()
    before = {n: w.launches for n, w in ws.items()}
    out = fn()
    ws = cb.wrappers()
    return out, {n: ws[n].launches - before[n] for n in ws
                 if ws[n].launches != before[n]}


def test_kernel_route_launches_per_stage(stand_in, monkeypatch):
    """The fb stage on meta tensors: four level launches, four scans, the
    follow path's arc lengths and one epilogue (s4 computed here: one more
    prefix sum); between the first level launch and the epilogue no
    stack, cat or flip is dispatched; every scan gets the level's rows."""
    args, kw = _meta_case()
    log = _Ops()
    level, epilogue = vs.fb_level, vs.epilogue

    def marked(fn, mark):
        def call(*a, **k):
            log.ops.append(mark)
            return fn(*a, **k)
        call.launches = 0       # the wrapper counts on its module's name
        return call
    monkeypatch.setattr(vs, "fb_level", marked(level, "<level>"))
    monkeypatch.setattr(vs, "epilogue", marked(epilogue, "<epilogue>"))
    with log:
        _, n = _launches(lambda: tvp.velocity_stage_scenario(*args, **kw))
    assert n == dict(FB_STAGE, prefix_sum=2), n
    assert [c.level for c in stand_in["vel_stage"].calls] == [0, 1, 2, 3]
    assert stand_in["vel_stage_epilogue"].calls[0].fb == 1
    assert len(stand_in["vel_scan"].calls) == 4
    inside = log.ops[log.ops.index("<level>"):log.ops.index("<epilogue>")]
    assert not {"stack", "cat", "flip", "where", "gather"} & set(inside), \
        sorted(set(inside))


def test_kernel_route_sqp_takes_the_epilogue_alone(stand_in):
    args, kw = _meta_case("sqp")
    _, n = _launches(lambda: tvp.velocity_stage_scenario(*args, **kw))
    assert n.get("vel_stage_epilogue") == 1 and "vel_stage_level" not in n, n
    assert stand_in["vel_stage_epilogue"].calls[0].fb == 0


@pytest.mark.parametrize("why", ["streams", "filt_window"])
def test_no_glue_kernel_without_the_constant_gg_unsmoothed(stand_in, why):
    """The gg-stream rows (the facade's form) and a smoothed profile keep
    the plain glue: no level or epilogue launch."""
    args, kw = _meta_case()
    kw = dict(kw, const_gg=None) if why == "streams" else \
        dict(kw, filt_window=3)
    _, n = _launches(lambda: tvp.velocity_stage_scenario(*args, **kw))
    assert "vel_stage_level" not in n and "vel_stage_epilogue" not in n, n


def test_facade_streams_call_takes_no_glue_kernel(stand_in):
    """``velocity_kernel`` (per-row gg streams scaled by the gg scales)
    keeps the plain glue with kernel 5."""
    args, kw = _meta_case(N=1)
    (paths, n_valids, gg, vel_course, c_len, vel_plan, vel_est, vel_max,
     machines, vmo, v_end_rl, red_len, obj_dist, v_obj, safety_d, osd,
     roll_vel, roll_cum, veh_length, *ctrl) = args
    R, P = 4, paths.shape[2]
    _, n = _launches(lambda: tvp.velocity_kernel(
        paths[0], n_valids[0], gg.expand(R, P, 2), vel_course[0], c_len[0],
        vel_plan[0], vel_est[0], vel_max, vel_max, vel_max, machines, vmo,
        red_len[0], red_len[0], v_end_rl[0], obj_dist.expand(R),
        v_obj.expand(R), safety_d, osd[0], roll_vel[0], roll_cum[0],
        veh_length, *ctrl))
    assert "vel_stage_level" not in n and "vel_stage_epilogue" not in n, n
    assert n.get("vel_scan", 0) > 0


@pytest.mark.parametrize("kernels", [True, False])
def test_cpu_and_plain_take_no_glue_kernel(kernels):
    args, kw = vc.stage_case(3, 20, 1, seed=1)
    _, n = _launches(lambda: tvp.velocity_stage_scenario(
        *args, **kw, kernels=kernels))
    assert not n, n


def _level_call(level):
    """A level's recorded call on the CPU, its tensors on the meta device."""
    args, kw = vc.stage_case(3, 20, 1, seed=3)
    _, calls = vc.recorded(lambda: _route(args, kw))
    a, k = calls["vel_stage_level"][level]
    return [_meta(x) for x in a], {
        n: tuple(_meta(y) for y in v) if isinstance(v, tuple) else _meta(v)
        for n, v in k.items()}


SPOILED = {
    "level": lambda a, k: ([7] + a[1:], k),
    "paths_dtype": lambda a, k: ([a[0], a[1].double()] + a[2:], k),
    "paths_shape": lambda a, k: ([a[0], a[1][..., :4]] + a[2:], k),
    "ay_shape": lambda a, k: (a[:9] + [a[9][:-1]] + a[10:], k),
    "fs": lambda a, k: (a[:17] + [4], k),
    "lv_shape": lambda a, k: (a, dict(k, lv=k["lv"][:-1])),
    "roll_vel": lambda a, k: (a[:15] + [a[15][:, :0]] + a[16:], k),
    "vel_max": lambda a, k: (a[:8] + [a[8].expand(2)] + a[9:], k),
}


@pytest.mark.parametrize("what", list(SPOILED))
def test_level_checks_raise_before_launch(stand_in, what):
    a, k = _level_call(2)
    a, k = SPOILED[what](a, k)
    before = vs.fb_level.launches
    with pytest.raises(ValueError):
        vs.fb_level(*a, **k)
    assert not stand_in and vs.fb_level.launches == before


def test_epilogue_checks_raise_before_launch(stand_in):
    args, kw = vc.stage_case(3, 20, 1, seed=3)
    _, calls = vc.recorded(lambda: _route(args, kw))
    (a, k), = calls["vel_stage_epilogue"]
    a = [_meta(x) for x in a]
    k = {n: tuple(_meta(y) for y in v) if isinstance(v, tuple) else _meta(v)
         for n, v in k.items()}
    before = vs.epilogue.launches
    for bad in (dict(k, vx_normal=k["lv2"]),               # fb and sqp
                dict(k, lv2=None),                          # neither
                dict(k, lv3=k["lv3"][:-1])):
        with pytest.raises(ValueError):
            vs.epilogue(*a, **bad)
    with pytest.raises(ValueError):
        vs.epilogue(*a[:9], a[9].int(), *a[10:], **k)       # pref_idx dtype
    assert not stand_in and vs.epilogue.launches == before


def test_level_route_fills_the_argument_block(stand_in):
    a, k = _level_call(1)
    a[9] = torch.empty((1,), device="meta").expand(a[1].shape[2])
    out = vs.fb_level(*a, **k)
    (args,), = [e.calls for e in stand_in.values()]
    N, kk, P = a[1].shape[:3]
    assert (args.N, args.k, args.P, args.fs, args.level) == (N, kk, P, 1, 1)
    assert args.ay_st == 0                       # the constant gg's stride
    assert out[1] is out[0]                      # level 1: k2 is k1
    assert tuple(out[0].shape) == (N * (kk + 2), P - 1)


def test_kernel_args_refuse_a_cpu_tensor():
    args, kw = vc.stage_case(3, 20, 1, seed=3)
    _, calls = vc.recorded(lambda: _route(args, kw))
    a, k = calls["vel_stage_level"][0]
    with pytest.raises(ValueError, match="CUDA"):
        vs.level_args(*a, **k)


def test_argument_block_is_the_kernel_s():
    """``StageArgs`` lists ``vel_stage::Args``'s fields in order, each of
    its C type's size; the sources and wrappers are registered."""
    src = (cb.CSRC / "vel_stage.cu").read_text()
    body = src[src.index("struct Args {"):]
    body = body[:body.index("};")].replace("long long", "longlong")
    fields = []
    for line in body.splitlines()[1:]:
        code = line.split("//")[0].strip().rstrip(";")
        if not code:
            continue
        m = re.match(r"(const )?(\w+)(\*?) ?(.*)", code)
        kind = "ptr" if m.group(3) or "*" in m.group(4) else m.group(2)
        for name in m.group(4).replace("*", "").split(","):
            fields.append((name.strip(), kind))
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "longlong",
                   ctypes.c_int: "int"}
    assert fields == [(n, ctypes_kind[t]) for n, t in vs.StageArgs._fields_]
    assert "vel_stage" in cb.SOURCES
    assert cb.KERNEL_WRAPPERS["vel_stage_level"].wrapper == \
        "cuda_velstage.fb_level"
    assert cb.KERNEL_WRAPPERS["vel_stage_epilogue"].wrapper == \
        "cuda_velstage.epilogue"


# ---- on the card ------------------------------------------------------------

def _held(calls):
    """Every recorded call's kernel against its plain version on the card;
    returns the largest ``ego_stop_d`` difference (m, share of bound)."""
    worst = (0.0, 0.0)
    for name, cs in calls.items():
        for a, k in cs:
            want = vc.plain_of(name)(*a, **k)
            got = vc.kernel_of(name)(*a, **k)
            torch.cuda.synchronize()
            ok, what, ego = vc.compare(name, a, k, got, want)
            assert ok, (name, a[0] if name == "vel_stage_level" else "",
                        what)
            if ego:
                worst = max(worst, ego)
    return worst


@pytest.mark.card
def test_fb_tick_calls_on_the_card():
    """The fb tick at B=1024 on the default oval (one opponent, and three
    in 16 slots): the eager kernel tick launches each level kernel four
    times and the epilogue once, the plain tick neither; every recorded
    call bit-equal to its plain version (``ego_stop_d`` within its
    bound), the stage's outputs equal to the plain stage's."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    lat = tl.build_lattice(tt.make_oval_track(), OfflineConfig(),
                           md5_params="oval").to("cuda")
    worst = (0.0, 0.0)
    for mix in MIXES.values():
        scen = tsc.random_scenarios(lat, 1024, seed=5, device="cuda", **mix)
        for kernels, want in ((True, 4), (False, 0)):
            tick = cuda_graph.eager(tsc.make_batched_tick(lat, kernels,
                                                          device="cuda"))
            _, launches = cb.counted(lambda: tick(scen), "cuda")
            assert launches["vel_stage_level"] == want, launches
            assert launches["vel_stage_epilogue"] == want // 4, launches
        tick = cuda_graph.eager(tsc.make_batched_tick(lat, device="cuda"))
        stage = []
        orig = tvp.velocity_stage_scenario

        def rec(*a, **kw):
            stage.append((a, kw))
            return orig(*a, **kw)
        tvp.velocity_stage_scenario = rec
        try:
            _, calls = vc.recorded(lambda: tick(scen))
        finally:
            tvp.velocity_stage_scenario = orig
        worst = max(worst, _held(calls))
        (a, kw), = stage
        got = tvp.velocity_stage_scenario(*a, **kw)
        want = tvp.velocity_stage_scenario(*a, **dict(kw, kernels=False))
        for key in ("trajs", "vel_bound", "too_close"):
            assert torch.equal(got[key], want[key]), key
    print(f"ego_stop_d: largest |kernel - plain| {worst[0]:.3g} m, "
          f"{100 * worst[1]:.3g} % of its bound")


@pytest.mark.card
@pytest.mark.parametrize("case", range(len(vc.CASES)))
@pytest.mark.parametrize("backend", ["fb", "sqp"])
def test_seeded_cases_on_the_card(case, backend):
    """Each seeded case on the card: every level and epilogue call
    bit-equal to its plain version (``ego_stop_d`` within its bound), the
    stage with the kernels equal to the stage without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    N, P, fs = vc.CASES[case]
    args, kw = vc.stage_case(N, P, fs, seed=100 + case, device="cuda",
                             backend=backend)
    got, calls = vc.recorded(lambda: tvp.velocity_stage_scenario(*args,
                                                                 **kw))
    assert len(calls["vel_stage_epilogue"]) == 1
    assert len(calls["vel_stage_level"]) == (4 if backend == "fb" else 0)
    worst = _held(calls)
    want = tvp.velocity_stage_scenario(*args, **dict(kw, kernels=False))
    for key in ("trajs", "vel_bound", "too_close"):
        assert torch.equal(got[key], want[key]), key
    print(f"case {vc.CASES[case]} {backend}: ego_stop_d largest |kernel - "
          f"plain| {worst[0]:.3g} m, {100 * worst[1]:.3g} % of its bound")
