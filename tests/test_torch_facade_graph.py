"""PyTorch port, the facade's compiled calls on the CPU: what
``GraphLTPL(device="cuda")`` runs on the card with the kernels, each device
step of the online handler (``OnlineHandler.steps``) captured as one CUDA
graph per input signature (``ops/cuda_graph.capture_on_card``).

Here the handler's steps are captured on the CPU: ``cuda_graph._cuda`` is
replaced by the stand-ins of ``tests/test_torch_graph.py`` (the graph
records the aten operators of the capture and runs them again on replay;
here each kernel wrapper is one unit of the record, as a kernel is one node
of a graph on the card), and every step's body runs under its
``HostGuard`` (no host read, no tensor built from Python data, no
device-waiting operator outside the kernel wrappers), as it must to be
captured on the card.

(a)+(b) Each drive of the JAX package's ``GraphLTPL`` (closed loop under
    the fake clock, recorded) is replayed through the port's facade with
    its captured calls: the default oval with its opponent and zone for 100
    ticks (every action kind and the emergency profile) and under the SQP
    INI for 25 ticks; the drives into unclosed Monteblanco's end (the fb
    ladder from layer 26, the SQP ladder from layer 30) are
    ``test_torch_facade_graph_ladder.py``'s.  Gates: action keys and node
    chains equal on every tick, trajectories within 2 mm and 0.02 m/s
    (PARITY.md), maxima printed; every body ran under the guard at its
    capture.
(c) Bounded signatures: the second half of the 100-tick oval drive
    captures no new signature, two ladder calls with different ``nb`` and
    ``c_len`` replay one graph, and the CPU and ``kernels=False`` handlers
    stay eager; ``cuda_graph.disabled()`` runs every captured call eagerly.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.planner.facade import (
    GraphLTPL as JaxGraphLTPL)
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.planner import handler as thandler
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.utils.config import OnlineConfig

from test_torch_graph import WRAPPERS, HostGuard, StandInCuda, _Record
from torch_port_common import (UNCLOSED_CSV, carry, jax_refit_repaired,
                               jax_small_oval)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFLINE_INI = os.path.join(ROOT, "params", "ltpl_config_offline.ini")
ONLINE_INI = os.path.join(ROOT, "params", "ltpl_config_online.ini")
SQP_INI = os.path.join(ROOT, "parity", "fixtures",
                       "ltpl_config_online_sqp.ini")
TOL_POS, TOL_VX = 2e-3, 0.02
STEPS = ("plan", "walk", "assemble", "opponent", "velocity", "brake_fb",
         "brake_sqp", "emergency")
# name -> (track, online INI, start layer, ticks, steps the drive reaches)
DRIVES = {
    "fb_oval": ("oval", ONLINE_INI, 0, 100,
                {"plan", "walk", "assemble", "opponent", "velocity",
                 "emergency"}),
    "fb_unclosed": (UNCLOSED_CSV, ONLINE_INI, 26, 95,
                    {"plan", "walk", "assemble", "velocity", "brake_fb",
                     "emergency"}),
    "sqp_oval": ("oval", SQP_INI, 0, 25,
                 {"plan", "walk", "assemble", "opponent", "velocity",
                  "emergency"}),
    "sqp_unclosed": (UNCLOSED_CSV, SQP_INI, 30, 58,
                     {"plan", "walk", "assemble", "velocity", "brake_sqp",
                      "emergency"}),
}


def _path_dict(tmp, track, online):
    store = "oval.npz" if track == "oval" else "unclosed.npz"
    return {"globtraj_input_path": track,
            "graph_store_path": os.path.join(tmp, store),
            "ltpl_offline_param_path": OFFLINE_INI,
            "ltpl_online_param_path": online,
            "graph_log_id": "test",
            "log_path": os.path.join(tmp, "logs")}


class _UnitRecord(_Record):
    """The stand-in graph's record, paused while a kernel wrapper runs."""
    paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _write_into(dst, src):
    """A replayed result into the tensors the capture made."""
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, x in zip(dst, src):
            _write_into(d, x)


class KernelUnits(StandInCuda):
    """The stand-in runtime with every kernel wrapper one unit of the
    graph: at capture the wrapper runs with the record paused and enters
    it as one call, which a replay makes again on the capture's tensors,
    as a graph on the card replays a kernel as one node."""

    def __init__(self):
        super().__init__()
        self.recording = None

    @contextlib.contextmanager
    def graph(self, g):
        self.recording = rec = _UnitRecord()
        try:
            with rec:
                yield
        finally:
            self.recording = None
        g.ops = rec.ops

    def unit(self, wrapper):
        def call(*a, **k):
            rec = self.recording
            if rec is None or rec.paused:
                return wrapper(*a, **k)
            rec.paused = True
            try:
                out = wrapper(*a, **k)
            finally:
                rec.paused = False
            rec.ops.append((lambda: _write_into(out, wrapper(*a, **k)), (),
                            {}, None))
            return out
        return call


@pytest.fixture
def compiled(monkeypatch):
    """Handlers made in the test capture their steps on the CPU stand-ins,
    each body under a :class:`HostGuard`; returns the stand-in runtime."""
    cuda = KernelUnits()
    monkeypatch.setattr(cuda_graph, "_cuda", cuda)
    guard = HostGuard(monkeypatch)
    for mod, attr in WRAPPERS:
        monkeypatch.setattr(mod, attr, cuda.unit(getattr(mod, attr)))

    def capture_on_card(fn, device, kernels=True):
        def guarded(*a, **k):
            with guard.on():
                return fn(*a, **k)
        return cuda_graph.capture(guarded, device) if kernels else fn
    monkeypatch.setattr(cuda_graph, "capture_on_card", capture_on_card)
    return cuda


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("facade_graph"))


def _jax_drive(tmp, name):
    """The JAX facade's drive, with the port's full-horizon refit
    (``jax_refit_repaired``: the oval drives pass full-horizon layers)."""
    track, online, layer, n, _ = DRIVES[name]
    j = JaxGraphLTPL(_path_dict(tmp, track, online), log_to_file=False)
    j.graph_init()
    lat = j.lattice
    pos, heading = cl.start_pose(np.asarray(lat.refline), layer)
    objs = zones = None
    if track == "oval":
        objs = cl.slow_opponent(np.asarray(lat.raceline),
                                np.asarray(lat.normvec), np.asarray(lat.s_rl))
        zones = cl.left_half_zone(np.asarray(lat.nodes_in_layer))
    with jax_refit_repaired():
        return pos, heading, zones, cl.drive(j, n, pos, heading, objs,
                                             zones)


def check_drive(tmp, compiled, name):
    """The JAX facade's drive ``name`` replayed through the port's facade
    with its captured calls: the gates of (a), (b) and, on the 100-tick
    oval, (c)."""
    track, online, _, n, reached = DRIVES[name]
    pos, heading, zones, rec_j = _jax_drive(tmp, name)
    ltpl = GraphLTPL(_path_dict(tmp, track, online), device="cpu",
                     log_to_file=False)
    ltpl.graph_init()
    steps = ltpl._oth.steps
    graphs = {s: steps[s].graphs for s in STEPS}
    calls = dict.fromkeys(STEPS, 0)
    for s, f in list(steps.items()):
        def counted(*a, _f=f, _s=s, **k):
            calls[_s] += 1
            return _f(*a, **k)
        counted.graphs = graphs[s]
        steps[s] = counted
    sigs = []
    rec = cl.drive(ltpl, n, pos, heading, zones=zones, replay=rec_j,
                   on_tick=lambda t: sigs.append(ltpl._oth.signatures()))
    d_pos, d_vx, seen = cl.compare(rec_j, rec)
    per_step = {s: len(g) for s, g in graphs.items() if g}
    replays = sum(g.replays for g in compiled.made)
    print(f"compiled facade {name}, {n} ticks: max |d s,x,y| = {d_pos:.3g} "
          f"m, max |d vx| = {d_vx:.3g} m/s, actions {sorted(seen)}; "
          f"signatures {sigs[-1]} {per_step} (after tick {n // 2 - 1}: "
          f"{sigs[n // 2 - 1]}) for calls "
          f"{ {s: c for s, c in calls.items() if c} }")
    assert d_pos <= TOL_POS and d_vx <= TOL_VX, (d_pos, d_vx)
    assert set(per_step) == reached, per_step
    # every call replays its signature's graph, the first right after the
    # capture
    assert len(compiled.made) == sigs[-1] and replays == sum(calls.values())
    if name.endswith("oval"):
        assert seen == {"straight", "follow", "left", "right", "emergency"}
    else:
        # every ladder call of the drive (nb and c_len change) on one graph
        ladder = f"brake_{name[:-len('_unclosed')]}"
        assert calls[ladder] >= 2 and per_step[ladder] == 1, calls
    if name == "fb_oval":
        assert sigs[n // 2 - 1] == sigs[-1], sigs


@pytest.mark.parametrize("name", ["fb_oval", "sqp_oval"])
def test_compiled_facade_matches_jax(tmp, compiled, name):
    """(a), (b) and (c) on the oval: the port's facade with its captured
    calls against the JAX facade tick by tick (the drives into the
    unclosed track's end are ``test_torch_facade_graph_ladder.py``'s)."""
    check_drive(tmp, compiled, name)


@pytest.fixture(scope="module")
def small_oval():
    return carry(jax_small_oval())


def _handler(lat, online=SQP_INI, kernels=True):
    return thandler.OnlineHandler(lat, OnlineConfig.from_ini(online),
                                  kernels=kernels)


def _ladder_inputs(h, seed, nb, c_len):
    """A made-up backup path (a gentle left arc, ``nb`` points) padded as
    the handler pads it, with its gg, velocity course and start speed."""
    rng = np.random.default_rng(seed)
    psi = 0.004 * np.arange(nb)
    path = np.column_stack([np.cumsum(np.cos(psi)) * 2.0,
                            np.cumsum(np.sin(psi)) * 2.0, psi,
                            np.full(nb, 0.002), np.full(nb, 2.0)])
    gg = np.full((h.P, 2), 5.0, np.float32)
    gg[:nb] = rng.uniform(4.5, 5.5, (nb, 2))
    vc = np.zeros(h.P, np.float32)
    vc[:c_len] = 20.0 + rng.random(c_len)
    return (h._pad_path(path.astype(np.float32)), gg, vc, nb, c_len,
            20.0 + rng.random())


@pytest.mark.parametrize("online", [ONLINE_INI, SQP_INI],
                         ids=["fb", "sqp"])
def test_ladder_calls_replay_one_graph(small_oval, compiled, online):
    """(c): the ladder's brake calls with different ``nb`` and ``c_len``
    (tensors, as JAX traces them) replay the graph of the first, each
    bit-equal to the eager call on the same inputs."""
    h = _handler(small_oval, online)
    machines = h._f32([[0.0, 5.0], [100.0, 5.0]])
    step = h.steps["brake_sqp" if h.vp_backend == "sqp" else "brake_fb"]
    for seed, (nb, c_len) in enumerate(((150, 3), (97, 5))):
        args = _ladder_inputs(h, seed, nb, c_len) + (machines, 3.0)
        got = h._backup_brake(*args)
        with cuda_graph.disabled():
            ref = h._backup_brake(*args)
        assert torch.equal(got, ref), nb
        assert torch.isfinite(got).all()
    assert len(step.graphs) == 1 and h.signatures() == 1
    assert [g.replays for g in compiled.made] == [2]


def test_cpu_and_plain_stay_eager(small_oval, monkeypatch):
    """(c): on the CPU and with ``kernels=False`` no step is captured, and
    the handler asks for its steps by the port's rule."""
    asked = []
    real = cuda_graph.capture_on_card

    def spy(fn, device, kernels=True):
        asked.append((torch.device(device).type, kernels))
        return real(fn, device, kernels)
    monkeypatch.setattr(cuda_graph, "capture_on_card", spy)
    for kernels in (True, False):
        h = _handler(small_oval, kernels=kernels)
        assert set(h.steps) == set(STEPS)
        assert all(cuda_graph.eager(f) is f for f in h.steps.values())
        assert h.signatures() == 0
    assert asked == [("cpu", True)] * 8 + [("cpu", False)] * 8
    fn = h.steps["plan"]
    assert real(fn, "cuda", kernels=False) is fn


def test_disabled_runs_eager(compiled):
    """Inside ``cuda_graph.disabled()`` a captured call runs its eager
    function and captures nothing; outside it captures and replays."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2.0
    f = cuda_graph.capture(fn, "cpu")
    x = torch.arange(3.0)
    with cuda_graph.disabled():
        with cuda_graph.disabled():
            assert torch.equal(f(x), x * 2.0)
        assert torch.equal(f(x), x * 2.0)
    assert len(calls) == 2 and f.graphs == {} and not compiled.made
    assert torch.equal(f(x + 1.0), (x + 1.0) * 2.0)
    assert torch.equal(f(x), x * 2.0)
    # the first call: one warm-up and one capture, the second a replay
    assert len(calls) == 4 and len(f.graphs) == 1
    assert compiled.made[0].replays == 2
