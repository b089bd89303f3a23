"""PyTorch port, the compiled fleet tick on the CPU: what
``make_batched_tick`` returns on the card with the kernels, the tick
captured as one CUDA graph per input signature (``ops/cuda_graph.py``).

(a) Capture safety.  The kernel-routed tick (the default ``kernels=True``;
    on the CPU its kernel wrappers take their plain versions) runs on the
    small oval at B=8 under :class:`HostGuard`, which raises on a host read
    of a tensor (``item``, ``tolist``, ``bool``, ``int``, ``float``,
    ``index``, ``cpu``, ``numpy``), on a tensor built from Python data
    (``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``) and on the
    aten operators that wait for the device (``_local_scalar_dense``,
    ``nonzero``, ``masked_select``, ``unique``, ``equal``,
    ``repeat_interleave`` on a tensor of counts).  On the card a kernel
    stands where each ``ops/cuda_*`` wrapper is, so the wrappers run with
    the guard suspended.  Every velocity backend and option of the fleet
    tick is run.

(b) Capture and replay logic.  ``cuda_graph._cuda`` (the CUDA runtime as
    the capture uses it) is replaced by CPU stand-ins
    (``testing_tools/graph_standins.py``): the graph records
    every aten operator the captured call runs, with its tensors, and a
    replay runs the record again on the same tensors, each result written
    into the tensor the capture made, as a CUDA graph replays its kernels
    on its buffers.  The Python code of the tick runs only at capture, as
    on the card.  Held: two seeded batches through one captured tick
    against the JAX tick (``test_torch_tick._compare``: exact fields
    equal, trajectories within 2 mm and 0.02 m/s, maxima printed), a
    call's outputs untouched by the next call, a 3-tick sqp warm-start
    chain bit-equal to the eager chain, and a new signature captured anew.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_torch.ops import (
    cuda_admm, cuda_backtrace, cuda_collision, cuda_graph, cuda_minplus,
    cuda_velocity, cuda_window)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    profile_stages)
# the stand-ins live in the package, where dist_cases' CPU ranks use them
from graphbasedlocaltrajectoryplanner_torch.testing_tools.graph_standins \
    import Record as _Record, StandInCuda, StandInGraph  # noqa: F401

from test_torch_tick import _compare, _jax_tick
from torch_port_common import carry, jax_small_oval

B = 8
EXACT_SQP = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel",
             "em_base", "qp_status", "vx_sqp", "trajs")
# the ops/cuda_* wrappers of the tick's kernels (and the min-plus scan's)
WRAPPERS = ((cuda_collision, "hit_slab"), (cuda_window, "fused_window_dp"),
            (cuda_backtrace, "backtrace_walk"), (cuda_velocity, "vel_scan"),
            (cuda_velocity, "vel_scan_cgg"), (cuda_admm, "admm_vel"),
            (cuda_minplus, "minplus_scan"))
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__", "cpu", "numpy")
FROM_DATA = ("tensor", "as_tensor", "from_numpy")
# aten operators that wait for the device (their result is on the host, or
# its shape depends on the data)
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive", "equal", "is_nonzero")


class _SyncOps(TorchDispatchMode):
    def __init__(self, guard):
        super().__init__()
        self.guard = guard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.guard.active and (name in SYNC_OPS or str(func) ==
                                  "aten.repeat_interleave.Tensor"):
            raise AssertionError(f"{func} in the tick body")
        return func(*args, **(kwargs or {}))


class HostGuard:
    """While :meth:`on` is entered, raises on a host read, on a tensor
    built from Python data and on a device-waiting operator; the kernel
    wrappers suspend it."""

    def __init__(self, monkeypatch):
        self.active = False
        for name in HOST_READS:
            orig = getattr(torch.Tensor, name)

            def read(t, *a, _orig=orig, _name=name, **k):
                if self.active:
                    raise AssertionError(f"Tensor.{_name} in the tick body")
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, read)
        for name in FROM_DATA:
            orig = getattr(torch, name)

            def make(data, *a, _orig=orig, _name=name, **k):
                if self.active and not torch.is_tensor(data):
                    raise AssertionError(
                        f"torch.{_name}({type(data).__name__}) in the tick "
                        "body")
                return _orig(data, *a, **k)
            monkeypatch.setattr(torch, name, make)
        for mod, attr in WRAPPERS:
            orig = getattr(mod, attr)

            def kernel(*a, _orig=orig, **k):
                with self.suspended():
                    return _orig(*a, **k)
            monkeypatch.setattr(mod, attr, kernel)

    @contextlib.contextmanager
    def suspended(self):
        was, self.active = self.active, False
        try:
            yield
        finally:
            self.active = was

    @contextlib.contextmanager
    def on(self):
        self.active = True
        try:
            with _SyncOps(self):
                yield
        finally:
            self.active = False


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    lat = carry(ja)
    scen = tsc.random_scenarios(lat, B, seed=0, n_objects=1, device="cpu")
    return ja, lat, scen


def _zones(lat, scen, per_scenario):
    """Zone masks blocking the raceline node and its neighbours a few
    layers ahead of every scenario (the per-scenario masks one layer apart
    from scenario to scenario)."""
    rl = lat.rl_idx.numpy()
    starts = scen.start_layer.numpy()
    zone = np.zeros((len(starts) if per_scenario else 1, lat.L, lat.N), bool)
    for b, sl in enumerate(starts):
        lay = (int(sl) + 3 + (b % 3 if per_scenario else 0)) % lat.L
        zone[b if per_scenario else 0,
             lay, max(rl[lay] - 1, 0):rl[lay] + 2] = True
    return torch.from_numpy(zone if per_scenario else zone[0])


def _warm(lat):
    P = tsc.C_PAD + tsc.default_p_max(lat)
    rng = np.random.default_rng(5)
    return torch.from_numpy(
        (12.0 + 20.0 * rng.random((B, 4, P))).astype(np.float32))


# name -> (make_batched_tick options, per-call overrides)
CASES = {
    "fb": ({}, {}),
    "sqp_cold": ("sqp", {}),
    "sqp_warm": ("sqp", "warm"),
    "p_max+64": ("p_max", {}),
    "filt_window=5": (dict(filt_window=5), {}),
    "incl_emergency=False": (dict(incl_emergency=False), {}),
    "until=assembly": (dict(until="assembly"), {}),
    "until=decide": (dict(until="decide"), {}),
    "zone_shared": ("zone", {}),
    "zone_per_scenario": ("zones", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tick_body_is_capture_safe(oval, monkeypatch, case):
    """(a): no host read and no construction from Python data in the
    kernel-routed tick body, for each velocity backend and option."""
    _, lat, scen = oval
    kw, over = CASES[case]
    make = {}
    if kw == "sqp":
        kw = profile_stages.sqp_options(lat)
    elif kw == "p_max":
        kw = dict(p_max=tsc.default_p_max(lat) + 64)
    elif kw in ("zone", "zones"):
        make = dict(zone_block=_zones(lat, scen, kw == "zones"))
        kw = {}
    if over == "warm":
        over = dict(sqp_x0=_warm(lat))
    tick = tsc.make_batched_tick(lat, device="cpu", **make, **kw)
    guard = HostGuard(monkeypatch)
    with guard.on():
        out = tick(scen, **over)
    assert all(torch.is_tensor(v) for v in out.values())


def test_host_guard_catches_each_kind(monkeypatch):
    """The guard of (a) raises on each kind of fault it looks for, and not
    inside a kernel wrapper."""
    guard = HostGuard(monkeypatch)
    x = torch.arange(4.0)
    faults = [lambda: x[0].item(), lambda: bool(x.sum()),
              lambda: torch.tensor([1.0, 2.0]), lambda: torch.as_tensor(3),
              lambda: torch.nonzero(x), lambda: x.cpu(),
              lambda: torch.equal(x, x)]
    for fault in faults:
        with pytest.raises(AssertionError):
            with guard.on():
                fault()
    with guard.on():
        torch.as_tensor(x)
        cuda_graph.as_tensor(2.5, torch.float32, "cpu")
        v = cuda_velocity.vel_scan_cgg(
            torch.zeros(2, 3), torch.zeros(2, 3), torch.ones(2, 3),
            torch.full((2, 3), 50.0), torch.full((2,), 10.0),
            torch.zeros(2, dtype=torch.int32),
            tsc.default_machines("cpu"), 1.0, 0.85, 1000.0, 10.0, 10.0)
    assert v.shape == (2, 4)


# ---- (b): the capture and replay logic on CPU stand-ins --------------------

@pytest.fixture
def stand_in(monkeypatch):
    cuda = StandInCuda()
    monkeypatch.setattr(cuda_graph, "_cuda", cuda)
    return cuda


def _captured(lat, **kw):
    eager = tsc.make_batched_tick(lat, device="cpu", **kw)
    return cuda_graph.capture(eager, "cpu"), eager


def test_capture_on_card_rule():
    """Captured on a CUDA device with the kernels only; the eager function
    stays reachable as ``__wrapped__``."""
    def fn(x):
        return x
    tick = cuda_graph.capture_on_card(fn, torch.device("cuda"), True)
    assert tick.__wrapped__ is fn and tick.graphs == {}
    assert cuda_graph.eager(tick) is fn
    assert cuda_graph.capture_on_card(fn, "cuda", kernels=False) is fn
    assert cuda_graph.capture_on_card(fn, "cpu", True) is fn
    assert cuda_graph.eager(fn) is fn
    assert not hasattr(tsc.make_batched_tick(carry(jax_small_oval()),
                                             device="cpu"), "graphs")


def test_replay_matches_jax_on_two_batches(oval, stand_in):
    """One signature captured once: the first batch (its capture's) and a
    second batch made after the capture, each against the JAX tick; every
    call returns the replay's result."""
    ja, lat, scen = oval
    tick, _ = _captured(lat)
    jt = _jax_tick(ja)
    zone0 = np.zeros((lat.L, lat.N), bool)
    for seed in (0, 3):
        js = jsc.random_scenarios(ja, B, seed=seed, n_objects=1)
        ts = tsc.random_scenarios(lat, B, seed=seed, n_objects=1,
                                  device="cpu")
        _compare(jt(js, zone0), tick(ts), f"captured tick seed {seed}")
    assert len(tick.graphs) == 1 and len(stand_in.made) == 1
    assert stand_in.made[0].replays == 2


def test_outputs_survive_the_next_call(oval, stand_in):
    """A call's outputs are its own: the next call, on another batch, does
    not write into them."""
    _, lat, scen = oval
    tick, eager = _captured(lat)
    out1 = tick(scen)
    kept = {k: v.clone() for k, v in out1.items()}
    other = tsc.random_scenarios(lat, B, seed=7, n_objects=2, device="cpu")
    out2 = tick(other)
    assert not torch.equal(out2["trajs"], kept["trajs"])
    ref = eager(scen)
    for k, v in out1.items():
        assert torch.equal(v, kept[k]), k
        assert torch.equal(v, ref[k]), k


def test_sqp_warm_chain_bit_equal_to_eager(oval, stand_in):
    """Three sqp ticks, each after the first warm-started from the one
    before (``vx_sqp`` fed back as ``sqp_x0``): the captured chain equals
    the eager chain bit for bit in every field."""
    _, lat, scen = oval
    tick, eager = _captured(lat, **profile_stages.sqp_options(lat))
    over_c, over_e = {}, {}
    for step in range(3):
        oc, oe = tick(scen, **over_c), eager(scen, **over_e)
        assert set(oc) == set(oe)
        for k in EXACT_SQP:
            assert torch.equal(oc[k], oe[k]), (step, k)
        over_c, over_e = dict(sqp_x0=oc["vx_sqp"]), dict(sqp_x0=oe["vx_sqp"])
    # the cold call and the warm signature
    assert len(tick.graphs) == 2


def test_new_signature_captures_again(oval, stand_in):
    """A new batch size and a new value of a non-tensor override each
    capture a graph of their own; a repeated signature replays."""
    _, lat, scen = oval
    tick, eager = _captured(lat)
    tick(scen)
    small = tsc.random_scenarios(lat, 3, seed=2, n_objects=1, device="cpu")
    calls = [(small, {}), (scen, dict(filt_window=3)),
             (small, dict(filt_window=3)), (scen, dict(filt_window=3))]
    for s, over in calls:
        out = tick(s, **over)
        for k, v in eager(s, **over).items():
            assert torch.equal(out[k], v), (over, k)
    assert len(tick.graphs) == 4 and len(stand_in.made) == 4
    assert [g.replays for g in stand_in.made] == [1, 1, 2, 1]
