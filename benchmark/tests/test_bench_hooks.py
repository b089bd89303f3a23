"""The hooks through which a configuration, a velocity backend's plain
reference, a warm start carried tick to tick and a kernel's work count
are added as new files and entries alone, on the CPU with the program's
plain path and the small mixes of ``helpers.py``."""

import configparser
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import cells, core, fleet, work
from benchmark.reference import plan
from benchmark.tests import helpers


def _fb():
    _, cfg, mix = helpers.cell()
    return cfg, helpers.small_fleet_mix(mix)


def _with_backend(cfg, tmp_path, backend):
    """The configuration with its online INI's ``vp_type`` set to
    ``backend`` (a copy of the INI in ``tmp_path``)."""
    cp = configparser.ConfigParser()
    cp.read(os.path.join(core.ROOT, cfg["online_ini"]))
    cp.set("VP", "vp_type", backend)
    path = tmp_path / "online.ini"
    with open(path, "w") as fh:
        cp.write(fh)
    return dict(cfg, online_ini=str(path))


# ---------------------------------------------------------------------------
# tick and reference options from the configuration
# ---------------------------------------------------------------------------

def test_fb_configuration_options_are_unchanged():
    """The fb configuration's tick options are the parent's fixed dict;
    the reference's are the parent's with the mapped names it was not
    handed before (the backend that picks its speed stage, the smoothing
    window, the controller's gains as one dict) beside them."""
    cfg, _ = _fb()
    lat = helpers.ref_lattice(cfg["name"])
    v = core.ini_values(cfg)
    veh = cfg["vehicle"]
    tick = dict(vp_backend=v["vp_backend"], filt_window=v["filt_window"],
                w_last_factors=v["w_last_factors"], vel_max=veh["vel_max"],
                gg_lim=tuple(veh["gg"]), safety_d=veh["safety_d"],
                dyn_model_exp=veh["dyn_model_exp"],
                drag_coeff=veh["drag_coeff"], m_veh=veh["m_veh"])
    pd = v["control_params"]
    ref = dict(cfg["vehicle"], w_last_factors=v["w_last_factors"],
               v_max_offset=v["v_max_offset"], c_p=pd["c_p"], k_d=pd["k_d"],
               k_p=pd["k_p"], veh_length=lat.cfg.veh_length)
    got = core.tick_options(cfg)
    assert got == tick and isinstance(got["gg_lim"], tuple)
    got = core.reference_params(cfg, lat)
    assert {k: got[k] for k in ref} == ref
    assert set(got) - set(ref) == {"vp_backend", "filt_window",
                                   "control_params"}
    assert got["vp_backend"] == "fb"


def test_every_mapped_name_and_literal_reaches_the_tick():
    cfg, _ = _fb()
    lat = helpers.ref_lattice(cfg["name"])
    sqp = dict(cfg, ini_to_tick=dict(cfg["ini_to_tick"], **{
        "EXPORT.nmbr_export_points": "sqp_m"}),
        tick_literals={"tire_end_idx": 2, "sqp_step": 2.5})
    opts = core.tick_options(sqp)
    assert opts == dict(core.tick_options(cfg), sqp_m=115, tire_end_idx=2,
                        sqp_step=2.5)
    assert not {"v_max_offset", "control_params"} & set(opts)
    ref = core.reference_params(sqp, lat)
    assert (ref["sqp_m"], ref["tire_end_idx"], ref["sqp_step"]) == (
        115, 2, 2.5)
    with pytest.raises(ValueError, match="sqp_m"):
        core.mapped_values(dict(sqp, tick_literals={"sqp_m": 100}))


def test_fb_smoothing_is_still_refused(tmp_path):
    cfg, _ = _fb()
    cp = configparser.ConfigParser()
    cp.read(os.path.join(core.ROOT, cfg["online_ini"]))
    cp.set("SMOOTHING", "filt_window_width", "5")
    path = tmp_path / "online.ini"
    with open(path, "w") as fh:
        cp.write(fh)
    with pytest.raises(ValueError, match="unsmoothed"):
        core.reference_params(dict(cfg, online_ini=str(path)),
                              helpers.ref_lattice(cfg["name"]))


# ---------------------------------------------------------------------------
# the reference's speed stage by backend
# ---------------------------------------------------------------------------

def test_a_backend_without_its_reference_stops_at_set_up(tmp_path,
                                                         monkeypatch):
    """vp_type=sqp with no vp_sqp.py beside the reference: the run stops
    in its set-up, naming the file, and never reaches the window."""
    cfg, mix = _fb()
    monkeypatch.setattr(plan, "HERE", str(tmp_path))      # no backend files
    built = []
    monkeypatch.setattr(fleet, "program_tick",
                        lambda *a, **k: built.append(1))

    def window(*a, **k):
        raise AssertionError("the window ran")
    monkeypatch.setattr(fleet, "window", window)
    c = core.cell(helpers.MAN, helpers.CELL)
    with pytest.raises(FileNotFoundError, match="benchmark/reference/"
                                                "vp_sqp.py"):
        cells.run_cell(helpers.MAN, c, _with_backend(cfg, tmp_path, "sqp"),
                       mix, 3, 0.1, False, core.clock(), helpers.CPU)
    assert not built
    with pytest.raises(ValueError, match="not a name"):
        plan.speed_stage("../sqp")


STUB = '''
from benchmark.reference import plan


def speeds(tp, car, paths, n_real, b, red, v_end_rl, obj_dist, v_obj,
           opp_stop, opp_v, opp_cum, **over):
    tp["seen"].append(dict(car=car, paths=paths, n_real=n_real, b=b,
                           red=red, over=over))
    return plan.speeds(tp, car, paths, n_real, b, red, v_end_rl, obj_dist,
                       v_obj, opp_stop, opp_v, opp_cum)
'''


def test_a_backend_file_gets_the_documented_arguments(tmp_path,
                                                      monkeypatch):
    """A stub backend in a temporary copy of the reference's directory
    (delegating to the fb stage) is loaded by its path and called once
    with plan.speeds' arguments and the carried inputs as keywords."""
    cfg, mix = _fb()
    lat = helpers.ref_lattice(cfg["name"])
    batch = fleet.make_batches(lat, mix, 11, js=[0])[0]
    tp = core.reference_params(cfg, lat)
    want = plan.replan(lat, batch, tp)
    (tmp_path / "vp_stub.py").write_text(STUB)
    monkeypatch.setattr(plan, "HERE", str(tmp_path))
    x0 = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    stub = dict(tp, vp_backend="stub", seen=[])
    got = plan.replan(lat, batch, stub, {"sqp_x0": x0})
    assert len(stub["seen"]) == 1
    seen = stub["seen"][0]
    assert list(seen["over"]) == ["sqp_x0"] and seen["over"]["sqp_x0"] is x0
    assert seen["b"] is batch
    P = plan.C_ROWS + plan.path_rows(lat)
    assert seen["paths"].shape == (8, 4, P, 5)
    assert seen["n_real"].shape == seen["red"].shape == (8, 4)
    assert seen["car"].ay == tp["gg"][1]
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# a warm start carried tick to tick
# ---------------------------------------------------------------------------

class FakeTick:
    """A compiled tick's stand-in: every call logged, each output ``y``
    the call's number; ``__wrapped__`` its eager body, logged apart."""

    def __init__(self):
        self.log = []
        self.__wrapped__ = lambda scen, **kw: self._call("eager", scen, kw)
        self.graphs = {"one": None}

    def __call__(self, scen, **kw):
        return self._call("compiled", scen, kw)

    def _call(self, how, scen, kw):
        self.log.append((how, scen, kw))
        return {"y": torch.full((2,), float(len(self.log)))}

    def report(self):
        return {"captures": 1}


def test_carry_feeds_each_batchs_own_previous_output():
    fake = FakeTick()
    t = fleet.Carried(fake, {"x0": "y"})
    a, b = object(), object()
    t.start([a, b])
    assert [(h, s, kw) for h, s, kw in fake.log] == [("eager", a, {}),
                                                    ("eager", b, {})]
    t.start([a, b])                        # started batches stay as they are
    assert len(fake.log) == 2
    out_a = t(a)
    assert fake.log[-1][0] == "compiled"
    assert torch.equal(fake.log[-1][2]["x0"], torch.full((2,), 1.0))
    t(b)
    assert torch.equal(fake.log[-1][2]["x0"], torch.full((2,), 2.0))
    t(a)                                    # a's own previous output
    assert torch.equal(fake.log[-1][2]["x0"], out_a["y"])
    assert t.inputs(a)["x0"] is fake.log[-1][2]["x0"]
    t.__wrapped__(b)                        # the eager body, carried too
    assert fake.log[-1][0] == "eager"
    assert torch.equal(fake.log[-1][2]["x0"], torch.full((2,), 4.0))
    assert t.graphs is fake.graphs and t.report() == {"captures": 1}


def test_a_mix_without_carry_gets_the_programs_tick_itself():
    cfg, mix = _fb()
    f = fleet.setup(cfg, mix, 3, helpers.CPU)
    assert not isinstance(f.tick, fleet.Carried)
    f = fleet.setup(cfg, dict(mix, carry={"sqp_x0": "vx_sqp"}), 3,
                    helpers.CPU)
    assert isinstance(f.tick, fleet.Carried)


def test_a_carried_run_hands_the_check_the_kept_outputs_inputs(
        monkeypatch):
    """A whole CPU run of a mix with ``carry``: each batch's first tick
    is cold, every later one takes its own batch's previous output, and
    the reference gets the carried inputs of each checked row's kept
    output."""
    cfg, mix = _fb()
    mix = dict(mix, carry={"x0": "x_next"})
    real = fleet.program_tick
    log = []

    def program_tick(*a, **k):
        tick = real(*a, **k)

        def fake(scen, x0=None):
            out = dict(tick(scen))
            log.append((scen, x0))
            out["x_next"] = torch.full((scen.start_layer.shape[0], 3),
                                       float(len(log)))
            return out
        return fake
    monkeypatch.setattr(fleet, "program_tick", program_tick)
    seen = []
    real_replan = plan.replan

    def replan(lat, batch, tp, over=None):
        seen.append(over)
        return real_replan(lat, batch, tp)       # fb takes none
    monkeypatch.setattr(plan, "replan", replan)
    seed = 2 ** 33 + 17
    res, checks = helpers.run(mix=mix, seed=seed)
    assert res["correct"], checks
    n = mix["n_batches"]
    batches = [s for s, _ in log[:n]]
    assert all(x0 is None for _, x0 in log[:n])          # the cold start

    def batch_of(scen):
        return next(j for j, b in enumerate(batches) if b is scen)
    made = {j: float(j + 1) for j in range(n)}   # each batch's last output
    for k, (scen, x0) in enumerate(log[n:], start=n):
        j = batch_of(scen)
        assert torch.equal(x0, torch.full_like(x0, made[j]))
        made[j] = float(k + 1)
    assert len(log) > 2 * n
    last = {batch_of(scen): x0 for scen, x0 in log}
    rows = fleet.sample_rows(seed, n, mix["batch"], mix["check_per_batch"])
    want = np.concatenate([last[j][r].numpy() for j, r in enumerate(rows)])
    assert len(seen) == 1 and list(seen[0]) == ["x0"]
    assert np.array_equal(seen[0]["x0"], want)


# ---------------------------------------------------------------------------
# a work count per kernel
# ---------------------------------------------------------------------------

_MODE_OPS = {0: 24, 1: 13, 2: 28}
_MODE_STREAMS = {0: 3, 1: 2, 2: 4}


def _parent_vel_scan_cgg(args, out):
    """The parent's ``work.vel_scan_cgg``, frozen."""
    k1, mode = args[0], args[5]
    T = k1.shape[1]
    counts = {m: int((mode == m).sum()) for m in (0, 1, 2)}
    nb = sum(c * T * 4 * _MODE_STREAMS[m] for m, c in counts.items())
    nb += k1.shape[0] * 8 + work.nbytes(out)
    ops = sum(c * T * _MODE_OPS[m] for m, c in counts.items())
    return nb, ops


PLANTED = '''
MODULE = "cuda_velocity"
ATTR = "vel_scan"
PATTERN = "vel_scan_kernel<false"


def count(args, kwargs, out):
    return 1000 + args[0].shape[0], 7
'''

GONE = '''
MODULE = "cuda_no_such_wrapper"
ATTR = "nothing"
PATTERN = "nothing"


def count(args, kwargs, out):
    raise AssertionError("counted a kernel the program does not have")
'''


def test_each_kernel_file_counts_with_its_own_count(tmp_path, monkeypatch):
    """On a recorded eager tick each counted kernel's work comes from its
    own file's count: vel_scan_cgg's equals the parent's formula over the
    same calls, a planted second kernel's is its own, and a kernel whose
    wrapper the program lacks is left out."""
    from graphbasedlocaltrajectoryplanner_torch.ops import (cuda_assemble,
                                                             cuda_velocity)
    for f in os.listdir(work.KERNELS_DIR):
        if f.endswith(".py"):
            shutil.copy(os.path.join(work.KERNELS_DIR, f), tmp_path)
    (tmp_path / "planted.py").write_text(PLANTED)
    (tmp_path / "gone.py").write_text(GONE)
    monkeypatch.setattr(work, "KERNELS_DIR", str(tmp_path))
    calls = {}

    def spy(mod, attr):
        fn = getattr(mod, attr)

        def f(*a, **kw):
            out = fn(*a, **kw)
            calls.setdefault(attr, []).append((a, kw, out))
            return out
        monkeypatch.setattr(mod, attr, f)
    spy(cuda_velocity, "vel_scan_cgg")
    spy(cuda_velocity, "vel_scan")
    spy(cuda_assemble, "assemble_path")
    cfg, mix = _fb()
    f = fleet.setup(cfg, mix, 5, helpers.CPU)
    w = {}
    inner = cuda_velocity.vel_scan_cgg
    with work.recorded(core.PROGRAM, w):
        assert cuda_velocity.vel_scan_cgg is not inner
        f.tick(f.batches[0])
    assert cuda_velocity.vel_scan_cgg is inner           # restored
    assert set(w) == {"vel_scan_cgg", "planted", "assemble"}
    cgg = calls["vel_scan_cgg"]
    parent = [_parent_vel_scan_cgg(a, out) for a, _, out in cgg]
    assert w["vel_scan_cgg"] == (sum(p[0] for p in parent),
                                 sum(p[1] for p in parent), len(cgg))
    gen = calls["vel_scan"]
    assert w["planted"] == (sum(1000 + a[0].shape[0] for a, _, _ in gen),
                            7 * len(gen), len(gen))
    asm = calls["assemble_path"]
    assert w["assemble"][2] == len(asm) == 1
    assert w["assemble"] != w["vel_scan_cgg"] != w["planted"]


def test_assemble_count_is_the_kernel_tables():
    """The fleet tick's call at B=1024 (4,096 rows, H=27, 384 points,
    int64 indices): 41.3 MB, 35.5 MB of it written; bytes bound it."""
    m = torch.device("meta")
    args = (torch.empty((61, 24, 24, 10), device=m),
            torch.empty((1024, 28), dtype=torch.int64, device=m),
            torch.empty((4096, 28), dtype=torch.int64, device=m),
            torch.empty((4096,), dtype=torch.int64, device=m),
            torch.empty((4096,), device=m), 384)
    out = dict(path=torch.empty((4096, 384, 5), device=m),
               n_valid=torch.empty((4096,), dtype=torch.int64, device=m),
               node_idx=torch.empty((4096, 28), dtype=torch.int32, device=m),
               coeffs=torch.empty((4096, 27, 8), device=m))
    k = work.kernel("assemble")
    nb, ops = k.count(args, {}, out)
    assert work.nbytes(*out.values()) == 35_487_744
    assert nb == 41_271_296
    assert ops == 4096 * 384 * 80
    assert k.count(args[:2], dict(zip(("nodes", "h_eff", "psi_s", "p_max"),
                                      args[2:])), out) == (nb, ops)
    assert work.bound_ms(nb, ops) == pytest.approx(nb / 3.35e9)
    assert work.bound_ms(nb, ops) == pytest.approx(0.0123, abs=5e-5)
