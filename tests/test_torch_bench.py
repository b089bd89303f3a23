"""PyTorch port, the bench and its parity gate
(``graphbasedlocaltrajectoryplanner_torch/bench.py``,
``testing_tools/cuda_parity.py``) on the CPU at a small size, on
``entry.small_lattice()``: the command line writes every key of its
details, its last line has its five keys; the scenarios of sections a-e are
the root bench's, bit for bit, and the port's plain ticks on them match the
JAX ticks; the gate's end-to-end comparator gives the verdicts and maxima
of ``tools/pallas_parity.check_end_to_end``; without a card (and without
asking for the CPU) the bench and the gate raise; ``profile_sqp.
trace_attribution`` traces no device on the CPU.

Tolerances: scenarios bit-equal; ticks exact on ``valid``, ``h_eff``,
``cost``, ``n_valid``, ``case_a``, ``relabel``, ``em_base``, trajectories
within 2 mm and 0.02 m/s (fb) or 2 mm and 0.05 m/s (sqp, the bars of the
JAX package's cross-backend gate); the comparator's maxima and verdicts
equal to the JAX function's."""

import dataclasses
import json
import re
import subprocess

import jax
import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu.parallel import scenario as jsc
from graphbasedlocaltrajectoryplanner_torch import bench, entry
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as tsc
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    cuda_parity, profile_sqp)
from tools import pallas_parity

from torch_port_common import carry, jax_refit_repaired, jax_small_oval

EXACT = ("valid", "h_eff", "cost", "n_valid", "case_a", "relabel", "em_base")
TOL_POS, TOL_VX, TOL_VX_SQP = 2e-3, 0.02, 0.05


@pytest.fixture(scope="module")
def oval():
    ja = jax_small_oval()
    return ja, carry(ja)


def test_bench_writes_its_details(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "lattice",
                        lambda track, store: entry.small_lattice("cpu"))
    monkeypatch.setattr(bench, "LATENCY_CALLS", 10)
    d = bench.main(["--cpu", "--batch", "8", "--iters", "1", "--sweep",
                    "4,8", "--out", str(tmp_path)])
    with open(tmp_path / bench.DETAILS) as fh:
        on_disk = json.load(fh)
    assert on_disk == json.loads(json.dumps(d))
    assert set(d) == set(bench.KEYS)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert last["metric"] == bench.METRIC_CPU and last["unit"] == "replans/s"
    assert last["device"] == dict(platform="cpu", name="cpu",
                                  power_limit_w=None, count=0)
    assert last["value"] == round(d["throughput_replans_per_sec"], 1) > 0
    assert last["vs_baseline"] == round(d["throughput_replans_per_sec"]
                                        / bench.BASELINE_REPLANS_PER_SEC, 1)

    for sec, batch, n in (("headline", 8, 1), ("multi_opponent", 8, 5),
                          ("sqp", 8, 5)):
        s = d[sec]
        assert (s["batch"], s["ticks_per_window"]) == (batch, n)
        assert len(s["windows_s"]) == len(s["window_replans_per_sec"]) == 3
        assert s["replans_per_sec"] == batch * n / float(
            np.median(s["windows_s"]))
        # no device reading on the CPU
        assert s["signatures"] is s["graphs"] is s["peak_mem_bytes"] is None
        assert s["setup_s"] > 0
        assert set(s["launches"]) == set(cuda_parity.KERNELS)
    assert set(d["batch_sweep"]) == {"4", "8"}
    assert [s["ticks_per_window"] for s in d["batch_sweep"].values()] == [3, 3]
    assert d["latency"]["calls"] == 10
    assert d["single_replan_latency_ms_p50"] <= \
        d["single_replan_latency_ms_p99"]
    assert d["collision_slots_headline"] == 4
    for k in ("single_replan_device_compute_ms",
              "window_dp_gb_per_s_at_peak_batch", "sqp_stages", "build_s"):
        assert d[k] is None, k
    assert d["stages"]["trace"] is None and d["stages"]["roofline"] is None
    assert set(d["stages"]["cumulative"]["stage_ms"]) == {
        "window", "assembly", "velocity"}
    assert d["lattice"] == dict(L=45, N=24, S=14, H=20, closed=True)

    # the gate ran, vacuously (plain against plain), and wrote its report
    assert d["kernel_parity_ok"] is True and d["parity"]["vacuous"] is True
    assert set(d["parity"]["kernels"]) == set(cuda_parity.KERNELS)
    with open(tmp_path / cuda_parity.REPORT) as fh:
        report = json.load(fh)
    # on the CPU at the bench's batch (under 128), the gate's on the card
    assert report["batch"] == 8 and report["vacuous"]
    for g in report["kernels"].values():
        assert g["equal"] and g["launches"] == 0 and g["n"] > 0
    assert report["kernels"]["admm_vel"]["shapes"][0] == [8, 5, 115]
    for k, bars in (("end_to_end", cuda_parity.E2E_FB),
                    ("end_to_end_sqp", cuda_parity.E2E_SQP)):
        g = report[k]
        assert (g["bar_dxy"], g["bar_dv"]) == bars and g["ok"]
        assert g["max_dxy_m"] == g["max_dv_mps"] == 0.0   # one function
    assert d["cross_backend_sqp_max_dv_mps"] == 0.0


# the root bench.py's random_scenarios calls (bench.py:59, 82, 112-113,
# 138-139, 210): (section, batch, its keyword arguments)
ROOT_BENCH_SCENARIOS = (
    ("headline", 4, dict(seed=0, n_objects=1)),
    ("latency", 1, dict(seed=1, n_objects=1)),
    ("latency", 4, dict(seed=1, n_objects=1)),
    ("multi_opponent", 4, dict(seed=2, n_objects=3, n_pred=1,
                               o_pad=jsc.O_PAD)),
    ("sweep", 4, dict(seed=5, n_objects=1)),
    ("sqp", 4, dict(seed=3, n_objects=1)),
)


def _scenario_pair(ja, lat, section, batch, kw):
    js = jsc.random_scenarios(ja, batch=batch, **kw)
    ts = bench.scenarios(lat, section, batch, 0, torch.device("cpu"))
    return js, ts


def test_bench_scenarios_are_the_root_bench_s(oval):
    ja, lat = oval
    for section, batch, kw in ROOT_BENCH_SCENARIOS:
        js, ts = _scenario_pair(ja, lat, section, batch, kw)
        for f in dataclasses.fields(jsc.Scenario):
            a, b = np.asarray(getattr(js, f.name)), getattr(ts, f.name).numpy()
            assert a.dtype == b.dtype, (section, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{section} {f.name}")
    # another --seed moves every section by the same offset
    np.testing.assert_array_equal(
        bench.scenarios(lat, "sqp", 4, 7, "cpu").start_layer.numpy(),
        np.asarray(jsc.random_scenarios(ja, batch=4, seed=10).start_layer))


@pytest.mark.parametrize("sections,tick_kw,tol_vx", [
    (("headline", "latency", "sweep"), {}, TOL_VX),
    (("multi_opponent",), {}, TOL_VX),
    (("sqp",), bench.SQP, TOL_VX_SQP),
], ids=["fb", "fb_3opp_o16", "sqp"])
def test_bench_ticks_match_jax(oval, sections, tick_kw, tol_vx):
    """The port's plain ticks on the bench's scenarios (B=4) against the
    JAX package's XLA tick (``use_pallas=False``), one compile a shape;
    the JAX tick with the port's full-horizon refit
    (``jax_refit_repaired``: the multi-opponent batch has a scenario on a
    full-horizon layer)."""
    ja, lat = oval
    jt = jsc.make_batched_tick(ja, use_pallas=False, **tick_kw)
    tt = tsc.make_batched_tick(lat, device="cpu", **tick_kw)
    with jax_refit_repaired():
        outs = [(section,) + _scenario_pair(ja, lat, section, batch, kw)
                for section, batch, kw in ROOT_BENCH_SCENARIOS
                if section in sections and batch == 4]
        outs = [(section, jt(js), tt(ts)) for section, js, ts in outs]
    for section, jo, to in outs:
        for k in EXACT + (("qp_status",) if tick_kw else ()):
            np.testing.assert_array_equal(np.asarray(jo[k]), to[k].numpy(),
                                          err_msg=f"{section}: {k}")
        d = np.abs(np.asarray(jo["trajs"], np.float64)
                   - to["trajs"].numpy().astype(np.float64))
        d_pos, d_vx = float(d[..., 0:3].max()), float(d[..., 5].max())
        print(f"bench {section} {tick_kw or 'fb'} B=4: max |d x,y,s| = "
              f"{d_pos:.3g} m, max |d vx| = {d_vx:.3g} m/s")
        assert d_pos <= TOL_POS and d_vx <= tol_vx, (section, d_pos, d_vx)


def _crafted(case):
    """(tick outputs, oracle outputs) of one crafted comparison: batch 8, 5
    slots, 30 points, every valid slot at least one point long."""
    rng = np.random.default_rng(3)
    B, S, P = 8, 5, 30
    ref = dict(trajs=rng.normal(0, 50, (B, S, P, 7)).astype(np.float32),
               valid=rng.random((B, S)) < 0.7,
               nv=rng.integers(1, P + 1, (B, S)).astype(np.int32))
    out = {k: v.copy() for k, v in ref.items()}
    if case == "shift_1mm":
        out["trajs"][..., 1] += np.float32(1e-3)
        out["trajs"][..., 5] -= np.float32(0.01)
    elif case == "shift_3mm":
        out["trajs"][2, :, :, 2] += np.float32(3e-3)
    elif case == "flipped_valid":
        out["valid"][1, 3] = ~out["valid"][1, 3]
    elif case == "changed_n_valid":
        out["nv"][4, 0] += 1
    return out, ref


@pytest.mark.parametrize("bars", [cuda_parity.E2E_FB, cuda_parity.E2E_SQP],
                         ids=["fb", "sqp"])
@pytest.mark.parametrize("case", ["shift_1mm", "shift_3mm", "flipped_valid",
                                  "changed_n_valid"])
def test_end_to_end_comparator_matches_pallas_parity(oval, monkeypatch, case,
                                                     bars):
    """``tools/pallas_parity.check_end_to_end`` itself, its oracle
    subprocess and its tick replaced by the crafted arrays, against
    ``cuda_parity.compare_end_to_end`` on the same arrays."""
    ja, _ = oval
    out, ref = _crafted(case)

    def oracle(args, **kw):                 # writes the oracle's npz
        path = re.search(r"np\.savez\('([^']+)'", args[2]).group(1)
        np.savez(path, trajs=ref["trajs"], valid=ref["valid"], nv=ref["nv"])
        return subprocess.CompletedProcess(args, 0, "", "")
    monkeypatch.setattr(subprocess, "run", oracle)
    monkeypatch.setattr(jsc, "make_batched_tick", lambda lat, **kw: (
        lambda scen: dict(trajs=out["trajs"], valid=out["valid"],
                          n_valid=out["nv"])))
    want = pallas_parity.check_end_to_end(ja, bar_dxy=bars[0],
                                          bar_dv=bars[1])
    got = cuda_parity.compare_end_to_end(
        out["trajs"], out["valid"], out["nv"], ref["trajs"], ref["valid"],
        ref["nv"], *bars)
    assert got == want
    assert got["ok"] == (case == "shift_1mm")
    if case == "shift_1mm":
        assert 1e-3 - 1e-5 < got["max_dxy_m"] < 1e-3 + 1e-5
        assert 0.01 - 1e-4 < got["max_dv_mps"] < 0.01 + 1e-4
    if case == "shift_3mm":
        assert got["max_dxy_m"] > bars[0] and got["max_dv_mps"] == 0.0


def test_bench_and_gate_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "8", "--iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_parity.run(batch=8, lat=entry.small_lattice("cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_parity.main(["--batch", "8"])


def test_trace_attribution_traces_no_device_on_the_cpu():
    lat = entry.small_lattice("cpu")
    scen = tsc.random_scenarios(lat, 2, seed=3, device="cpu")
    tick = tsc.make_batched_tick(lat, device="cpu", **bench.SQP)
    assert profile_sqp.trace_attribution(tick, scen, iters=1) is None
    assert jax.default_backend() == "cpu"
