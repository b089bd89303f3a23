"""PyTorch port, the profiling tools (``testing_tools/profile_tick.py``,
``profile_assembly.py``, ``profile_sqp.py``) on the CPU at a small size:
each command line writes its JSON report with every key present, and the
assembly profile's kernel list follows the attribution rule of
``parallel/profiling`` (each kernel to the innermost range around its
launch call)."""

import json

import pytest

from graphbasedlocaltrajectoryplanner_torch.parallel import profiling as pf
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    profile_assembly, profile_sqp, profile_tick)

from torch_port_common import Ev as _Ev, Range as _Range


def _report(path):
    with open(path) as fh:
        return json.load(fh)


def test_profile_tick_writes_its_report(tmp_path):
    rep = profile_tick.main(["--batch", "8", "--iters", "1", "--no-trace",
                             "--cpu", "--out", str(tmp_path)])
    on_disk = _report(tmp_path / "TICK_PROFILE_torch.json")
    assert on_disk == json.loads(json.dumps(rep))
    assert set(rep) == {"device", "track", "batch", "iters", "clock",
                        "prefix_ms", "stage_ms", "replans_per_sec", "trace"}
    assert rep["device"]["platform"] == "cpu" and rep["clock"] == "host"
    assert set(rep["prefix_ms"]) == {"decide", "assembly", "tick"}
    assert set(rep["stage_ms"]) == {"window_decide", "assembly", "velocity"}
    assert all(v > 0 for v in rep["prefix_ms"].values())
    assert rep["trace"] is None and rep["replans_per_sec"] > 0


def test_profile_tick_trace(tmp_path):
    lat, scen, dev, _ = profile_tick.setup("oval", 1, cpu=True)
    tr = profile_tick.write_trace(lat, scen, dev, str(tmp_path / "tr"),
                                  iters=1)
    assert set(tr) == {"path", "ticks", "profiled_tick_ms", "device_kernels"}
    trace = _report(tr["path"])
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"gltpl.window_dp", "gltpl.assemble", "gltpl.velocity"} <= names
    assert tr["device_kernels"] is None


def test_profile_assembly_writes_its_report(tmp_path):
    rep = profile_assembly.main(["--batch", "8", "--iters", "1", "--cpu",
                                 "--out", str(tmp_path)])
    assert _report(tmp_path / "ASSEMBLY_PROFILE_torch.json") == \
        json.loads(json.dumps(rep))
    assert set(rep) == {"device", "track", "batch", "iters", "scopes",
                        "assembly", "rest", "rest_ranges", "tick_ms",
                        "unmatched_launches", "assemble_top"}
    assert set(rep["scopes"]) == set(profile_assembly.ASSEMBLY)
    for s in list(rep["scopes"].values()) + [rep["assembly"], rep["rest"]]:
        assert set(s) == {"device_ms", "host_ms", "launches"}
    assert rep["scopes"]["gltpl.assemble"]["host_ms"] > 0
    assert "gltpl.window_dp" in rep["rest_ranges"]
    assert "gltpl.velocity" not in rep["rest_ranges"]
    assert rep["assemble_top"] == []         # no device traced here


def test_profile_sqp_writes_its_report(tmp_path):
    rep = profile_sqp.main(["--batch", "8", "--m", "16", "--iters", "1",
                            "--cpu", "--out", str(tmp_path)])
    assert _report(tmp_path / "SQP_PROFILE_torch.json") == \
        json.loads(json.dumps(rep))
    assert set(rep) == {"device", "track", "batch", "fb_tick_ms",
                        "assembly_cut_ms", "sqp_tick_ms",
                        "sqp_replans_per_sec", "sqp_trace", "qp_micro"}
    assert rep["sqp_trace"] is None          # no device traced on the CPU
    q = rep["qp_micro"]
    assert set(q) == {"batch5", "m", "device", "reps", "clock",
                      "t_iters60_ms",
                      "t_iters5_ms", "per_iteration_ms", "setup_factor_ms",
                      "admm_launches_per_solve", "finite"}
    assert (q["batch5"], q["m"]) == (40, 16) and q["finite"]
    assert q["t_iters60_ms"] > q["t_iters5_ms"] > 0
    assert q["admm_launches_per_solve"] == 0     # the plain ADMM here


def test_top_in_range_on_a_made_up_trace():
    cpu, dev = "DeviceType.CPU", "DeviceType.CUDA"
    asm = _Ev("gltpl.assemble", 1, cpu, _Range(0, 100))
    inner = _Ev("gltpl.const_splice", 2, cpu, _Range(50, 60), asm)
    events = [
        asm, inner,
        _Ev("cudaLaunchKernel", 900, cpu, _Range(1, 2), asm),
        _Ev("cudaLaunchKernel", 901, cpu, _Range(3, 4), asm),
        _Ev("cudaLaunchKernel", 902, cpu, _Range(5, 6), asm),
        _Ev("cudaLaunchKernel", 903, cpu, _Range(51, 52), inner),
        _Ev("thomas", 900, dev, _Range(200, 203)),
        _Ev("thomas", 901, dev, _Range(203, 206)),
        _Ev("cumsum", 902, dev, _Range(206, 207)),
        _Ev("splice", 903, dev, _Range(207, 217)),
        _Ev("gltpl.assemble", 1, dev, _Range(200, 207)),
    ]
    top = pf.top_in_range(events, iters=2, scope="gltpl.assemble")
    assert top == [dict(name="thomas", ms=pytest.approx(3e-3), launches=1.0),
                   dict(name="cumsum", ms=pytest.approx(5e-4),
                        launches=0.5)]
    assert pf.top_in_range(events, 1, "gltpl.assemble", top=1)[0][
        "name"] == "thomas"
