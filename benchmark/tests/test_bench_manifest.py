"""BENCHMARK.json against the benchmark's contract, and every file it
names: configurations, traffic mixes, per-layer metric readers."""

import json
import os
import re

import pytest

from benchmark import core

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(core.MANIFEST) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(core.ROOT, p))
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")
        if os.path.exists(os.path.join(core.ROOT, w)):
            assert any(w == p or w.startswith(p + "/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


def test_entries_have_their_keys_only():
    for section, keys in ENTRY_KEYS.items():
        for e in MAN[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e["name"])


def test_names_and_units():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names)), section
        for n in names:
            assert NAME.match(n), n
    assert not ({m["name"] for m in MAN["end_to_end"]}
                & {m["name"] for m in MAN["per_layer"]})
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["per_layer"]:
        assert _line(m["layer"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_and_their_files():
    assert 1 <= len(MAN["configs"]) <= 24
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        cfg = core.config(MAN, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for k in ("offline_ini", "online_ini"):
            assert os.path.isfile(os.path.join(core.ROOT, cfg[k]))
            assert cfg[k].startswith("benchmark/")
        # the backend has its reference's speed stage, and the tick takes it
        from benchmark.reference import plan
        opts = core.tick_options(cfg)
        assert callable(plan.speed_stage(opts["vp_backend"]))
        assert set(cfg["guarantees"]) == {"discrete_mismatches",
                                          "max_cost_rel", "max_dpos_m",
                                          "max_dv_mps"}


def test_workloads_and_traffic():
    wl = MAN["workloads"]
    assert 1 <= len(wl) <= 24
    pairs = [(w["config"], w["traffic"]) for w in wl]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in wl)
    assert four <= max(1, len(wl) // 4)
    for w in wl:
        assert w["chips"] in (1, 4)
        mix = core.traffic(w["traffic"])
        assert mix["kind"] == "fleet" and w["chips"] == 1


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in core.end_to_end(MAN, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert core.per_layer(MAN, w["name"]), w["name"]


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for c in m.get("workloads", []):
            assert c in cells
            assert m["moves"] in {x["name"] for x in core.end_to_end(MAN, c)}


def test_layer_names_are_consistent():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    for names in by_layer.values():
        assert len(names) == 1, names


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_metric_reader_loads_and_finds_nothing_in_nothing(name):
    read = core.reader(name)
    assert read({}) is None
    assert read({"kind": "other"}) is None


def test_roofline_readers_never_fill_in_zero():
    from benchmark import work
    for kernel, trace_name in (
            ("vel_scan_cgg", "void vel_scan_kernel<true, true>(x)"),
            ("assemble", "assemble_kernel(Args, int)")):
        read = core.reader(f"{kernel}_roofline")
        ctx = dict(kind="fleet", kernel_ms={}, work={})
        assert read(ctx) is None
        ctx["kernel_ms"] = {trace_name: 0.25, "other_kernel": 1.0}
        assert read(ctx) is None                  # no counted call
        ctx["work"] = {kernel: (int(3.35e12 * 0.25e-3 * 0.5), 0, 4)}
        assert read(ctx) == pytest.approx(50.0)
        assert read(dict(ctx, kernel_ms={"other_kernel": 1.0})) is None
    assert work.bound_ms(0, int(67e12 * 1e-3)) == pytest.approx(1.0)


def test_manifest_is_plain_json():
    with open(core.MANIFEST) as fh:
        assert json.load(fh) == MAN


def _run_cli(cwd):
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *MAN["command"][1:], "--workload",
         MAN["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_a_run_without_the_card_or_the_program_prints_no_result(tmp_path):
    import shutil
    import torch
    out = _run_cli(core.ROOT)
    if not torch.cuda.is_available():
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert not out.stdout.strip()
    # only BENCHMARK.json and the files under paths: no program to run
    shutil.copy(core.MANIFEST, tmp_path)
    for p in MAN["paths"]:
        shutil.copytree(os.path.join(core.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = _run_cli(str(tmp_path))
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
