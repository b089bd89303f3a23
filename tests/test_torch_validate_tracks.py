"""PyTorch port, the all-tracks validation
(``testing_tools/validate_tracks.py``) against the JAX package's
``tools/validate_tracks.py`` on the CPU.

Both ``run_track`` loops drive their facade on the unclosed Monteblanco
CSV under one fixed clock step (``closed_loop.StepClock``, advanced once a
tick just before the opponent's object list is read), so that the planners
and the opponents see the same clock readings.  Gates: ``start_ok``, the
lattice's shape, ``closed``, ``mean_actions`` and ``empty_sets`` equal;
``v_end`` within 0.02 m/s (the measured deviation is printed).  The
port's loop also hands back its per-tick records (``closed_loop``'s
format), one a tick, holding each tick's action set.
"""

import importlib.util
import os

import pytest

from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    validate_tracks as tvt)

from torch_port_common import UNCLOSED_CSV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 8


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_tracks", os.path.join(ROOT, "tools",
                                            "validate_tracks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_track_matches_jax(jax_tool, tmp_path, monkeypatch):
    clock = cl.StepClock()

    class StepDummy(jax_tool.ObjectlistDummy):
        def get_objectlist(self):
            clock()
            return super().get_objectlist()

    monkeypatch.setattr(jax_tool, "ObjectlistDummy", StepDummy)
    for d in ("jax", "torch"):
        (tmp_path / d).mkdir()
    with cl.fake_time(clock):
        ref = jax_tool.run_track(UNCLOSED_CSV, TICKS, str(tmp_path / "jax"))
    recs = []
    got = tvt.run_track(UNCLOSED_CSV, TICKS, str(tmp_path / "torch"),
                        device="cpu", clock=cl.StepClock(), records=recs)
    assert set(got) == set(ref)
    assert len(recs) == TICKS
    assert sum(len(r["traj_set"]) for r in recs) / TICKS \
        == got["mean_actions"]
    assert all(set(r["nodes"]) <= set(r["traj_set"]) for r in recs)
    for k in ("name", "start_ok", "rl_points", "layers", "nodes", "closed",
              "ticks", "mean_actions", "empty_sets"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert abs(got["track_len_m"] - ref["track_len_m"]) <= 2e-3
    d_v = abs(got["v_end"] - ref["v_end"])
    print(f"run_track {got['name']} {TICKS} ticks: mean actions "
          f"{got['mean_actions']}, empty sets {got['empty_sets']}, v_end "
          f"{got['v_end']:.4f} m/s, |d v_end| = {d_v:.3g} m/s against JAX")
    assert d_v <= 0.02
    assert got["start_ok"] and got["empty_sets"] == 0


def test_cli_runs_the_oval_and_writes_its_report(tmp_path, capsys):
    report = tmp_path / "tracks.md"
    rc = tvt.main(["--cpu", "--ticks", "3", "--tracks", "oval", "--report",
                   str(report), "--store-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "all 1 tracks ok" in out
    text = report.read_text()
    assert "| oval | 400 | 61 | 24 |" in text
    assert os.path.isfile(tmp_path / "validate_torch_oval.npz")
    assert not tvt.DEFAULT_REPORT.endswith(os.path.join("docs", "tracks.md"))
