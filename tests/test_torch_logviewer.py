"""PyTorch port, the offline log viewer (``visualization/log_viewer.py``)
on a 10-tick log of the port's facade (default oval, an opponent from tick
8, every tick logged), against the JAX package's viewer: the message-log
parsing, the per-tick badge, the rendering and the command line with
``--validate --cpu``, whose report equals the JAX viewer's.  Headless
(Agg)."""

import matplotlib
import dataclasses
import os
import subprocess
import sys

import pytest

from graphbasedlocaltrajectoryplanner_tpu.models.lattice import (
    load_lattice as jax_load_lattice)
from graphbasedlocaltrajectoryplanner_tpu.utils.replay import (
    replay_validate as jax_replay_validate)
from graphbasedlocaltrajectoryplanner_tpu.visualization import (
    log_viewer as jlv)
from graphbasedlocaltrajectoryplanner_torch.models.lattice import (
    load_lattice)
from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
    GraphLTPL)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.utils.logging import (
    read_data_log)
from graphbasedlocaltrajectoryplanner_torch.visualization import (
    log_viewer as tlv)

matplotlib.use("Agg")    # headless

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run_log(tmp_path_factory):
    """(data log, archived lattice) of a 10-tick port facade drive."""
    tmp = str(tmp_path_factory.mktemp("viewer"))
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": os.path.join(tmp, "oval.npz"),
          "ltpl_offline_param_path": ROOT + "/params/ltpl_config_offline.ini",
          "ltpl_online_param_path": ROOT + "/params/ltpl_config_online.ini",
          "graph_log_id": "viewer", "log_path": os.path.join(tmp, "logs")}
    ltpl = GraphLTPL(pd, device="cpu")
    ltpl.graph_init()
    h = ltpl._oth
    pos, heading = cl.start_pose(h.np_refline)
    cl.drive(ltpl, 10, pos, heading,
             cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl))
    data = ltpl._path_dict["graph_log_data_path"]
    return data, ltpl._path_dict["graph_log_path"]


def test_msg_log_parsing_equals_jax(tmp_path, run_log):
    msg = tmp_path / "run_msg.csv"
    msg.write_text("time;type;message\n"
                   "100.0;INFO;started\n"
                   "100.45;WARNING;One trajectory generation; took long\n"
                   "103.0;CRITICAL;track blocked\n")
    msgs = tlv.read_msg_log(str(msg))
    assert msgs == jlv.read_msg_log(str(msg))
    assert len(msgs) == 3 and msgs[1][1] == "WARNING"
    assert msgs[1][2] == "One trajectory generation; took long"
    for t in (100.2, 103.4, 200.0):
        assert tlv.messages_near(msgs, t) == jlv.messages_near(msgs, t)
    assert [m[1] for m in tlv.messages_near(msgs, 100.2)] == ["INFO",
                                                             "WARNING"]
    # the facade's own message log
    run_msgs = run_log[0].replace("_data.csv", "_msg.csv")
    assert tlv.read_msg_log(run_msgs) == jlv.read_msg_log(run_msgs)


def test_tick_badge_equals_jax(run_log):
    data, lattice = run_log
    lat, jlat = load_lattice(lattice), jax_load_lattice(lattice)
    rows = read_data_log(data)
    assert len(rows) == 10
    colors = set()
    for row in rows:
        badge = tlv.tick_badge(lat, row)
        assert badge == jlv.tick_badge(jlat, row)
        colors.add(badge[1])
    assert colors <= {"green", "darkorange"}, colors


def test_render_and_cli(run_log, tmp_path):
    import matplotlib.pyplot as plt
    data, lattice = run_log
    rows = read_data_log(data)
    fig, ax = plt.subplots()
    tlv.render_tick(ax, load_lattice(lattice), rows[-1], title="last")
    assert ax.lines and ax.get_title() == "last"
    plt.close(fig)
    out = tmp_path / "frame.png"
    proc = subprocess.run(
        [sys.executable, "-m",
         "graphbasedlocaltrajectoryplanner_torch.visualization.log_viewer",
         "--data", data, "--lattice", lattice, "--out", str(out),
         "--validate", "--cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "replay validation: ticks=10" in proc.stdout
    assert out.stat().st_size > 10_000


def test_validation_report_equals_jax_viewer(run_log, tmp_path, capsys):
    data, lattice = run_log
    rep = tlv.main(["--data", data, "--lattice", lattice, "--out",
                    str(tmp_path / "t.png"), "--validate", "--cpu"])
    t_out = capsys.readouterr().out
    jlv.main(["--data", data, "--lattice", lattice, "--out",
              str(tmp_path / "j.png"), "--validate"])
    j_out = capsys.readouterr().out

    def report_lines(out):
        lines = out.splitlines()
        i = next(k for k, ln in enumerate(lines)
                 if ln.startswith("replay validation:"))
        return [ln for ln in lines[i:] if not ln.startswith("wrote")]
    assert report_lines(t_out) == report_lines(j_out)
    jrep = jax_replay_validate(data, jax_load_lattice(lattice))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.ticks == 10 and rep.ok
