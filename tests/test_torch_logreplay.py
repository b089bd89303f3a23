"""PyTorch port, the log replay and the perception link: a port facade
drive on the CPU logs a lap, and the port's ``utils/replay.replay_validate``
re-runs its search and reports the same as the JAX package's
``replay_validate`` on the same log and lattice; the port's
``ObjectListReceiver`` takes the object list that the port's object-list
dummy publishes over a loopback ZMQ socket (on the in-repo unclosed
Monteblanco track)."""

import dataclasses
import os
import time

import numpy as np
import pytest

from graphbasedlocaltrajectoryplanner_tpu.models import lattice as jlat
from graphbasedlocaltrajectoryplanner_tpu.utils import replay as jreplay
from graphbasedlocaltrajectoryplanner_torch.models import lattice as tlat
from graphbasedlocaltrajectoryplanner_torch.planner.facade import GraphLTPL
from graphbasedlocaltrajectoryplanner_torch.planner.objects import (
    ObjectListInterface)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.testing_tools.objectlist_dummy \
    import ObjectlistDummy, publish_tick
from graphbasedlocaltrajectoryplanner_torch.utils import replay as treplay
from graphbasedlocaltrajectoryplanner_torch.utils.logging import (
    read_data_log)
from graphbasedlocaltrajectoryplanner_torch.utils.zmq_interface import (
    ObjectListReceiver)

from torch_port_common import UNCLOSED_CSV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = 30


@pytest.fixture(scope="module")
def lap(tmp_path_factory):
    """30 ticks of the port's facade on the default oval (opponent from
    tick 8 on), logged; the lattice artifact it built, read by both
    packages."""
    tmp = str(tmp_path_factory.mktemp("logreplay"))
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": os.path.join(tmp, "oval.npz"),
          "ltpl_offline_param_path": os.path.join(
              ROOT, "params", "ltpl_config_offline.ini"),
          "ltpl_online_param_path": os.path.join(
              ROOT, "params", "ltpl_config_online.ini"),
          "graph_log_id": "replay", "log_path": os.path.join(tmp, "logs")}
    ltpl = GraphLTPL(pd, device="cpu")
    ltpl.graph_init()
    h = ltpl._oth
    pos, heading = cl.start_pose(h.np_refline)
    cl.drive(ltpl, TICKS, pos, heading,
             cl.slow_opponent(h.np_raceline, h.np_normvec, h.np_s_rl))
    data = ltpl._path_dict["graph_log_data_path"]
    return dict(data=data, port=tlat.load_lattice(pd["graph_store_path"]),
                jax=jlat.load_lattice(pd["graph_store_path"]))


def _fields(rep):
    d = dataclasses.asdict(rep)
    d["ok"] = rep.ok
    return d


def test_log_replay_matches_jax(lap):
    rows = read_data_log(lap["data"])
    assert len(rows) == TICKS
    jr = jreplay.replay_validate(lap["data"], lap["jax"])
    tr = treplay.replay_validate(lap["data"], lap["port"], device="cpu")
    print(f"log replay {TICKS} ticks: {_fields(tr)}")
    assert _fields(tr) == _fields(jr)
    # every action of every tick was checked, and the object-free ticks
    # were re-planned
    assert tr.ticks == TICKS and tr.actions_checked >= TICKS
    assert tr.edge_violations == 0 and tr.ok


def test_log_replay_plain_equals_kernel_route(lap):
    """On the CPU the kernel route takes the plain versions: both reports
    are equal, row by row too."""
    tr = treplay.replay_validate(lap["data"], lap["port"], device="cpu")
    tp = treplay.replay_validate(lap["data"], lap["port"], device="cpu",
                                 kernels=False)
    assert _fields(tr) == _fields(tp)
    rep = treplay.ReplayReport()
    for row in read_data_log(lap["data"]):
        rep.ticks += 1
        treplay.validate_row(lap["port"], row, rep, kernels=False)
    assert _fields(rep) == _fields(tp)


def test_validate_row_flags_a_broken_chain(lap):
    """A chain with an edge that is not in the lattice, and a straight
    chain that is not the optimum, are both caught — by both packages."""
    rows = [r for r in read_data_log(lap["data"])
            if not r["obj_veh"] and r["nodes_list"].get("straight")]
    assert rows
    row = dict(rows[-1])
    chain = [list(c) for c in row["nodes_list"]["straight"][0]]
    lat = lap["port"]
    k = chain.index([int(row["start_node"][0]), int(row["start_node"][1])])
    la, n = chain[k + 2]
    # the lattice's node farthest from the logged one on that layer
    n_alt = 0 if n > int(lat.nodes_in_layer[la]) // 2 \
        else int(lat.nodes_in_layer[la]) - 1
    chain[k + 2] = [la, n_alt]
    row["nodes_list"] = dict(row["nodes_list"], straight=[chain])
    tr = treplay.validate_row(lat, row)
    jr = jreplay.validate_row(lap["jax"], row)
    print(f"broken chain: {_fields(tr)}")
    assert _fields(tr) == _fields(jr)
    assert tr.node_mismatches >= 1
    assert tr.edge_violations >= 1 or tr.node_mismatch_failures >= 1


@pytest.fixture
def pub_sub():
    zmq = pytest.importorskip("zmq")
    ctx = zmq.Context()
    sock = ctx.socket(zmq.PUB)
    port = sock.bind_to_random_port("tcp://127.0.0.1")
    rx = ObjectListReceiver(endpoint=f"tcp://127.0.0.1:{port}")
    yield sock, rx
    rx.close()
    sock.close(0)
    ctx.term()


def _recv(rx, deadline_s=5.0):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        got = rx.poll(timeout_ms=200)
        if got is not None:
            return got
    return None


def _join(sock, dummy, rx, deadline_s=5.0):
    """PUB/SUB slow joiner: publish until the subscriber sees a message."""
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        sent = publish_tick(sock, dummy)
        got = rx.poll(timeout_ms=200)
        if got is not None:
            return sent, got
    pytest.fail("no message received within the deadline")


def _dummy():
    return ObjectlistDummy(dynamic=True, vel_scale=0.3,
                           globtraj_path=UNCLOSED_CSV)


def test_zmq_objectlist_roundtrip(pub_sub):
    sock, rx = pub_sub
    dummy = _dummy()
    sent, got = _join(sock, dummy, rx)
    assert isinstance(got, list) and len(got) == 1
    assert set(got[0]) == set(sent[0])
    sent2 = publish_tick(sock, dummy)
    got2 = _recv(rx)
    assert got2 is not None
    for k in ("X", "Y", "theta", "v", "length"):
        assert got2[0][k] == pytest.approx(sent2[0][k], abs=1e-12), k
    assert got2[0]["id"] == sent2[0]["id"]
    assert got2[0]["type"] == sent2[0]["type"]
    # the decoded payload feeds the port's object interface unchanged
    vehicles = ObjectListInterface().process_object_list(got2)
    assert len(vehicles) == 1
    assert vehicles[0].pos == pytest.approx([got2[0]["X"], got2[0]["Y"]])
    assert vehicles[0].vel == pytest.approx(got2[0]["v"])


def test_zmq_clear_message_and_foreign_topic(pub_sub):
    """An empty list (the publisher's clear message) arrives as [], not as
    None; a message on another topic does not surface."""
    zmq = pytest.importorskip("zmq")
    sock, rx = pub_sub
    _join(sock, _dummy(), rx)
    assert rx.poll() is None                    # drained
    sock.send_string("other_topic", zmq.SNDMORE)
    sock.send_json([{"X": 1.0}])
    time.sleep(0.3)
    assert rx.poll() is None
    sock.send_string("v2x_to_all", zmq.SNDMORE)
    sock.send_json([])
    assert _recv(rx) == []


def test_objectlist_dummy_runs_along_the_unclosed_track():
    """The dummy's positions advance along the in-repo track under an
    injected clock (the publisher's source of truth)."""
    t = [0.0]
    dummy = ObjectlistDummy(dynamic=True, vel_scale=0.5,
                            globtraj_path=UNCLOSED_CSV, clock=lambda: t[0])
    xs = []
    for _ in range(5):
        t[0] += 0.5
        xs.append(dummy.get_objectlist()[0])
    d = [np.hypot(b["X"] - a["X"], b["Y"] - a["Y"]) for a, b in
         zip(xs[:-1], xs[1:])]
    assert all(di > 0.0 for di in d)
    assert all(np.isfinite([o["X"], o["Y"], o["v"]]).all() for o in xs)
