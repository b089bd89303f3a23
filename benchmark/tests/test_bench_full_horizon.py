"""The full-traffic fb cell ``fleet_fb_b1024`` on the CPU: its manifest
entries and its configuration ``ltpl_fb_oval_lap``; the fb check of the
program's plain tick on a small batch that starts only on the lattice's
full-horizon layers, correct with the program's refit and not correct
with the end-tangent term dropped (the refit before its repair); the
full-horizon rows reader."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from benchmark import core, fleet, scenarios
from benchmark.tests import helpers

NAME = "fleet_fb_b1024"
SHORT = "fleet_fb_b1024_short_h"
SEED = 2 ** 33 + 25
READER = "fleet.full_horizon_rows"


def test_the_cells_manifest_entries():
    c, cfg, mix = helpers.cell(NAME)
    assert (c["config"], c["traffic"], c["chips"]) == (
        "ltpl_fb_oval_lap", "fleet_b1024", 1)
    # ltpl_fb_oval planned from every layer: the same numbers and files,
    # its own name, source and statement of the start layers
    fb = core.config(helpers.MAN, "ltpl_fb_oval")
    own = {"name", "source", "deployment", "start_layers",
           "start_layers_source"}
    assert set(cfg) - own == set(fb) - own
    for k in set(fb) - own:
        assert cfg[k] == fb[k], k
    assert cfg["source"] != fb["source"]
    assert cfg["start_layers"] == "all"
    # the short_h cell's traffic with every start layer
    assert mix == dict(core.traffic("fleet_b1024_short_h"),
                       short_horizon_starts=False)
    man = helpers.MAN
    got = {m["name"] for m in core.per_layer(man, NAME)}
    assert got == {"fleet.window_ms", "fleet.assembly_ms",
                   "fleet.velocity_ms", "vel_scan_cgg_roofline",
                   "assemble_roofline", "fleet.device_idle_pct",
                   "fleet.graph_window_ms", "fleet.graph_assembly_ms",
                   "fleet.graph_velocity_ms", "fleet.graph_other_ms",
                   "fleet.graph_kernel_nodes", "fleet.replay_host_ms",
                   "fleet.call_idle_pct"}
    assert got == {m["name"] for m in core.per_layer(man, SHORT)}
    assert {m["name"] for m in core.end_to_end(man, NAME)} == {
        "replans_per_s", "setup_s"}
    assert [w["name"] for w in man["workloads"]][-1] == NAME
    # the reader is kept for a benchmark PR, not yet an entry
    assert READER not in {m["name"] for m in man["per_layer"]}


# ---------------------------------------------------------------------------
# the check on the full-horizon layers
# ---------------------------------------------------------------------------

def _dropped_term_fit(points, el, psi_s, psi_e, n_seg, H):
    """The padded refit with the full row's end-tangent term dropped, as
    it was before its repair (and as the JAX package still has it)."""
    from graphbasedlocaltrajectoryplanner_torch.ops import splines as spl
    from graphbasedlocaltrajectoryplanner_torch.ops.heading import \
        heading_to_dir
    seg_len = torch.clamp(el, min=1e-9)
    m0, mn = heading_to_dir(psi_s), heading_to_dir(psi_e)
    lam = seg_len[:, :-1] / seg_len[:, 1:]
    dp_over_l = (points[:, 1:] - points[:, :-1]) / seg_len[..., None]
    rhs = 3.0 * (dp_over_l[:, :-1] + lam[..., None] * dp_over_l[:, 1:])
    rhs = torch.cat([(rhs[:, 0] + (-m0))[:, None], rhs[:, 1:]], dim=1)
    lower = torch.ones_like(lam)
    lower[:, 0] = 0.0
    diag, upper = 2.0 * (1.0 + lam), lam
    pin = torch.arange(lam.shape[1])[None, :] >= (n_seg.long()[:, None] - 1)
    lower = torch.where(pin, 0.0, lower)
    diag = torch.where(pin, 1.0, diag)
    upper = torch.where(pin, 0.0, upper)
    rhs = torch.where(pin[..., None], mn[:, None, :], rhs)
    u = spl._thomas(lower.T, diag.T, upper.T,
                    rhs.transpose(0, 1)).transpose(0, 1)
    m = torch.cat([m0[:, None], u, mn[:, None]], dim=1)
    past = torch.arange(H + 1)[None, :] >= n_seg.long()[:, None]
    m = torch.where(past[..., None], mn[:, None, :], m)
    m = torch.cat([m0[:, None], m[:, 1:]], dim=1)
    return spl._coeffs_from_tangents(points, m, seg_len)


@pytest.fixture(scope="module")
def full_start():
    """The cell's fleet set up small, its one batch of 8 scenarios made by
    the benchmark's generator on the full-horizon layers only (the
    generator's ``short_horizon_starts`` draws from the layers whose
    ``h_goal`` is under H_max; here it is handed a lattice on which only
    those at H_max are)."""
    _, cfg, mix = helpers.cell(NAME)
    mix = dict(mix, batch=8, n_batches=1, check_per_batch=8)
    f = fleet.setup(cfg, mix, SEED, helpers.CPU, kernels=False)
    lat = f.ref_lat
    only_full = dataclasses.replace(
        lat, h_goal=np.where(lat.h_goal == lat.H_max, 0, lat.H_max))
    b = scenarios.batch(only_full, dict(mix, short_horizon_starts=True),
                        fleet.batch_seed(SEED, 0))
    assert (lat.h_goal[b["start_layer"]] == lat.H_max).all()
    f.ref_batches = [b]
    f.batches = [fleet.to_program(b, helpers.CPU)]
    return f


def _check(f):
    out = f.tick(f.batches[0])
    assert int((out["h_eff"] == f.ref_lat.H_max).sum()) > 0
    p_rows = fleet.program_rows([out], fleet.checked_rows(f))
    return {c["name"]: c for c in fleet.check(f, p_rows)}


def test_full_horizon_starts_are_correct(full_start):
    got = _check(full_start)
    print({k: c["value"] for k, c in got.items()})
    assert all(c["ok"] for c in got.values()), got


def test_full_horizon_starts_with_the_term_dropped_are_not(full_start,
                                                           monkeypatch):
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_assemble
    monkeypatch.setattr(cuda_assemble, "_fit_clamped_chain_padded",
                        _dropped_term_fit)
    got = _check(full_start)
    print({k: c["value"] for k, c in got.items()})
    assert not got["max_dpos_m"]["ok"]
    assert got["max_dpos_m"]["value"] > 0.1


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def test_full_horizon_rows_reader_finds_nothing_in_nothing(monkeypatch):
    read = core.reader(READER)
    for ctx in (None, {}, {"kind": "other"}):
        assert read(ctx) is None
    # a fleet context outside a run of benchmark.run
    monkeypatch.setattr(sys, "argv", ["pytest"])
    assert read({"kind": "fleet"}) is None
    # a program without the counter: nothing is set up, nothing read
    from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", NAME,
                                      "--seed", str(SEED)])
    monkeypatch.delattr(cuda_graph, "count")

    def measure(*a):
        raise AssertionError("measured without a counter")
    monkeypatch.setitem(read.__globals__, "measure", measure)
    assert read({"kind": "fleet"}) is None


def test_full_horizon_rows_reader_reads_once_a_run(monkeypatch):
    read = core.reader(READER)
    calls = []

    def measure(workload, seed):
        calls.append((workload, seed))
        return 268
    monkeypatch.setitem(read.__globals__, "measure", measure)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", NAME,
                                      "--seed", str(SEED)])
    ctx = {"kind": "fleet"}
    assert [read(ctx), read(ctx)] == [268, 268]
    assert calls == [(NAME, SEED)]
