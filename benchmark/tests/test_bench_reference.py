"""The plain reference (``benchmark/reference/``) agrees with the
program's plain path at a tiny size, loads nothing of the program, and
neither the harness nor the reference loads JAX or the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import core, fleet
from benchmark.reference import plan
from benchmark.tests import helpers

FORBIDDEN = set(core.FORBIDDEN)


def _top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=core.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    """The reference, every velocity backend's file beside it included."""
    tops = _top_levels(
        "import glob, os\n"
        "from benchmark.reference import lattice, plan, track, velocity\n"
        "from benchmark import scenarios\n"
        "for p in glob.glob(os.path.join(plan.HERE, 'vp_*.py')):\n"
        "    plan.speed_stage(os.path.basename(p)[3:-3])")
    assert not tops & (FORBIDDEN | {core.PROGRAM})


def test_harness_loads_no_jax():
    tops = _top_levels(
        "from benchmark import run, cells, fleet, trace, work, core\n"
        "import graphbasedlocaltrajectoryplanner_torch.parallel.scenario")
    assert not tops & FORBIDDEN
    # the whole name is compared: the port's name begins with the JAX
    # package's, and loading it is fine
    assert core.PROGRAM in tops


def test_forbidden_modules_are_told_apart_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphbasedlocaltrajectoryplanner_tpux",
                        object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_modules() == ["jax"]


def test_reference_lattice_agrees_with_the_programs():
    _, cfg, _ = helpers.cell()
    csv = core.track_csv(cfg)
    nums = fleet.lattice_numbers(
        fleet.program_lattice_view(core.program_lattice(cfg, csv)),
        helpers.ref_lattice(cfg["name"]))
    assert nums["lattice_mismatches"] == 0
    assert nums["lattice_dpos_m"] < 1e-4          # float32 storage
    assert nums["lattice_cost_rel"] < 1e-6


@pytest.mark.parametrize("seed", [12345, 2 ** 33 + 7])
def test_reference_replan_agrees_with_the_programs_plain_tick(seed):
    _, cfg, mix = helpers.cell()
    mix = dict(mix, batch=24, n_batches=1)
    f = fleet.setup(cfg, mix, seed, helpers.CPU, kernels=False)
    p = {k: v.numpy() for k, v in f.tick(f.batches[0]).items()}
    r = plan.replan(f.ref_lat, f.ref_batches[0],
                    core.reference_params(cfg, f.ref_lat))
    nums = fleet.compare(p, r)
    g = cfg["guarantees"]
    assert nums["discrete_mismatches"] == 0
    for k in ("max_cost_rel", "max_dpos_m", "max_dv_mps"):
        assert nums[k] <= g[k] / 4, (k, nums)
    # follow, both overtakes and the emergency profile are exercised (an
    # opponent is always within the horizon: no straight action)
    assert r["valid"].any(axis=0)[1:].all()


def test_compare_counts_what_differs():
    _, cfg, mix = helpers.cell()
    f = fleet.setup(cfg, helpers.small_fleet_mix(mix), 3, helpers.CPU,
                    make_tick=False)
    r = plan.replan(f.ref_lat, f.ref_batches[0],
                    core.reference_params(cfg, f.ref_lat))
    p = {k: v.copy() for k, v in r.items()}
    b, s = [(b, s) for b in range(8) for s in range(5)
            if r["valid"][b, s]][0]
    p["trajs"][b, s, 0, 1] += 0.01
    p["trajs"][b, s, 1, 5] += 0.5
    p["h_eff"][b, s] += 1
    p["cost"][b, s] *= np.float32(1.5)
    nums = fleet.compare(p, r)
    assert nums["discrete_mismatches"] == 1
    assert nums["max_dpos_m"] == pytest.approx(0.01, rel=1e-3)
    assert nums["max_dv_mps"] == pytest.approx(0.5, rel=1e-3)
    assert nums["max_cost_rel"] > 0.3
    p["trajs"][b, s, 2, 2] = float("nan")
    assert fleet.compare(p, r)["max_dpos_m"] == float("inf")


def test_a_sound_cpu_run_is_correct():
    res, checks = helpers.run()
    assert res["correct"] and not helpers.failed(checks)
    assert set(res["metrics"]) == {"replans_per_s", "setup_s"}
    assert res["attempted"] >= 16 and res["failed"] == 0
