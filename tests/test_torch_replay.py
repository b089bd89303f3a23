"""PyTorch port against the reference planner itself: the recorded
reference run ``parity/fixtures/ref_unclosed_monteblanco_220.npz`` replayed
through the port's ``GraphLTPL(device="cpu")`` (``parity/replay_torch.py``,
the repository's own INI files, the lattice built into a temporary
directory), at the north-star bar of ``tests/test_reference_parity.py``:
2 cm and 0.1 m/s, over the executed first 100 m and the full horizon."""

import os

import pytest

from parity.replay_torch import replay

FIXDIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "parity", "fixtures")
TOL_POS = 0.02   # m
TOL_VEL = 0.1    # m/s
TICKS = 60


def test_unclosed_monteblanco_fixture_replay():
    report, rows = replay(os.path.join(FIXDIR,
                                       "ref_unclosed_monteblanco_220.npz"),
                          ticks=TICKS, device="cpu")
    print(f"replay {report['fixture']}, {TICKS} ticks: max |d pos| "
          f"{report['max_d_pos_m']:.3g} m, max |d vel| "
          f"{report['max_d_vel_mps']:.3g} m/s (first 100 m: "
          f"{report['max_d_pos_exec_m']:.3g} m, "
          f"{report['max_d_vel_exec_mps']:.3g} m/s)")
    assert report["pairs_compared"] >= TICKS, report
    assert report["actions_missing_in_port"] == [], report
    assert report["actions_extra_in_port"] == [], report
    for k in ("max_d_pos_m", "max_d_pos_exec_m"):
        assert report[k] < TOL_POS, report
    for k in ("max_d_vel_mps", "max_d_vel_exec_mps"):
        assert report[k] < TOL_VEL, report


def test_fixture_without_its_track_in_the_repository_raises():
    # the closed tracks' CSVs are not in the repository
    with pytest.raises(FileNotFoundError, match="not in the repository"):
        replay(os.path.join(FIXDIR, "ref_monteblanco_200.npz"), ticks=1,
               device="cpu")
