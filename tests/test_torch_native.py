"""PyTorch port, the native host library (``native.py`` over the port's
copy of ``native/ltpl_native.cpp``): each entry point against the port's
own NumPy/PyTorch function (the four cases of ``tests/test_native.py``),
bit for bit against the JAX package's native library on the same inputs,
and a failed build raises with the compiler's output."""

import numpy as np
import pytest
import torch

from graphbasedlocaltrajectoryplanner_tpu import native as jnative
from graphbasedlocaltrajectoryplanner_torch import native
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    import_globtraj_csv, variable_step_size)
from graphbasedlocaltrajectoryplanner_torch.ops import search as srch
from graphbasedlocaltrajectoryplanner_torch.ops import velocity as velops

from torch_port_common import UNCLOSED_CSV


def _dp_case(seed, H=10, N=8):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 10, (H, N, N)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.3] = float(srch.INF)
    vg = rng.uniform(0, 5, (H + 1, N)).astype(np.float32)
    return w, vg, int(rng.integers(0, N))


def _fb_case(seed, P=50):
    rng = np.random.default_rng(seed)
    return dict(kappa=rng.normal(0, 0.01, P), el=np.full(P, 2.5),
                gg=np.tile([[10.0, 10.0]], (P, 1)),
                machines=np.array([[0.0, 5.0], [60.0, 3.0]]))


def test_native_csv_loader(tmp_path):
    data = np.random.default_rng(0).normal(0, 10, (40, 12))
    p = tmp_path / "track.csv"
    with open(p, "w") as fh:
        fh.write("# comment line\n# another\n")
        for row in data:
            fh.write(";".join(f"{v:.7f}" for v in row) + "\n")
    out = native.load_csv(str(p), 12)
    np.testing.assert_allclose(out, data, atol=1e-6)
    np.testing.assert_array_equal(out, np.loadtxt(p, delimiter=";"))
    # the repository's track, against the port's loader
    raw = native.load_csv(UNCLOSED_CSV, 12)
    gt = import_globtraj_csv(UNCLOSED_CSV)
    np.testing.assert_array_equal(raw[:-1, 0:2], gt.refline)
    np.testing.assert_array_equal(raw[:-1, 4:6], gt.normvec)
    np.testing.assert_array_equal(np.diff(raw[:, 7]), gt.el_lengths)
    np.testing.assert_array_equal(raw[:-1, 9], gt.kappa_rl)
    np.testing.assert_array_equal(raw[:-1, 10], gt.vel_rl)
    np.testing.assert_array_equal(raw, jnative.load_csv(UNCLOSED_CSV, 12))
    with pytest.raises(OSError):
        native.load_csv(str(tmp_path / "missing.csv"))


def test_native_variable_step_size():
    rng = np.random.default_rng(1)
    kappa = rng.normal(0, 0.01, 300)
    dist = np.full(300, 3.0)
    for force_last in (False, True):
        nat = native.variable_step_size(kappa, dist, 10.0, 30.0, 0.008,
                                        force_last=force_last)
        assert nat == variable_step_size(kappa, dist, 10.0, 30.0, 0.008,
                                         force_last=force_last)
        assert nat == jnative.variable_step_size(kappa, dist, 10.0, 30.0,
                                                 0.008, force_last=force_last)


def test_native_dp_oracle_matches_port_search():
    for seed in range(4):
        w, vg, start = _dp_case(seed)
        H = w.shape[0]
        out = srch.search_window(torch.from_numpy(w), start,
                                 torch.from_numpy(vg), H, True)
        h_nat, nodes_nat, cost_nat = native.minplus_dp(w, vg, start, H)
        assert h_nat == int(out["h_eff"])
        if h_nat >= 1:
            assert abs(cost_nat - float(out["cost"])) < 1e-2
            # chains may differ on exact ties; verify cost equivalence
            c = sum(float(w[h, nodes_nat[h], nodes_nat[h + 1]])
                    for h in range(h_nat))
            c += float(vg[h_nat, nodes_nat[h_nat]])
            assert abs(c - cost_nat) < 1e-2
        h_j, nodes_j, cost_j = jnative.minplus_dp(w, vg, start, H)
        assert h_j == h_nat and cost_j == cost_nat
        np.testing.assert_array_equal(nodes_j, nodes_nat)
    with pytest.raises(ValueError):
        native.minplus_dp(w, vg, start, H + 1)


def test_native_fb_profile_matches_port_velocity():
    c = _fb_case(5)
    v_nat = native.fb_profile(c["kappa"], c["el"], c["gg"], c["machines"],
                              60.0, 15.0, v_end=10.0)
    v_port = velops.calc_vel_profile_fb(
        *(torch.from_numpy(c[k]).float()
          for k in ("kappa", "el", "gg", "machines")),
        60.0, 15.0, v_end=10.0).numpy()
    np.testing.assert_allclose(v_nat, v_port, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dyn_exp", [1.0, 1.5, 2.0])
def test_native_fb_profile_equals_jax_native(dyn_exp):
    for seed in range(6):
        c = _fb_case(seed, P=120)
        c["gg"] = np.random.default_rng(seed).uniform(5.0, 12.0, (120, 2))
        args = (c["kappa"], c["el"], c["gg"],
                np.array([[0.0, 5.0], [30.0, 4.0], [60.0, 3.0]]), 60.0,
                5.0 + seed)
        np.testing.assert_array_equal(
            native.fb_profile(*args, v_end=10.0, dyn_exp=dyn_exp),
            jnative.fb_profile(*args, v_end=10.0, dyn_exp=dyn_exp))


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build(cxx=str(tmp_path / "no-such-compiler"),
                     build_dir=tmp_path)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(cxx="false", build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))
    assert native.available()
