"""PyTorch port, the live plot (``visualization/plot_handler.py``) and the
facade's visual mode.  Headless (Agg).  The five cases of
``tests/test_plot_handler.py`` on the port's lattice; the hover tables and
the edge ``LineCollection`` against the JAX module's on the same track
built by both packages (rtol 1e-6); a visual facade drives and saves a
frame."""

import matplotlib
import numpy as np
import pytest

from graphbasedlocaltrajectoryplanner_tpu.visualization import (
    plot_handler as jph)
from graphbasedlocaltrajectoryplanner_torch.examples import (
    main_min_example as mex)
from graphbasedlocaltrajectoryplanner_torch.models import (
    lattice as tlat)
from graphbasedlocaltrajectoryplanner_torch.models import (
    track as ttrack)
from graphbasedlocaltrajectoryplanner_torch.planner.facade import (
    GraphLTPL)
from graphbasedlocaltrajectoryplanner_torch.planner.objects import (
    VehObject)
from graphbasedlocaltrajectoryplanner_torch.testing_tools import (
    closed_loop as cl)
from graphbasedlocaltrajectoryplanner_torch.utils.config import (
    OfflineConfig)
from graphbasedlocaltrajectoryplanner_torch.visualization import (
    plot_handler as tph)

from torch_port_common import (
    SMALL_OVAL, SMALL_OVAL_CFG, jax_small_oval)

matplotlib.use("Agg")    # headless

ROOT = mex.TOP


@pytest.fixture(scope="module")
def lat():
    """The small oval built by the port's builder."""
    return tlat.build_lattice(ttrack.make_oval_track(**SMALL_OVAL),
                              OfflineConfig(**SMALL_OVAL_CFG),
                              md5_params="graft")


def _tables(lattice, np_of):
    return dict(ev=np_of(lattice.edge_valid), w=np_of(lattice.w),
                samples=np_of(lattice.samples_xy),
                psi=np_of(lattice.node_psi), L=lattice.L)


def _count_linecollections(ax):
    from matplotlib.collections import LineCollection
    return [c for c in ax.collections if isinstance(c, LineCollection)]


def test_cost_colored_edges_single_artist(lat):
    ph = tph.PlotHandler(include_timeline=False)
    ph.plot_lattice(lat, plot_edges=True, cost_dep_color=True,
                    plot_normals=True)
    lcs = _count_linecollections(ph._ax)
    # normals + edges — each ONE artist
    assert len(lcs) == 2
    edge_lc = [c for c in lcs if c.get_label() == "Edges"][0]
    n_edges = int(lat.edge_valid.sum())
    assert len(edge_lc.get_segments()) == n_edges
    colors = edge_lc.get_colors()
    assert colors.shape[0] == n_edges
    assert np.all(colors[:, 0] >= 0.0) and np.all(colors[:, 1] <= 1.0)
    assert np.all(colors[:, 2] == 0.0)
    ph._plt.close("all")


def test_legend_pick_toggles_visibility(lat):
    ph = tph.PlotHandler(include_timeline=False)
    ph.plot_lattice(lat, plot_edges=True)
    leg_line, orig = next(iter(ph._legend_map.items()))
    assert orig.get_visible()

    class _Ev:
        artist = leg_line
    ph._onpick(_Ev())
    assert not orig.get_visible()
    ph._onpick(_Ev())
    assert orig.get_visible()
    ph._plt.close("all")


def test_hover_annotates_nearest_node(lat):
    ph = tph.PlotHandler(include_timeline=False)
    ph.plot_lattice(lat)
    target = ph._node_pos_flat[7]

    class _Ev:
        inaxes = ph._ax
        xdata = float(target[0]) + 0.2
        ydata = float(target[1]) + 0.2
    ph._onhover(_Ev())
    assert ph._hover_ann.get_visible()
    l, n = ph._node_idx_flat[7]
    text = ph._hover_ann.get_text()
    assert f"Layer ID: {l}" in text and f"Node ID: {n}" in text
    n_children = int(lat.edge_valid[l, n].sum())
    assert text.count("k_av2") == n_children
    assert len(ph._hover_edges.get_xdata()) == n_children * (lat.S + 1)

    class _Far:
        inaxes = ph._ax
        xdata = float(target[0]) + 500.0
        ydata = float(target[1]) + 500.0
    ph._onhover(_Far())
    assert not ph._hover_ann.get_visible()
    ph._plt.close("all")


def test_timeline_and_vehicle_footprint(lat, tmp_path):
    ph = tph.PlotHandler(include_timeline=True)
    ph.plot_lattice(lat)
    traj = np.zeros((20, 7), np.float32)
    traj[:, 0] = np.linspace(0.0, 50.0, 20)     # s
    traj[:, 5] = 12.0                           # vx
    obj = VehObject(id_in=1, pos_in=[5.0, 2.0], psi_in=0.3, radius_in=2.0,
                    vel_in=10.0, prediction_in=None)
    for tick in range(3):
        ph.update_tick(trajectories=[traj[:, 1:3]], obj_veh=[obj],
                       pos_est=(0.0, 0.0), action_id="straight",
                       action_set={"straight": [traj],
                                   "follow": [traj] if tick > 0 else []})
    assert ph._time_scatter["straight"][0] == [0, 1, 2]
    assert ph._time_scatter["follow"][0] == [1, 2]
    assert np.allclose(ph._ax_course.lines[0].get_ydata(), 12.0)
    from matplotlib.patches import Circle, Polygon
    polys = [a for a in ph._obj_artists if isinstance(a, Polygon)]
    circs = [a for a in ph._obj_artists if isinstance(a, Circle)]
    assert len(polys) == 1 and len(circs) == 1
    out = tmp_path / "frame.png"
    ph.save(str(out))
    assert out.stat().st_size > 10_000
    ph._plt.close("all")


def test_edge_hover_info_costs_match_lattice(lat):
    tables = _tables(lat, lambda t: t.numpy())
    l, n = 3, int(lat.rl_idx[3])
    text, xs, ys = tph.edge_hover_info(tables, l, n)
    children = np.nonzero(tables["ev"][l, n])[0]
    assert len(text.splitlines()) == len(children)
    for line, m in zip(text.splitlines(), children):
        assert line.startswith(f"[{n}-{m}]:")
        cost = float(line.split(":")[1].split("(")[0])
        assert abs(cost - float(tables["w"][l, n, m])) < 5e-3


def _numbers(text):
    return np.array([float(x) for x in text.replace("[", " ").replace(
        "]", " ").replace("-", " ").replace(":", " ").replace(",", " ")
        .replace("(", " ").replace(")", " ").split()
        if x[0].isdigit()])


def test_hover_tables_and_edges_equal_the_jax_module(lat):
    """The port's lattice against the JAX package's build of the same
    track: hover readouts and the edge collection (segments, cost colors)
    within rtol 1e-6."""
    jlat = jax_small_oval()
    t_tab = _tables(lat, lambda t: t.numpy())
    j_tab = _tables(jlat, np.asarray)
    valid = lat.node_valid.numpy()
    for l, n in zip(*np.nonzero(valid)):
        t_text, t_xs, t_ys = tph.edge_hover_info(t_tab, int(l), int(n))
        j_text, j_xs, j_ys = jph.edge_hover_info(j_tab, int(l), int(n))
        assert t_text.count("\n") == j_text.count("\n")
        np.testing.assert_allclose(_numbers(t_text), _numbers(j_text),
                                   rtol=1e-6, atol=1.5e-3)
        for a, b in ((t_xs, j_xs), (t_ys, j_ys)):
            assert [x is None for x in a] == [x is None for x in b]
            np.testing.assert_allclose(
                np.array([x for x in a if x is not None], np.float64),
                np.array([x for x in b if x is not None], np.float64),
                rtol=1e-6)
    t_ph, j_ph = tph.PlotHandler(), jph.PlotHandler()
    t_ph.plot_lattice(lat, plot_edges=True, cost_dep_color=True)
    j_ph.plot_lattice(jlat, plot_edges=True, cost_dep_color=True)
    t_lc = [c for c in _count_linecollections(t_ph._ax)
            if c.get_label() == "Edges"][0]
    j_lc = [c for c in _count_linecollections(j_ph._ax)
            if c.get_label() == "Edges"][0]
    np.testing.assert_allclose(np.stack(t_lc.get_segments()),
                               np.stack(j_lc.get_segments()), rtol=1e-6)
    np.testing.assert_allclose(t_lc.get_colors(), j_lc.get_colors(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_ph._node_pos_flat, j_ph._node_pos_flat,
                               rtol=1e-6)
    np.testing.assert_array_equal(t_ph._node_idx_flat, j_ph._node_idx_flat)
    t_ph._plt.close("all")


def test_visual_facade_drives_and_saves_a_frame(tmp_path):
    pd = {"globtraj_input_path": "oval",
          "graph_store_path": str(tmp_path / "oval.npz"),
          "ltpl_offline_param_path": ROOT + "/params/ltpl_config_offline.ini",
          "ltpl_online_param_path": ROOT + "/params/ltpl_config_online.ini"}
    ltpl = GraphLTPL(pd, visual_mode=True, log_to_file=False, device="cpu")
    ltpl.graph_init()
    ph = ltpl._plot_handler
    assert ph is not None and ph._node_pos_flat is not None
    clock = cl.StepClock()
    with cl.fake_time(clock):
        recs = mex.drive(ltpl, *mex.start_pose(ttrack.make_oval_track()
                                               .refline), 5, clock=clock)
    assert len(recs) == 5 and ph._tick_no == 5
    assert len(ph._traj_lines) == sum(len(v) for v in recs[-1]["traj_set"]
                                      .values())
    out = tmp_path / "frame.png"
    ph.save(str(out))
    assert out.stat().st_size > 10_000
    ph._plt.close("all")
