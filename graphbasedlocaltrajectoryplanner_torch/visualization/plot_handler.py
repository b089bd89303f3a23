"""Live track / trajectory plot (torch port) — counterpart of the JAX
package's ``visualization/plot_handler.py`` and of the reference's
``visualization/src/PlotHandler.py`` (track/lattice/edge rendering with
optional cost coloring, obstacle/vehicle/pos updaters, timeline plots,
legend-pick toggles and hover node inspection).

Every edge polyline comes straight out of the lattice's ``(L, N, N, S, 2)``
sample tensor into a single ``LineCollection`` with a per-edge colormap —
one artist either way.  The port's lattice holds its tensors on the
planner's device (the card by default): :meth:`PlotHandler.plot_lattice`
copies the fields the plot reads to the host once (:func:`host_arrays`);
nothing is copied per tick.
"""

from __future__ import annotations

import numpy as np

# reference palette (PlotHandler.py:14-35)
TUM_COLORS = {
    "TUM_blue": "#3070b3",
    "TUM_blue_dark": "#003359",
    "TUM_blue_light": "#98c6ea",
    "TUM_grey_dark": "#9a9a9a",
    "TUM_orange": "#e37222",
    "TUM_green": "#a2ad00",
}


def host_arrays(lat, names) -> dict:
    """The lattice fields ``names`` as NumPy arrays on the host, each copied
    once from the lattice's device."""
    return {k: getattr(lat, k).detach().cpu().numpy() for k in names}


def edge_hover_info(tables: dict, l: int, n: int):
    """Per-child edge-cost readout for the hover annotation
    (PlotHandler.py:823-849): one line per outgoing edge with the offline
    cost and the squared avg/peak curvature, plus None-separated polyline
    coords highlighting the children.

    Curvature is estimated from the stored sample polyline (the dense
    lattice keeps xy samples, not the spline kappa column — finite
    differences of heading over arc length)."""
    ev, w, samples, L = (tables["ev"], tables["w"], tables["samples"],
                         tables["L"])
    children = np.nonzero(ev[l, n])[0]
    xs, ys, lines = [], [], []
    for m in children:
        seg = samples[l, n, m]                               # (S, 2)
        xs.extend(seg[:, 0]); xs.append(None)
        ys.extend(seg[:, 1]); ys.append(None)
        d = np.diff(seg, axis=0)
        psi = np.arctan2(d[:, 1], d[:, 0])
        dpsi = np.unwrap(np.diff(psi))
        ds = 0.5 * (np.hypot(*d[1:].T) + np.hypot(*d[:-1].T))
        kappa = dpsi / np.maximum(ds, 1e-9)
        k_avg = float(np.mean(np.abs(kappa)) ** 2) if kappa.size else 0.0
        k_peak = float(abs(kappa.max() - kappa.min()) ** 2) \
            if kappa.size else 0.0
        lines.append("[%d-%d]: %.3f (k_av2: %.3f, k_peak2: %.3f)"
                     % (n, m, float(w[l, n, m]), k_avg, k_peak))
    return "\n".join(lines), xs, ys


class PlotHandler:
    def __init__(self, plot_title: str = "Graph-LTPL (PyTorch)",
                 include_timeline: bool = False):
        import matplotlib.pyplot as plt
        self._plt = plt
        if include_timeline:
            self._fig = plt.figure(plot_title, figsize=(13, 8))
            gs = self._fig.add_gridspec(2, 2, width_ratios=[2.2, 1],
                                        height_ratios=[1, 1])
            self._ax = self._fig.add_subplot(gs[:, 0])
            self._ax_time = self._fig.add_subplot(gs[0, 1])
            self._ax_course = self._fig.add_subplot(gs[1, 1])
            self._ax_time.set_title("action availability")
            self._ax_time.set_xlabel("tick")
            self._ax_course.set_title("selected trajectory")
            self._ax_course.set_xlabel("$s$ in m")
        else:
            self._fig, self._ax = plt.subplots(num=plot_title,
                                               figsize=(10, 8))
            self._ax_time = None
            self._ax_course = None
        self._ax.set_title(plot_title)
        self._ax.set_aspect("equal")
        self._traj_lines = []
        self._obj_artists = []
        self._ego_artist = None
        self._text = None
        self._text_field = None
        self._highlight_pos = {}
        self._tick_no = 0
        self._time_scatter = {}   # action -> ([ticks], [y])
        self._course_lines = []

        # hover/pick state (EventHandler :701-859)
        self._node_pos_flat = None
        self._node_idx_flat = None
        self._vg_cost_flat = None
        self._hover_marker = None
        self._hover_ann = None

    # ------------------------------------------------------------------
    def plot_lattice(self, lat, plot_edges: bool = False,
                     cost_dep_color: bool = False,
                     plot_normals: bool = False):
        """Static base plot (reference plot_graph_base :129-288): bounds,
        refline, raceline, normals, nodes, and optionally the full edge set —
        flat-colored or colored by offline cost (green = cheap, red =
        expensive, the reference's (c, 1-c, 0) ramp :233-237)."""
        from matplotlib.collections import LineCollection

        h = host_arrays(lat, (
            "refline", "normvec", "track_width_right", "track_width_left",
            "raceline", "node_pos", "node_valid", "vg_cost", "edge_valid",
            "w", "samples_xy", "node_psi"))
        refline, normvec = h["refline"], h["normvec"]
        wr, wl = h["track_width_right"], h["track_width_left"]
        bound_r = refline + normvec * wr[:, None]
        bound_l = refline - normvec * wl[:, None]
        plt_bounds = None
        for b in (bound_r, bound_l):
            b_cl = np.vstack([b, b[:1]]) if lat.closed else b
            plt_bounds, = self._ax.plot(b_cl[:, 0], b_cl[:, 1], "k-", lw=1,
                                        label="Bounds" if b is bound_r
                                        else None)
        rf_cl = np.vstack([refline, refline[:1]]) if lat.closed else refline
        plt_refline, = self._ax.plot(rf_cl[:, 0], rf_cl[:, 1], "--",
                                     color=TUM_COLORS["TUM_blue_dark"],
                                     lw=0.7, label="Refline")
        plt_normals = None
        if plot_normals:
            # one artist with None separators (reference :163-171)
            seg = np.stack([bound_l, bound_r], axis=1)          # (L, 2, 2)
            nc = LineCollection(seg, colors=TUM_COLORS["TUM_blue_dark"],
                                linewidths=0.7, label="Normals")
            plt_normals = self._ax.add_collection(nc)
        rl = h["raceline"]
        rl_cl = np.vstack([rl, rl[:1]]) if lat.closed else rl
        plt_raceline, = self._ax.plot(rl_cl[:, 0], rl_cl[:, 1], "-",
                                      color=TUM_COLORS["TUM_blue"],
                                      lw=1.2, label="Raceline")

        pos, valid = h["node_pos"], h["node_valid"]
        plt_nodes, = self._ax.plot(pos[valid][:, 0], pos[valid][:, 1], "x",
                                   color=TUM_COLORS["TUM_blue"], ms=3,
                                   label="Nodes", zorder=1)
        # hover lookup tables
        ls, ns = np.nonzero(valid)
        self._node_pos_flat = pos[valid]
        self._node_idx_flat = np.stack([ls, ns], axis=1)
        self._vg_cost_flat = h["vg_cost"][valid]
        self._hover_tables = dict(ev=h["edge_valid"], w=h["w"],
                                  samples=h["samples_xy"], psi=h["node_psi"],
                                  L=lat.L)

        plt_edges = None
        if plot_edges:
            l, n, m = np.nonzero(h["edge_valid"])
            segs = h["samples_xy"][l, n, m]                     # (E, S, 2)
            if cost_dep_color:
                cost = h["w"][l, n, m]
                c0, c1 = float(cost.min()), float(cost.max())
                t = (cost - c0) / max(c1 - c0, 1e-9)
                colors = np.stack([np.minimum(1.0, t),
                                   np.maximum(0.0, 1.0 - t),
                                   np.zeros_like(t),
                                   np.full_like(t, 0.8)], axis=1)
                lc = LineCollection(segs, colors=colors, linewidths=0.7,
                                    zorder=0, label="Edges")
            else:
                lc = LineCollection(segs,
                                    colors=TUM_COLORS["TUM_blue_light"],
                                    linewidths=0.5, zorder=0, label="Edges")
            plt_edges = self._ax.add_collection(lc)

        # pickable legend (reference :255-270 + EventHandler.onpick)
        leg = self._ax.legend(loc="upper left")
        elements = [e for e in (plt_refline, plt_bounds, plt_normals,
                                plt_raceline, plt_nodes, plt_edges)
                    if e is not None]
        self._legend_map = {}
        for leg_line, orig in zip(leg.get_lines(), elements):
            leg_line.set_pickradius(10)
            leg_line.set_picker(True)
            self._legend_map[leg_line] = orig
        self._fig.canvas.mpl_connect("pick_event", self._onpick)

        self._hover_marker, = self._ax.plot([], [], "o",
                                            color=TUM_COLORS["TUM_orange"],
                                            ms=8, zorder=30)
        # child-edge highlight (reference PlotHandler._edge_plot_marker)
        self._hover_edges, = self._ax.plot([], [], "-",
                                           color=TUM_COLORS["TUM_orange"],
                                           lw=1.6, zorder=29)
        self._hover_ann = self._ax.annotate(
            "", xy=(0, 0), xytext=(12, 12), textcoords="offset points",
            bbox=dict(boxstyle="round", fc="w"),
            arrowprops=dict(arrowstyle="->"), zorder=31)
        self._hover_ann.set_visible(False)
        self._fig.canvas.mpl_connect("motion_notify_event", self._onhover)

    # -- event handlers (reference EventHandler :764-859) ----------------
    def _onpick(self, event):
        orig = self._legend_map.get(event.artist)
        if orig is None:
            return
        vis = not orig.get_visible()
        orig.set_visible(vis)
        event.artist.set_alpha(1.0 if vis else 0.2)
        self._fig.canvas.draw_idle()

    def _onhover(self, event):
        if event.inaxes is not self._ax or self._node_pos_flat is None:
            return
        d2 = np.sum((self._node_pos_flat
                     - np.array([event.xdata, event.ydata])) ** 2, axis=1)
        i = int(np.argmin(d2))
        if d2[i] < 1.0:      # within 1 m
            l, n = self._node_idx_flat[i]
            p = self._node_pos_flat[i]
            self._hover_marker.set_data([p[0]], [p[1]])
            self._hover_ann.xy = (p[0], p[1])
            vg = self._vg_cost_flat[i]
            cost_str, ex, ey = edge_hover_info(self._hover_tables,
                                               int(l), int(n))
            psi = self._hover_tables["psi"][l, n]
            self._hover_ann.set_text(
                f"Layer ID: {l}\nNode ID: {n}\nPSI: {psi:.3f}\n"
                f"goal cost {vg:.1f}\nCost:\n{cost_str}")
            self._hover_edges.set_data(ex, ey)
            self._hover_ann.set_visible(True)
        else:
            self._hover_marker.set_data([], [])
            self._hover_edges.set_data([], [])
            self._hover_ann.set_visible(False)
        self._fig.canvas.draw_idle()

    # ------------------------------------------------------------------
    def update_tick(self, trajectories=None, obj_veh=(), obj_zone=(),
                    pos_est=None, action_id: str = "", action_set=None):
        """Per-tick refresh (reference update_obstacles/highlight_* family
        :290-576).  ``action_set`` (action -> [(P, >=6) trajs]) additionally
        feeds the timeline axes when ``include_timeline`` was requested."""
        for ln in self._traj_lines:
            ln.remove()
        self._traj_lines = []
        for art in self._obj_artists:
            art.remove()
        self._obj_artists = []
        if trajectories:
            for xy in trajectories:
                ln, = self._ax.plot(xy[:, 0], xy[:, 1], "-",
                                    color=TUM_COLORS["TUM_green"], lw=2,
                                    zorder=10)
                self._traj_lines.append(ln)
        for obj in obj_veh:
            self._obj_artists.extend(
                self._vehicle_patch(obj.get_pos(), obj.get_psi(),
                                    obj.get_radius()))
        for zone in obj_zone:
            bl, br = zone.get_bound_coords()
            bl = np.atleast_2d(np.asarray(bl))
            br = np.atleast_2d(np.asarray(br))
            if bl.shape[-1] == 2 and bl.shape[0] > 1:
                patch_xy = np.vstack([bl, np.flipud(br)])
                p = self._plt.Polygon(patch_xy,
                                      color=TUM_COLORS["TUM_orange"],
                                      alpha=0.3, zorder=5)
                self._ax.add_patch(p)
                self._obj_artists.append(p)
        if pos_est is not None:
            if self._ego_artist is not None:
                self._ego_artist.remove()
            self._ego_artist = self._ax.plot(
                pos_est[0], pos_est[1], "o",
                color=TUM_COLORS["TUM_orange"], ms=8, zorder=20)[0]
        if self._text is not None:
            self._text.remove()
        self._text = self._ax.text(0.02, 0.98, action_id, color="r",
                                   transform=self._ax.transAxes, va="top")
        if action_set is not None:
            self._update_timeline(action_set, action_id)
        self._tick_no += 1
        self._fig.canvas.draw_idle()
        self._plt.pause(0.001)

    def _vehicle_patch(self, pos, psi, radius):
        """Oriented footprint rectangle + bounding circle (reference
        plot_vehicle :498-535 draws the heading-aligned box)."""
        length, width = 2.8 * radius, 1.6 * radius
        c, s = np.cos(psi + np.pi / 2), np.sin(psi + np.pi / 2)
        rot = np.array([[c, -s], [s, c]])
        box = np.array([[-length / 2, -width / 2], [length / 2, -width / 2],
                        [length / 2, width / 2], [-length / 2, width / 2]])
        box = box @ rot.T + np.asarray(pos)
        rect = self._plt.Polygon(box, color="red", alpha=0.6, zorder=11)
        self._ax.add_patch(rect)
        circ = self._plt.Circle(pos, radius, color="red", alpha=0.2,
                                zorder=11, fill=False)
        self._ax.add_patch(circ)
        return [rect, circ]

    def _update_timeline(self, action_set, sel_action):
        """Timeline axes (reference plot_timeline_stamps/plot_time_rel_line
        :578-683): which actions were feasible per tick, and v/kappa course
        of the pursued trajectory."""
        if self._ax_time is None:
            return
        order = ["straight", "follow", "left", "right", "emergency"]
        for a, trajs in action_set.items():
            if not len(trajs):
                continue
            xs, ys = self._time_scatter.setdefault(a, ([], []))
            xs.append(self._tick_no)
            ys.append(order.index(a) if a in order else len(order))
        self._ax_time.cla()
        self._ax_time.set_title("action availability")
        self._ax_time.set_xlabel("tick")
        self._ax_time.set_yticks(range(len(order)))
        self._ax_time.set_yticklabels(order)
        for a, (xs, ys) in self._time_scatter.items():
            self._ax_time.plot(xs, ys, ".", ms=3,
                               color=TUM_COLORS.get(
                                   "TUM_green" if a == sel_action
                                   else "TUM_grey_dark"))
        for ln in self._course_lines:
            ln.remove()
        self._course_lines = []
        trajs = action_set.get(sel_action) or next(
            (v for v in action_set.values() if len(v)), None)
        if trajs is not None and len(trajs):
            t = np.asarray(trajs[0])
            if t.shape[1] >= 6:
                self._ax_course.cla()
                self._ax_course.set_title(f"selected: {sel_action}")
                self._ax_course.set_xlabel("$s$ in m")
                l1, = self._ax_course.plot(t[:, 0], t[:, 5], "-",
                                           color=TUM_COLORS["TUM_orange"],
                                           label="$v_x$")
                l2, = self._ax_course.plot(t[:, 0], t[:, 4] * 100.0, "-",
                                           color=TUM_COLORS["TUM_blue"],
                                           label=r"$\kappa \cdot 100$")
                self._ax_course.legend(loc="upper right", fontsize=8)
                self._course_lines = []   # cla() removed previous artists

    # ------------------------------------------------------------------
    def update_text_field(self, text: str, color_str: str = "k"):
        """Status text box (reference update_text_field :377-397)."""
        if self._text_field is not None:
            self._text_field.remove()
        self._text_field = self._fig.text(
            0.02, 0.02, text, color=TUM_COLORS.get(color_str, color_str))
        self._fig.canvas.draw_idle()

    def highlight_pos(self, pos, id_in: str = "", color_str: str = "TUM_blue",
                      marker: str = "o"):
        """Named, re-usable position marker (reference highlight_pos
        :457-496)."""
        if id_in in self._highlight_pos:
            self._highlight_pos[id_in].remove()
        self._highlight_pos[id_in], = self._ax.plot(
            [pos[0]], [pos[1]], marker,
            color=TUM_COLORS.get(color_str, color_str), ms=8, zorder=21,
            label=id_in or None)

    def show(self, non_blocking: bool = False):
        if non_blocking:
            self._plt.pause(0.001)
        else:
            self._plt.show()

    def save(self, path: str):
        self._fig.savefig(path, dpi=120)
