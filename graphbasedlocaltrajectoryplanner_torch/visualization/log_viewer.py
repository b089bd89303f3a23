"""Offline log viewer / replay tool (torch port) — counterpart of the JAX
package's ``visualization/log_viewer.py`` and of the reference's
``visualization/src/visualize_graph_log.py``: load a ``*_data.csv`` run log
plus the archived lattice, render any logged timestamp (track, planned
action-set trajectories, objects, zones, ego position), ingest the run's
``*_msg.csv`` message log for timeline highlighting, re-validate each
displayed tick while scrubbing (badge in the title), and optionally
validate the whole log (``utils/replay.replay_validate``).

The validation re-plans at batch 1 on the planner's device: on the card
through the window-DP, slab-hit and walk kernels (``csrc/window_dp.cu``,
``csrc/hit_slab.cu``, ``csrc/backtrace.cu``), with ``--cpu`` through their
plain versions on the CPU.  Rendering reads a host copy of the lattice.

Usage:
    python -m graphbasedlocaltrajectoryplanner_torch.visualization.log_viewer \
        --data logs/graph_ltpl_torch/<date>/<time>_data.csv \
        --lattice logs/graph_ltpl_torch/Graph_Objects/<id>.npz \
        [--tick -1] [--out frame.png] [--validate] [--interactive] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models.lattice import load_lattice
from graphbasedlocaltrajectoryplanner_torch.utils.logging import read_data_log
from graphbasedlocaltrajectoryplanner_torch.utils.replay import (
    replay_validate, validate_row)
from graphbasedlocaltrajectoryplanner_torch.visualization.plot_handler import (
    host_arrays)

MSG_COLORS = {"DEBUG": "tab:gray", "INFO": "tab:green",
              "WARNING": "tab:orange", "ERROR": "tab:red",
              "CRITICAL": "darkred"}
# reference EventHandler.__time_threshold_msgs analogue: messages within
# this window of the displayed tick are surfaced
MSG_TIME_THRESHOLD = 0.5


def read_msg_log(path: str):
    """Parse a ``*_msg.csv`` (``time;type;message``, the facade's message
    channel) into a list of (time, level, message) tuples
    (visualize_graph_log.py:455-460)."""
    out = []
    with open(path) as fh:
        for i, ln in enumerate(fh.read().splitlines()):
            if i == 0 and ln.startswith("time;"):
                continue
            parts = ln.split(";", 2)
            if len(parts) != 3:
                continue
            try:
                out.append((float(parts[0]), parts[1], parts[2]))
            except ValueError:
                continue
    return out


def messages_near(msgs, t, threshold=MSG_TIME_THRESHOLD):
    """Messages within ``threshold`` seconds of timestamp ``t``."""
    return [m for m in msgs if abs(m[0] - t) <= threshold]


def tick_badge(lat, row):
    """Per-displayed-tick re-validation badge (the reference viewer's
    per-scrub RECALC_VALIDATION, visualize_graph_log.py:209-234), re-planned
    on ``lat``'s device."""
    rep = validate_row(lat, row)
    if rep.edge_violations or rep.node_mismatch_failures:
        return ("INVALID (%d edge, %d cost-gate)"
                % (rep.edge_violations, rep.node_mismatch_failures), "red")
    if rep.node_mismatches:
        return "valid (w_last hold)", "darkorange"
    return "valid", "green"


def render_tick(ax, lat, row, title=None):
    """Draw one logged tick on ``ax``.  Pass the lattice on the CPU: its
    fields are then read without a copy (a lattice on the card is copied
    on every call)."""
    h = host_arrays(lat, ("refline", "normvec", "track_width_right",
                          "track_width_left", "raceline", "node_pos"))
    refline, normvec = h["refline"], h["normvec"]
    wr, wl = h["track_width_right"], h["track_width_left"]
    for sign, w in ((1, wr), (-1, wl)):
        b = refline + sign * normvec * w[:, None]
        if lat.closed:
            b = np.vstack([b, b[:1]])
        ax.plot(b[:, 0], b[:, 1], "k-", lw=1)
    rl = h["raceline"]
    rl_cl = np.vstack([rl, rl[:1]]) if lat.closed else rl
    ax.plot(rl_cl[:, 0], rl_cl[:, 1], "b--", lw=0.7)

    colors = dict(straight="tab:green", follow="tab:orange",
                  left="tab:purple", right="tab:cyan",
                  emergency="tab:red")
    pos_list = row.get("pos_list") or {}
    for action, trajs in pos_list.items():
        for t in trajs:
            t = np.asarray(t)
            if t.size:
                ax.plot(t[:, 0], t[:, 1], "-", lw=2,
                        color=colors.get(action, "gray"), label=action)
    import matplotlib.patches as mpatches
    for obj in row.get("obj_veh") or []:
        c = np.asarray(obj["pos"], float)
        ax.add_patch(mpatches.Circle(c, obj.get("radius", 2.0),
                                     color="red", alpha=0.6, zorder=25))
    clip = row.get("clip_pos")
    if clip:
        ax.plot(clip[0], clip[1], "o", color="darkorange", ms=8, zorder=30)
    sn = row.get("start_node")
    if sn and sn[0] is not None:
        p = h["node_pos"][int(sn[0]), int(sn[1])]
        ax.plot(p[0], p[1], "c*", ms=12, zorder=30)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    handles, labels = ax.get_legend_handles_labels()
    uniq = dict(zip(labels, handles))
    ax.legend(uniq.values(), uniq.keys(), loc="upper right")


def plot_follow_debug(follow_path: str):
    """Follow-mode controller debug figure (reference
    visualize_graph_log.py:397-448): distances + velocities over time,
    with gaps (NaN) inserted where consecutive rows are >1 s apart."""
    import matplotlib.pyplot as plt

    data = np.genfromtxt(follow_path, delimiter=";", names=True)
    if data.size == 0:
        return None
    data = np.atleast_1d(data)
    t = np.asarray(data["time"], float)
    gaps = np.concatenate([[False], np.abs(np.diff(t)) > 1.0])
    t0 = t[0]

    def ch(name):
        v = np.asarray(data[name], float).copy()
        v[gaps] = np.nan
        return v

    tt = t - t0
    tt[gaps] = np.nan
    fig = plt.figure("Follow Mode Debug", figsize=(9, 7))
    fig.clf()
    ax1 = plt.subplot(2, 1, 1)
    ax1.set_title("Distances")
    ax1.set_xlabel("$t$ in s")
    ax1.set_ylabel("dist in m")
    ax1.grid()
    ax1.plot(tt, ch("control_dist"))
    ax1.plot(tt, ch("obj_dist"))
    ax1.legend(["$dist_{control}$", "$dist_{obj}$"])
    ax2 = plt.subplot(2, 1, 2, sharex=ax1)
    ax2.set_title("Velocities")
    ax2.set_xlabel("$t$ in s")
    ax2.set_ylabel("$v$ in m/s")
    ax2.grid()
    ax2.plot(tt, ch("v_control"))
    ax2.plot(tt, ch("v_target"))
    ax2.plot(tt, ch("v_ego"))
    ax2.legend(["$v_{control}$", "$v_{target}$", "$v_{ego}$"])
    fig.tight_layout()
    return fig


def validate_log(data_csv: str, lat, kernels: bool = True):
    """Validate the whole log on ``lat``'s device and print the report
    (``kernels=False``: the plain versions on that device)."""
    rep = replay_validate(data_csv, lat, device=lat.device, kernels=kernels)
    print(f"replay validation: ticks={rep.ticks} "
          f"actions={rep.actions_checked} "
          f"edge_violations={rep.edge_violations} "
          f"node_mismatches={rep.node_mismatches} ok={rep.ok}")
    for d in rep.details[:10]:
        print("  ", d)
    return rep


def main(argv=None):
    """The viewer's command line; returns the validation report with
    ``--validate``, else None."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--lattice", required=True)
    ap.add_argument("--tick", type=int, default=-1,
                    help="log row to render (default: last)")
    ap.add_argument("--out", default=None, help="write PNG instead of showing")
    ap.add_argument("--validate", action="store_true",
                    help="re-validate logged node chains against the lattice")
    ap.add_argument("--interactive", action="store_true",
                    help="matplotlib slider over all ticks")
    ap.add_argument("--cpu", action="store_true",
                    help="re-plan on the CPU (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    lat = load_lattice(args.lattice)        # on the CPU: the plot reads it
    if lat is None:
        raise SystemExit(f"could not load lattice from {args.lattice}")
    lat_dev = lat.to(dev)                   # the re-planning reads this one
    rows = read_data_log(args.data)
    if not rows:
        raise SystemExit("empty data log")
    print(f"{len(rows)} logged ticks")

    rep = validate_log(args.data, lat_dev) if args.validate else None

    import matplotlib
    if args.out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # follow-mode debug figure, auto-detected next to the data log
    # (reference visualize_graph_log.py:395-397 path derivation)
    follow_path = args.data.replace("_data.csv", "_follow.csv")
    if os.path.isfile(follow_path):
        ffig = plot_follow_debug(follow_path)
        if ffig is not None and args.out:
            fout = args.out.rsplit(".", 1)[0] + "_follow.png"
            ffig.savefig(fout, dpi=120)
            print("wrote", fout)

    # message log, auto-detected next to the data log
    # (visualize_graph_log.py:455-460)
    msg_path = args.data.replace("_data.csv", "_msg.csv")
    msgs = read_msg_log(msg_path) if os.path.isfile(msg_path) else []
    if msgs:
        print(f"{len(msgs)} logged messages")

    def full_title(i):
        row = rows[i]
        badge, color = tick_badge(lat_dev, row)
        near = messages_near(msgs, float(row.get("time") or 0.0))
        msg_line = ""
        if near:
            lv, m = near[-1][1], near[-1][2]
            msg_line = f"\n[{lv}] {m[:90]}"
        return f"tick {i} / {len(rows) - 1} — {badge}{msg_line}", color

    idx = args.tick if args.tick >= 0 else len(rows) + args.tick
    fig, ax = plt.subplots(figsize=(10, 8))
    title, color = full_title(idx)
    render_tick(ax, lat, rows[idx], title=title)
    ax.title.set_color(color)

    # message timeline under the main axes: markers colored by level, with
    # a cursor at the displayed tick (PlotHandler.highlight_timeline
    # analogue for the offline viewer)
    t0 = float(rows[0].get("time") or 0.0)
    tick_times = [float(r.get("time") or 0.0) - t0 for r in rows]
    cursor = None
    if msgs and not args.out:
        fig.subplots_adjust(bottom=0.22)
        tax = fig.add_axes([0.15, 0.10, 0.7, 0.05])
        tax.set_yticks([])
        tax.set_xlabel("t in s (messages)")
        for mt, lv, _ in msgs:
            tax.axvline(mt - t0, color=MSG_COLORS.get(lv, "k"), lw=1.2,
                        alpha=0.8)
        tax.set_xlim(min(tick_times), max(max(tick_times), 1e-3))
        cursor = tax.axvline(tick_times[idx], color="b", lw=2)

    if args.interactive and not args.out:
        from matplotlib.widgets import Slider
        sax = fig.add_axes([0.15, 0.03, 0.7, 0.03])
        slider = Slider(sax, "tick", 0, len(rows) - 1, valinit=idx, valstep=1)

        def update(val):
            i = int(val)
            ax.clear()
            title, color = full_title(i)
            render_tick(ax, lat, rows[i], title=title)
            ax.title.set_color(color)
            if cursor is not None:
                cursor.set_xdata([tick_times[i], tick_times[i]])
            fig.canvas.draw_idle()

        slider.on_changed(update)
        plt.show()
    elif args.out:
        fig.savefig(args.out, dpi=120)
        print("wrote", args.out)
    else:
        plt.show()
    return rep


if __name__ == "__main__":
    main()
