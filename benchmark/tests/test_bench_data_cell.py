"""A cell is added as data alone: a new traffic mix file and a new entry
in BENCHMARK.json, with no edit to any file the benchmark has, run
through the same harness."""

import json
import os
import shutil

from benchmark import core, cells
from benchmark.tests import helpers


def test_a_new_cell_from_data_files_alone(tmp_path):
    root = str(tmp_path)
    shutil.copy(core.MANIFEST, root)
    shutil.copytree(os.path.join(core.HERE, "traffic"),
                    os.path.join(root, "benchmark", "traffic"))
    mix = dict(core.traffic("fleet_b1024_short_h"), batch=8, n_batches=2,
               n_objects=3, n_pred=1, o_pad=16, check_per_batch=4)
    with open(os.path.join(root, "benchmark", "traffic",
                           "fleet_3opp_o16.json"), "w") as fh:
        json.dump(mix, fh)
    man = core.manifest(os.path.join(root, "BENCHMARK.json"))
    man["workloads"].append(dict(
        name="fleet_fb_3opp_o16", config="ltpl_fb_oval",
        traffic="fleet_3opp_o16", chips=1,
        why="three opponents at 16 collision slots: wider hit masks"))
    for m in man["end_to_end"]:
        if "workloads" in m and helpers.CELL in m["workloads"]:
            m["workloads"].append("fleet_fb_3opp_o16")
    cell = core.cell(man, "fleet_fb_3opp_o16")
    cfg = core.config(man, cell["config"], root=core.ROOT)
    got = core.traffic(cell["traffic"], root=root)
    assert got == mix
    res, checks = cells.run_cell(man, cell, cfg, got, 5, 0.3, False,
                                   core.clock(), helpers.CPU)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"replans_per_s", "setup_s"}


def test_a_new_configuration_from_data_files_alone(tmp_path):
    """A configuration on another closed track (a wider oval), added as
    its own JSON file and an entry, with the existing traffic."""
    root = str(tmp_path)
    base = core.config(helpers.MAN, "ltpl_fb_oval")
    cfg = dict(base, name="ltpl_fb_oval_wide",
               track=dict(base["track"], width=14.0),
               lattice=dict(base["lattice"], N=24))
    os.makedirs(os.path.join(root, "benchmark", "configs"))
    path = "benchmark/configs/ltpl_fb_oval_wide.json"
    with open(os.path.join(root, path), "w") as fh:
        json.dump(cfg, fh)
    man = json.loads(json.dumps(helpers.MAN))
    man["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                               file=path, reduced=["track"], why="wider"))
    man["workloads"].append(dict(name="fleet_fb_oval_wide",
                                 config=cfg["name"],
                                 traffic="fleet_b1024_short_h", chips=1,
                                 why="a wider track: more nodes a layer"))
    for m in man["end_to_end"]:
        if helpers.CELL in m.get("workloads", []):
            m["workloads"].append("fleet_fb_oval_wide")
    cell = core.cell(man, "fleet_fb_oval_wide")
    got = core.config(man, cell["config"], root=root)
    assert got == cfg
    lat = core.reference_lattice(got, core.track_csv(got))
    assert lat.N == 24 and lat.nodes_in_layer.max() > helpers.ref_lattice(
        "ltpl_fb_oval").nodes_in_layer.max()
    mix = helpers.small_fleet_mix(core.traffic(cell["traffic"]))
    res, checks = cells.run_cell(man, cell, got, mix, 7, 0.3, False,
                                 core.clock(), helpers.CPU)
    assert res["correct"], checks
