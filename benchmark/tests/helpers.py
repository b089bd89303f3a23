"""Small-size set-ups shared by the benchmark's CPU tests."""

import functools

import torch

from benchmark import core

CPU = torch.device("cpu")
MAN = core.manifest()
CELL = MAN["workloads"][0]["name"]


def cell(name=CELL):
    c = core.cell(MAN, name)
    return c, core.config(MAN, c["config"]), core.traffic(c["traffic"])


def small_fleet_mix(mix):
    """The cell's mix at a size the CPU runs in seconds."""
    return dict(mix, batch=8, n_batches=2, check_per_batch=4)


@functools.lru_cache(maxsize=None)
def ref_lattice(config):
    cfg = core.config(MAN, config)
    return core.reference_lattice(cfg, core.track_csv(cfg))


def run(name=CELL, mix=None, fault=None, control=None, seed=2 ** 31 + 5,
        seconds=0.3):
    """One run of cell ``name`` on the CPU (the program's plain path)."""
    from benchmark import cells
    c, cfg, m = cell(name)
    if mix is None:
        mix = small_fleet_mix(m)
    return cells.run_cell(MAN, c, cfg, mix, seed, seconds, False,
                          core.clock(), CPU, fault=fault, control=control)


def failed(checks):
    return [c["name"] for c in checks if not c["ok"]]
