"""One run of one cell of the benchmark of the PyTorch/CUDA port
(``graphbasedlocaltrajectoryplanner_torch``) on the card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<mix>.json``, whose ``kind`` picks how it runs:
``fleet``, the compiled fleet tick).  A run sets
up from the seed, warms the cell's own signatures, measures for
``--seconds``, checks what the timed path produced against the plain
reference in ``benchmark/reference/``, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device``, and
with ``--trace 1`` ``breakdown``.  With ``--trace 0`` the metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``benchmark/metrics/<metric>.py``.

A run without a card, or with fewer cards than the cell asks for, exits
with an error and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):      # run as a file: python3 benchmark/run.py
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import core  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    core.set_cache_env()
    man = core.manifest()
    cell = core.cell(man, args.workload)
    cfg = core.config(man, cell["config"])
    mix = core.traffic(cell["traffic"])
    core.require_cards(cell["chips"])
    from benchmark import cells
    return cells.run(man, cell, cfg, mix, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
