"""PyTorch port, runtime contract: the package imports without JAX and
without the JAX package, and its entry points default to the card —
raising, never falling back to the CPU, where there is none."""

import subprocess
import sys
import textwrap

import pytest
import torch

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib",
                       "graphbasedlocaltrajectoryplanner_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import graphbasedlocaltrajectoryplanner_torch as pkg
    facade = "graphbasedlocaltrajectoryplanner_torch.planner.facade"
    assert facade not in sys.modules            # GraphLTPL resolves lazily
    assert pkg.GraphLTPL is importlib.import_module(facade).GraphLTPL
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for n in names:
        importlib.import_module(n)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib",
                                  "graphbasedlocaltrajectoryplanner_tpu")]
    assert not bad, bad
    print(" ".join(names))
""")

# modules of the interactive path, of kernel 6, of the SQP backend, of the
# stage profiler, the log replay and the perception link, of the plot, the
# log viewer, the examples, the native library and the profiling tools,
# of the multi-device tick, the entry tools, and the bench and its parity
# gate (beside the fleet tick's)
_NEW_MODULES = (
    "ops.cuda_minplus", "planner.handler", "planner.facade",
    "planner.hostmath", "planner.objects", "utils.veh_dyn", "utils.logging",
    "testing_tools.vdc_dummy", "testing_tools.objectlist_dummy",
    "testing_tools.closed_loop", "ops.qp", "ops.cuda_admm",
    "testing_tools.admm_cases", "parallel.profiling", "utils.replay",
    "utils.zmq_interface", "testing_tools.profile_stages",
    "visualization.plot_handler", "visualization.log_viewer",
    "examples.main_min_example", "examples.main_std_example", "native",
    "testing_tools.profile_tick", "testing_tools.profile_assembly",
    "testing_tools.profile_sqp", "parallel.distributed", "parallel.spatial",
    "testing_tools.dist_cases", "testing_tools.scaling_bench", "entry",
    "testing_tools.validate_tracks", "bench", "testing_tools.cuda_parity")


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 27
    missing = {"graphbasedlocaltrajectoryplanner_torch." + m
               for m in _NEW_MODULES} - names
    assert not missing, missing


def test_entry_points_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as tl
    from graphbasedlocaltrajectoryplanner_torch.models import track as tt
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc
    from graphbasedlocaltrajectoryplanner_torch.utils.config import (
        OfflineConfig)
    lat = tl.build_lattice(tt.make_oval_track(n=120, r=40.0, straight=80.0),
                           OfflineConfig(min_plan_horizon=120.0))
    assert lat.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.make_batched_tick(lat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lat.to()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.random_scenarios(lat, 2)
    # asking for the CPU works
    scen = sc.random_scenarios(lat, 2, device="cpu")
    assert scen.start_layer.device.type == "cpu"
