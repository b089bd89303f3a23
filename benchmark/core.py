"""What every cell of the benchmark shares: the manifest and the files it
names, the cache directories inside the checkout, the device check, the
lattices, the result line and the import check.

Nothing here imports the program or torch at module level.
"""

from __future__ import annotations

import configparser
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
CACHE = os.path.join(HERE, "cache")
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
PROGRAM = "graphbasedlocaltrajectoryplanner_torch"
# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "graphbasedlocaltrajectoryplanner_tpu")


def set_cache_env() -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout, and set the host's threads, before torch or numpy is
    imported.  The program builds its kernels into its own ``_build/``
    directory, which is inside the checkout too."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    # libraries that would pull JAX in by themselves stay off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one host thread a library: the host side of a tick runs on one core,
    # and idle worker threads do not spin beside it
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

def manifest(path: str = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    """The configuration ``name``: its file, relative to ``root``."""
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    """The traffic mix ``benchmark/traffic/<name>.json`` under ``root``."""
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{name}.json")) as fh:
        return json.load(fh)


def end_to_end(man: dict, workload: str) -> list:
    """The end-to-end metrics that ``workload`` reports."""
    return [m for m in man["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(man: dict, workload: str) -> list:
    """The per-layer metrics that ``workload`` reports: those that list it,
    and those without a list whose moved metric it reports."""
    e2e = {m["name"] for m in end_to_end(man, workload)}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def reader(name: str):
    """The reader of per-layer metric ``name``:
    ``benchmark/metrics/<name>.py``'s ``read(ctx) -> float | None``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ini(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser()
    if not cp.read(os.path.join(ROOT, path)):
        raise FileNotFoundError(path)
    return cp


def ini_values(cfg: dict) -> dict:
    """Each online INI value the configuration maps to a name
    (``ini_to_tick``: ``"SECTION.key" -> name``), parsed as JSON where it
    is a number, a list or a dict, else kept as text."""
    cp = ini(cfg["online_ini"])
    out = {}
    for key, name in cfg["ini_to_tick"].items():
        sec, k = key.split(".")
        raw = cp.get(sec, k)
        try:
            out[name] = json.loads(raw)
        except json.JSONDecodeError:
            out[name] = raw.strip()
    return out


def mapped_values(cfg: dict) -> dict:
    """Every name the configuration maps: its INI values
    (:func:`ini_values`) and its ``tick_literals``, option values that no
    INI key holds (``{"tire_end_idx": 0, "sqp_step": 2.5}``).  A name
    given both ways is refused."""
    out = ini_values(cfg)
    lit = cfg.get("tick_literals", {})
    both = sorted(set(out) & set(lit))
    if both:
        raise ValueError(f"{cfg['name']}: {both} both in ini_to_tick and "
                         "in tick_literals")
    return dict(out, **lit)


def tick_options(cfg: dict) -> dict:
    """The program's fleet tick options: every mapped value
    (:func:`mapped_values`) that the tick takes by name (a keyword of
    ``parallel/scenario.scenario_tick``, to which ``make_batched_tick``
    passes its options), and the configuration's vehicle (``machines``
    left out: a tensor, made on the device by the caller).  A mapped value
    that the tick does not take (the upstream ``v_max_offset``, the follow
    controller's gains) reaches the reference alone."""
    import inspect
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario
    keys = inspect.signature(scenario.scenario_tick).parameters
    veh = cfg["vehicle"]
    opts = {k: v for k, v in mapped_values(cfg).items() if k in keys}
    return dict(opts, vel_max=veh["vel_max"], gg_lim=tuple(veh["gg"]),
                safety_d=veh["safety_d"], dyn_model_exp=veh["dyn_model_exp"],
                drag_coeff=veh["drag_coeff"], m_veh=veh["m_veh"])


def reference_params(cfg: dict, ref_lat) -> dict:
    """The same parameters for the reference, read from the same files:
    the vehicle, every mapped value, the follow controller's gains by name
    and the lattice's vehicle length.  ``vp_backend`` picks the
    reference's speed stage (``benchmark/reference/plan.speed_stage``)."""
    v = mapped_values(cfg)
    if v["vp_backend"] == "fb" and v.get("filt_window", 1) != 1:
        raise ValueError("the reference plans fb profiles, unsmoothed")
    pd = v["control_params"]
    return dict(cfg["vehicle"], **v, c_p=pd["c_p"], k_d=pd["k_d"],
                k_p=pd["k_p"], veh_length=ref_lat.cfg.veh_length)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def require_cards(n: int):
    """The run's card count check: raises SystemExit (no result) without
    CUDA or with fewer than ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        sys.exit(f"{torch.cuda.device_count()} CUDA devices, the cell "
                 f"needs {n}")


def card_state() -> str:
    """``nvidia-smi``'s SM clock, power draw and temperature now."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc})"


def device_info(count: int, peak_bytes: int, dev) -> dict:
    import torch
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=peak_bytes)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=count, memory_peak_bytes=int(peak_bytes))


# ---------------------------------------------------------------------------
# inputs both sides get
# ---------------------------------------------------------------------------

def track_csv(cfg: dict) -> str:
    """The configuration's track as a CSV in the LTPL 12-column format
    (the raw file that the program and the reference both read): a track
    file the configuration names (``"generator": "csv"``, ``"file"``
    relative to the checkout), or the generated oval written into the
    cache."""
    from benchmark.reference import track as rtrack
    tr = cfg["track"]
    if tr["generator"] == "csv":
        return os.path.join(ROOT, tr["file"])
    if tr["generator"] != "oval":
        raise ValueError(f"unknown track generator {tr['generator']!r}")
    rows = rtrack.oval_rows(**{k: v for k, v in tr.items()
                               if k != "generator"})
    text = "\n".join(";".join(repr(float(v)) for v in r) for r in rows)
    path = os.path.join(CACHE, "tracks", f"{cfg['name']}.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    old = open(path).read() if os.path.isfile(path) else None
    if old != text:                    # written once: its md5 keys the cache
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    return path


def reference_lattice(cfg: dict, csv: str):
    """The reference's own lattice of the track (plain NumPy on the
    host)."""
    from benchmark.reference import lattice as rlat
    from benchmark.reference import track as rtrack
    return rlat.build(rtrack.read_csv(csv),
                      rlat.read_offline(os.path.join(ROOT,
                                                     cfg["offline_ini"])))


def program_lattice(cfg: dict, csv: str):
    """The program's lattice of the track, built by the program's offline
    phase once and cached inside the checkout (keyed by the track's and
    the INI's md5)."""
    from graphbasedlocaltrajectoryplanner_torch.models import lattice as plat
    store = os.path.join(CACHE, "lattice", f"{cfg['name']}.npz")
    return plat.load_or_build(csv, os.path.join(ROOT, cfg["offline_ini"]),
                              store, graph_id=cfg["name"])[0]


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def finish(result: dict, checks: list) -> int:
    """Print each compared number beside its limit on standard error and
    the result line last on standard output; return the exit code.  No
    result is printed (exit 3) if a forbidden module is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr, flush=True)
        return 3
    result["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                        for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def clock() -> float:
    return time.perf_counter()
