"""The fleet mix: the program's compiled fleet tick
(``parallel/scenario.make_batched_tick``) replanning batch after batch,
back to back, for the whole window.

Set-up builds the program's lattice (cached in the checkout) and the
reference's, finds the reference's speed stage for the configuration's
velocity backend, makes every scenario batch from the seed with the
benchmark's generator (``benchmark/scenarios.py``), and warms the tick's
one signature on every batch.  The window runs ticks in a closed loop,
each on the next batch; ``replans_per_s`` is every scenario of every tick
over the window's whole time, the last tick's device work included.  The
check replans a sample of the window's scenarios, drawn from the seed,
with the plain reference (``benchmark/reference/plan.py``) on the host.

A mix may carry tick inputs from each batch's previous output into its
next tick (``carry``: tick keyword -> output key, e.g. ``{"sqp_x0":
"vx_sqp"}``, the SQP planner's warm start): the tick is then
:class:`Carried`, and the check hands the reference the carried inputs
that produced each checked output.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark import core, scenarios, trace, work
from benchmark.reference import plan


@dataclasses.dataclass
class Fleet:
    cfg: dict
    mix: dict
    seed: int
    ref_lat: object = None
    prog_lat: object = None
    ref_batches: list = None     # each batch's scenarios as numpy arrays
    batches: list = None         # the program's
    tick: object = None
    opts: dict = None
    tp: dict = None              # the reference's parameters


def batch_seed(seed: int, j: int, rank: int = 0) -> list:
    """numpy's seed of rank ``rank``'s batch ``j``: any whole ``--seed``,
    negative or past 64 bits, maps to one."""
    return [seed % 2 ** 64, j, rank]


def make_batches(ref_lat, mix: dict, seed: int, js=None) -> list:
    """The mix's scenario batches (``js``: those only) from the seed."""
    js = range(mix["n_batches"]) if js is None else js
    return [scenarios.batch(ref_lat, mix, batch_seed(seed, j,
                                                     mix.get("rank", 0)))
            for j in js]


def to_program(b: dict, dev):
    """A batch as the program's Scenario on ``dev``."""
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as psc
    return psc.Scenario(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                           for k, v in b.items()})


def program_tick(prog_lat, cfg: dict, opts: dict, dev, kernels: bool = True):
    from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as psc
    kw = dict(opts)
    w_last = kw.pop("w_last_factors")
    machines = torch.tensor(cfg["vehicle"]["machines"], dtype=torch.float32,
                            device=dev)
    return psc.make_batched_tick(prog_lat, kernels, w_last_factors=w_last,
                                 device=dev, machines=machines, **kw)


class Carried:
    """The program's tick with the mix's ``carry``: each batch's tick
    takes those keywords from the same batch's previous output, as a car
    plans from its own last plan.  A batch's first tick, with nothing yet
    to carry, runs the eager tick (the program's ``__wrapped__``), so
    that the carried signature is the only one the compiled tick
    captures.  ``__wrapped__`` is the eager tick with the carried inputs;
    ``graphs`` and ``report()`` are the program's tick's."""

    def __init__(self, tick, carry: dict):
        self.tick = tick
        self.carry = dict(carry)
        self.eager = getattr(tick, "__wrapped__", tick)
        self.__wrapped__ = functools.partial(self._call, self.eager)
        # id(batch) -> (batch, inputs of its next tick, of its last tick);
        # the batch is held, so that no other object takes its id
        self.state = {}

    def __call__(self, scen):
        return self._call(self.tick, scen)

    def _call(self, fn, scen):
        held = self.state.get(id(scen))
        if held is None:
            over, out = {}, self.eager(scen)
        else:
            over = held[1]
            out = fn(scen, **over)
        nxt = {kw: out[key] for kw, key in self.carry.items()}
        self.state[id(scen)] = (scen, nxt, over)
        return out

    def start(self, batches) -> None:
        """The cold first tick of each batch that has had none."""
        for b in batches:
            if id(b) not in self.state:
                self(b)

    def inputs(self, scen) -> dict:
        """The carried inputs of the last tick on ``scen``."""
        return self.state[id(scen)][2]

    @property
    def graphs(self):
        return self.tick.graphs

    def report(self) -> dict:
        return self.tick.report()


def setup(cfg: dict, mix: dict, seed: int, dev, kernels: bool = True,
          make_tick=True, fault=None) -> Fleet:
    """The cell's set-up; ``fault`` (the tests') breaks the program's
    tick underneath: ``fault(tick)`` in its place."""
    csv = core.track_csv(cfg)
    f = Fleet(cfg, mix, seed)
    f.ref_lat = core.reference_lattice(cfg, csv)
    f.tp = core.reference_params(cfg, f.ref_lat)
    # a backend without its plain reference stops here, not after a window
    plan.speed_stage(f.tp["vp_backend"])
    f.prog_lat = core.program_lattice(cfg, csv)
    f.opts = core.tick_options(cfg)
    f.ref_batches = make_batches(f.ref_lat, mix, seed)
    f.batches = [to_program(b, dev) for b in f.ref_batches]
    if make_tick:
        f.tick = program_tick(f.prog_lat, cfg, f.opts, dev, kernels)
        if fault is not None:
            f.tick = fault(f.tick)
        if mix.get("carry"):
            f.tick = Carried(f.tick, mix["carry"])
    return f


def warm(tick, batches, dev) -> None:
    """The tick's one signature captured on the first batch, then one
    replay on every batch; a :class:`Carried` tick first plans each batch
    cold."""
    if isinstance(tick, Carried):
        tick.start(batches)
    for b in batches:
        tick(b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(tick, batches, seconds: float, dev):
    """Ticks back to back on batch after batch until ``seconds`` have
    passed at the end of a round of batches; returns (ticks, seconds
    including the device's last work, the last output of each batch, the
    carried inputs of each batch's last tick or None without carry)."""
    keep = [None] * len(batches)
    n = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = core.clock()
    while True:
        j = n % len(batches)
        keep[j] = tick(batches[j])
        n += 1
        if j == len(batches) - 1 and core.clock() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = core.clock() - t0
    used = ([tick.inputs(b) for b in batches] if isinstance(tick, Carried)
            else None)
    return n, secs, keep, used


def device_ms(tick, batches, n: int = 48) -> str:
    """Quartiles of the device time of ``n`` ticks, each between two CUDA
    events, the ticks queued back to back (a diagnostic line)."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for i, (a, b) in enumerate(ev):
        a.record()
        tick(batches[i % len(batches)])
        b.record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in ev)
    return f"{ms[n // 4]:.4f} / {ms[n // 2]:.4f} / {ms[3 * n // 4]:.4f}"


# ---------------------------------------------------------------------------
# the trace run's readings
# ---------------------------------------------------------------------------

def traced_readings(tick, batches, dev, program: str, iters: int) -> dict:
    """Stage device ms of the eager tick by the program's ranges, the
    counted kernels' work from one eager tick, and a traced window of
    ``iters`` compiled ticks: device ms by kernel name, busy and window
    seconds, the breakdown."""
    eager = getattr(tick, "__wrapped__", tick)
    w = {}
    with work.recorded(program, w):
        eager(batches[0])
    trace.sync()
    with trace.traced() as prof:
        for _ in range(4):
            eager(batches[0])
            trace.sync()
    ev = prof.events()
    trace.require_device_time(ev)
    stage = trace.stage_ms(ev, 4)
    for b in batches[:2]:
        tick(b)
    trace.sync()
    with trace.traced() as prof:
        with trace.window_span():
            for i in range(iters):
                tick(batches[i % len(batches)])
            trace.sync()
    ev = prof.events()
    trace.require_device_time(ev)
    win = trace.window_reading(ev)
    return dict(kind="fleet", stage_ms=stage, work=w,
                kernel_ms=trace.kernel_ms(ev, iters), **win)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

LATTICE_COUNTS = ("L", "N", "S", "H_max", "closed")
LATTICE_EXACT = ("node_valid", "edge_valid", "rl_idx", "nodes_in_layer",
                 "h_goal")


def program_lattice_view(prog_lat):
    """The program's lattice under the reference's field names, numpy."""
    import types
    arr = {k: getattr(prog_lat, k).cpu().numpy() for k in (
        "node_valid", "edge_valid", "rl_idx", "nodes_in_layer", "edge_npts",
        "node_pos", "w")}
    arr["h_goal"] = prog_lat.h_goal_for_start.cpu().numpy()
    return types.SimpleNamespace(
        **arr, **{k: getattr(prog_lat, k) for k in LATTICE_COUNTS})


def lattice_numbers(a, b) -> dict:
    """Lattice ``a`` (the program's view, or the control's) against the
    reference's ``b``: the discrete elements that differ (sizes, valid
    nodes and edges, raceline nodes, horizons, the sample counts of valid
    edges), the largest node position gap (m) and the largest relative
    gap of a valid edge's cost."""
    bad = sum(getattr(a, k) != getattr(b, k) for k in LATTICE_COUNTS)
    if bad:
        return dict(lattice_mismatches=int(bad) * 10 ** 6,
                    lattice_dpos_m=float("inf"), lattice_cost_rel=float("inf"))
    for k in LATTICE_EXACT:
        bad += int((getattr(a, k) != getattr(b, k)).sum())
    ev = b.edge_valid
    bad += int(((a.edge_npts != b.edge_npts) & ev).sum())
    d = np.abs(a.node_pos - b.node_pos)
    rw = b.w.astype(float)
    rel = np.where(ev, np.abs(a.w.astype(float) - rw)
                   / np.maximum(np.abs(rw), 1.0), 0.0)
    return dict(lattice_mismatches=int(bad),
                lattice_dpos_m=float(np.where(b.node_valid[..., None], d,
                                              0).max()),
                lattice_cost_rel=float(rel.max()))


DISCRETE = ("valid", "h_eff", "n_valid", "case_a", "relabel", "em_base")


def compare(p: dict, r: dict) -> dict:
    """The numbers compared between the program's tick outputs ``p`` and
    the reference's ``r`` on the same scenarios (numpy): discrete fields
    equal; the costs of actions valid on both sides (largest relative
    gap); trajectories of actions valid on both sides, over their real
    rows: the largest gap in s, x, y (m) and in velocity (m/s)."""
    mism = 0
    for k in DISCRETE:
        a, b = np.asarray(p[k]), np.asarray(r[k])
        mism += b.size if a.shape != b.shape else int((a != b).sum())
    both = np.asarray(p["valid"]) & np.asarray(r["valid"])
    pc, rc = p["cost"].astype(float), r["cost"].astype(float)
    rel = np.where(both, np.abs(pc - rc) / np.maximum(np.abs(rc), 1.0), 0.0)
    n = np.minimum(p["n_valid"], r["n_valid"])
    live = both[..., None] & (np.arange(r["trajs"].shape[2]) < n[..., None])
    d = np.nan_to_num(np.abs(p["trajs"].astype(float) - r["trajs"]),
                      nan=np.inf)
    dpos = np.where(live[..., None], d[..., 0:3], 0.0)
    dv = np.where(live, d[..., 5], 0.0)
    return dict(discrete_mismatches=int(mism),
                max_cost_rel=float(rel.max()) if rel.size else 0.0,
                max_dpos_m=float(dpos.max()) if dpos.size else 0.0,
                max_dv_mps=float(dv.max()) if dv.size else 0.0)


def sample_rows(seed: int, n_batches: int, batch: int, per_batch: int):
    """The checked scenarios, drawn from the seed: ``per_batch`` rows of
    each batch."""
    rng = np.random.default_rng([seed % 2 ** 64, 7919])
    return [np.sort(rng.choice(batch, size=min(per_batch, batch),
                               replace=False)) for _ in range(n_batches)]


def checked_rows(f: Fleet):
    return sample_rows(f.seed, f.mix["n_batches"], f.mix["batch"],
                       f.mix["check_per_batch"])


def program_rows(keep, rows):
    """The program's outputs (or carried inputs) of the checked
    scenarios, batch by batch, concatenated (numpy on the host)."""
    out = {}
    for o, r in zip(keep, rows):
        if o is None:
            raise RuntimeError("a batch got no tick in the window")
        for k, v in o.items():
            idx = torch.as_tensor(r, device=v.device, dtype=torch.long)
            out.setdefault(k, []).append(v[idx].cpu())
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16, kept in its own type."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16).to(t.dtype).numpy()


def bf16_lattice(lat):
    from benchmark.reference.lattice import RefLattice
    return dataclasses.replace(lat, **{k: bf16(getattr(lat, k))
                                       for k in RefLattice.FLOAT_FIELDS})


def bf16_batch(b: dict) -> dict:
    return {k: bf16(v) if v.dtype.kind == "f" else v for k, v in b.items()}


def check(f: Fleet, p_rows: dict, control=None, carried=None) -> list:
    """The checks of a fleet run: the lattice, then the sampled scenarios'
    outputs against the reference's, each number beside its limit;
    ``carried`` the tick inputs carried into those scenarios' checked
    ticks (:func:`program_rows` of the window's), which the reference's
    speed stage takes too.  ``control="bf16"`` puts the control in the
    program's place: the reference on its lattice, the scenarios and the
    carried inputs held in bfloat16."""
    rows = checked_rows(f)
    scen = scenarios.concat([scenarios.rows(b, r)
                             for b, r in zip(f.ref_batches, rows)])
    r = plan.replan(f.ref_lat, scen, f.tp, carried)
    if control is None:
        lat_nums = lattice_numbers(program_lattice_view(f.prog_lat),
                                   f.ref_lat)
    elif control == "bf16":
        lat_c = bf16_lattice(f.ref_lat)
        p_rows = plan.replan(lat_c, bf16_batch(scen), f.tp,
                             carried and bf16_batch(carried))
        lat_nums = lattice_numbers(lat_c, f.ref_lat)
    else:
        raise ValueError(f"control {control!r}")
    nums = compare(p_rows, r)
    nums["discrete_mismatches"] += lat_nums["lattice_mismatches"]
    nums["max_dpos_m"] = max(nums["max_dpos_m"], lat_nums["lattice_dpos_m"])
    nums["max_cost_rel"] = max(nums["max_cost_rel"],
                               lat_nums["lattice_cost_rel"])
    return limits(nums, f.cfg["guarantees"])


def limits(nums: dict, g: dict) -> list:
    return [dict(name=k, value=v, limit=g[k], ok=bool(v <= g[k]))
            for k, v in nums.items()]
