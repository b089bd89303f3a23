"""Multi-process execution on ``torch.distributed`` — counterpart of the JAX
package's ``parallel/distributed.py``.

A JAX process is a host that holds several devices; a torch process is one
rank on one device.  So the port's mesh is a grid of ranks: the outer
``dcn`` axis counts hosts (groups of ``GLTPL_LOCAL_WORLD_SIZE`` ranks) and
the inner ``dp`` axis the ranks within one.  Collectives run on NCCL on the
card (the default) and on gloo on the CPU; gloo also carries card tensors,
which is how several ranks share one card (NCCL refuses two ranks on one
device).  Nothing falls back: a failed init or collective raises, and
every process group has a finite timeout, so a hung rank fails instead of
waiting for ever.

Environment contract (as in the JAX package):

    GLTPL_NUM_PROCESSES     world size (default 1: no process group)
    GLTPL_PROCESS_ID        this process's rank
    GLTPL_COORDINATOR       host:port of rank 0's store, or a URL
                            (tcp://host:port, file:///path)
    GLTPL_LOCAL_WORLD_SIZE  ranks a host (default: the world, one host)
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from graphbasedlocaltrajectoryplanner_torch import resolve_device
from graphbasedlocaltrajectoryplanner_torch.models.lattice import (
    build_lattice)
from graphbasedlocaltrajectoryplanner_torch.models.track import (
    make_oval_track)
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.utils.config import (
    OfflineConfig)
from graphbasedlocaltrajectoryplanner_torch.parallel import scenario as sc

# seconds a collective or a rendezvous may wait for the other ranks
DEFAULT_TIMEOUT_S = 300.0

_STATE = dict(device=None, timeout=None)


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def _local_world_size(world: int) -> int:
    return int(os.environ.get("GLTPL_LOCAL_WORLD_SIZE",
                              os.environ.get("LOCAL_WORLD_SIZE", world)))


def _rank_device(device, rank: int, world: int) -> torch.device:
    """This rank's device: the CPU when asked, else the card of its local
    rank (all ranks of a host share card 0 on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = rank % max(_local_world_size(world), 1)
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     backend: str = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group (arguments default from the ``GLTPL_*``
    environment).  With one process and neither a coordinator nor a
    backend given this is a no-op, as in the JAX package; a coordinator or
    a backend makes even one process a real group (NCCL at world 1 on the
    card).

    :param backend: ``"nccl"`` (the default on the card), ``"gloo"`` (the
        default with ``device="cpu"``; on the card only when asked, e.g.
        for several ranks on one card).
    :param device: ``"cpu"``, or a card (default: card ``local rank %
        device count``).
    :returns: ``(rank, world size)``.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("GLTPL_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("GLTPL_PROCESS_ID", "0"))
    if coordinator_address is None:
        coordinator_address = os.environ.get("GLTPL_COORDINATOR")
    dev = _rank_device(device, process_id, num_processes)
    _STATE["device"] = dev
    if num_processes <= 1 and coordinator_address is None and backend is None:
        return 0, 1
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if coordinator_address is None:
        coordinator_address = "localhost:12731"
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev       # initialise now: a failure raises here
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=num_processes, rank=process_id,
        timeout=timeout, **kw)
    _STATE["timeout"] = timeout
    return dist.get_rank(), dist.get_world_size()


def local_device() -> torch.device:
    """The device :func:`init_distributed` chose for this rank (the card
    when it was not called)."""
    return _STATE["device"] if _STATE["device"] is not None \
        else resolve_device(None)


class DistMesh:
    """A grid of ranks (row-major: rank = the flat index of its
    coordinates) with named axes, this rank's coordinates, and one process
    group for every set of axes, over the ranks that share the other axes'
    coordinates.  Every rank builds the groups in the same order (a
    different order hangs).  Without a process group (one process) the
    mesh has one rank and its collectives return their input.

    Collectives over a set of axes: :meth:`all_reduce` and
    :meth:`all_gather` (in coordinate order); ``n_collectives`` counts
    the calls of the Python code that issues them, so, like a kernel's
    ``launches``, it moves when a CUDA graph that holds them is captured
    and not when it is replayed.  With ``timed`` set, each collective
    synchronises the device before and after it and adds its host seconds
    to ``collective_s`` (the share of a tick spent in them); a capture
    cannot synchronise, so a timed collective under capture raises.
    :attr:`capturable` says whether a CUDA graph can hold the mesh's
    collectives.
    """

    def __init__(self, shape, axis_names, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        if len(self.shape) != len(tuple(shape)):
            raise ValueError("one name per mesh axis, no name twice")
        world = math.prod(self.shape.values())
        self.distributed = dist.is_initialized()
        have = dist.get_world_size() if self.distributed else 1
        if world != have:
            raise ValueError(f"mesh {tuple(shape)} needs {world} ranks, the "
                             f"world has {have}")
        self.rank = dist.get_rank() if self.distributed else 0
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                           np.unravel_index(self.rank, tuple(shape)))))
        self.device = torch.device(device) if device is not None \
            else local_device()
        self.timed = False
        self.collective_s = 0.0
        self.n_collectives = 0
        self._groups = {}
        if not self.distributed:
            return
        grid = np.arange(world).reshape(tuple(shape))
        n = len(self.axis_names)
        for r in range(1, n + 1):
            for sub in itertools.combinations(range(n), r):
                key = tuple(self.axis_names[i] for i in sub)
                if r == n:
                    self._groups[key] = dist.group.WORLD
                    continue
                other = [i for i in range(n) if i not in sub]
                rows = grid.transpose(other + list(sub)).reshape(
                    -1, math.prod(grid.shape[i] for i in sub))
                for ranks in rows:
                    g = dist.new_group(ranks.tolist(),
                                       timeout=_STATE["timeout"])
                    if self.rank in ranks:
                        self._groups[key] = g

    def __repr__(self):
        return (f"DistMesh({self.shape}, rank {self.rank}, coords "
                f"{self.coords}, {self.device})")

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        bad = [a for a in axes if a not in self.shape]
        if bad:
            raise ValueError(f"mesh has no axis {bad[0]!r}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its block of an
        array sharded over them)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def data_axes(self, spatial_axis=None) -> tuple:
        return tuple(a for a in self.axis_names if a != spatial_axis)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives: on NCCL,
        and with no process group (each collective returns its input);
        not on gloo, which stages card tensors through the host."""
        return not self.distributed or dist.get_backend() == "nccl"

    def _timed(self, fn):
        if not self.timed:
            return fn()
        if cuda_graph.capturing():
            raise RuntimeError(
                "DistMesh.timed is set during a CUDA graph capture: a "
                "captured collective cannot be timed on the host clock; "
                "unset mesh.timed, or time the eager tick "
                "(tick.__wrapped__)")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.collective_s += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, op, axes) -> torch.Tensor:
        """``t`` reduced by ``op`` (``dist.ReduceOp``) over ``axes``."""
        key = self._key(axes)
        if not self.distributed or not key:
            return t
        out = t.clone()
        self.n_collectives += 1
        self._timed(lambda: dist.all_reduce(out, op=op,
                                            group=self._groups[key]))
        return out

    def all_gather(self, t: torch.Tensor, axes) -> list:
        """Every rank's ``t`` over ``axes``, in coordinate order."""
        key = self._key(axes)
        if not self.distributed or not key:
            return [t]
        is_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if is_bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size(key))]
        self.n_collectives += 1
        self._timed(lambda: dist.all_gather(parts, src,
                                            group=self._groups[key]))
        return [p.to(torch.bool) for p in parts] if is_bool else parts


def make_dist_mesh(axis_names=("dcn", "dp"), device=None) -> DistMesh:
    """The mesh over every rank: ``(hosts, ranks a host)`` with the
    ``dcn`` axis outermost, where a host is a group of
    ``GLTPL_LOCAL_WORLD_SIZE`` consecutive ranks.  With one group (one
    host, or one process) the mesh is flat, ``("dp",)``, as in the JAX
    package."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _local_world_size(world)
    if local < 1 or world % local:
        raise ValueError(f"{world} ranks do not split into hosts of {local}")
    if world // local == 1:
        return DistMesh((world,), ("dp",), device)
    return DistMesh((world // local, local), axis_names, device)


def local_rows(n: int, mesh: DistMesh, spatial_axis=None) -> slice:
    """The contiguous rows of an ``n``-row batch that this rank holds: its
    block over the data axes (every axis but ``spatial_axis``)."""
    axes = mesh.data_axes(spatial_axis)
    parts = mesh.size(axes) if axes else 1
    if n % parts:
        raise ValueError(f"batch {n} does not split over {parts} ranks")
    per = n // parts
    i = mesh.index(axes) if axes else 0
    return slice(i * per, (i + 1) * per)


def shard_scenarios(scen, mesh: DistMesh, spatial_axis=None):
    """This rank's contiguous slice of a scenario batch built identically
    on every rank, on the mesh's device (the JAX package's
    ``shard_scenarios`` shards over every mesh axis; over the data axes
    when a spatial axis replicates the scenarios)."""
    rows = local_rows(scen.start_layer.shape[0], mesh, spatial_axis)
    return sc.Scenario(**{f.name: getattr(scen, f.name)[rows].to(mesh.device)
                       for f in dataclasses.fields(scen)})


def gather_results(res: dict, mesh: DistMesh, spatial_axis=None) -> dict:
    """The batch-sharded tensors of ``res`` gathered from every rank along
    the batch dimension, in batch order, on every rank (the counterpart of
    ``multihost_utils.process_allgather(..., tiled=True)``)."""
    axes = mesh.data_axes(spatial_axis)
    return {k: torch.cat(mesh.all_gather(v, axes), dim=0)
            for k, v in res.items()}


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv, n_ranks: int, timeout_s: float, cwd=None) -> list:
    """Run ``python argv...`` as ``n_ranks`` fresh interpreters (never a
    fork of this process, which may have initialized CUDA), each with the
    ``GLTPL_*`` variables of its rank and one coordinator on a free port;
    wait at most ``timeout_s`` for all of them.  Raises if a rank fails or
    is still running at the limit (every rank is then killed).

    :returns: each rank's standard output, in rank order.
    """
    port = free_port()
    procs, logs = [], []
    for r in range(n_ranks):
        renv = dict(os.environ,
                    GLTPL_NUM_PROCESSES=str(n_ranks),
                    GLTPL_PROCESS_ID=str(r),
                    GLTPL_COORDINATOR=f"localhost:{port}")
        # files, not pipes: a rank that fills a pipe nobody reads yet
        # would block
        logs.append((tempfile.TemporaryFile("w+"),
                     tempfile.TemporaryFile("w+")))
        procs.append(subprocess.Popen([sys.executable, *argv], env=renv,
                                      cwd=cwd, stdout=logs[-1][0],
                                      stderr=logs[-1][1], text=True))
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} still running after "
                                   f"{timeout_s} s")
        outs, failed = [], []
        for r, (p, (so, se)) in enumerate(zip(procs, logs)):
            so.seek(0)
            se.seek(0)
            outs.append(so.read())
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n"
                              f"{se.read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for so, se in logs:
            so.close()
            se.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def collective_share(tick, args=(), tick_ms: float = None,
                     replays: int = 5) -> dict:
    """The share of one call ``tick(*args)`` of a sharded tick
    (``scenario.make_sharded_tick``) spent in the mesh's collectives.

    Where the collectives run eagerly (the eager tick, and the staged
    compiled tick under gloo) they are timed on the host clock
    (``mesh.timed``: each collective between two device synchronisations,
    over the tick's host time).  Where a CUDA graph holds them (the
    compiled tick's ``"graph"`` form under NCCL) ``replays`` replays run
    under ``torch.profiler``, the ranks meeting before each at a barrier
    of a gloo group (which launches nothing on the card): each NCCL
    kernel's (its name holds ``nccl``) median device time, times its
    launches a replay, summed, over ``tick_ms`` (default the profiled
    calls' mean host time).  A collective kernel's time includes its wait
    for the other ranks.  NCCL at world 1 launches no kernel for an
    in-place reduction and copies for a gather, so its share is 0 there.

    :returns: dict(share, how ("host" or "profiled replay"), and for a
        profiled replay nccl_ms and nccl_kernels {name: launches a
        replay}).
    """
    mesh = tick.mesh
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if getattr(tick, "form", None) == "graph":
        from torch.profiler import ProfilerActivity, profile
        host = dist.new_group(backend="gloo") if mesh.distributed else None
        tick(*args)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(replays):
                if host is not None:
                    dist.barrier(group=host)
                sync()
                tick(*args)
                sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / replays
        times = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA") \
                    and "nccl" in e.name.lower():
                times.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        nccl_ms = sum(float(np.median(t)) * len(t) / replays
                      for t in times.values())
        return dict(share=nccl_ms / (tick_ms or wall_ms),
                    how="profiled replay", nccl_ms=nccl_ms,
                    nccl_kernels={k: len(t) / replays
                                  for k, t in times.items()})
    mesh.timed, mesh.collective_s = True, 0.0
    try:
        sync()
        t0 = time.perf_counter()
        tick(*args)
        sync()
        return dict(share=mesh.collective_s / (time.perf_counter() - t0),
                    how="host")
    finally:
        mesh.timed = False


def run_multihost_selftest(batch_per_device: int = 8, iters: int = 2,
                           seed: int = 0, return_results: bool = False):
    """One sharded-tick run inside an initialized process: the quick oval
    lattice, ``make_sharded_tick`` over :func:`make_dist_mesh` (compiled
    on the card: its form is ``tick_form``), timed over ``iters`` ticks
    after a first one, and the share of a tick in collectives
    (:func:`collective_share`); the fleet statistics, which every rank
    must agree on (they come out of collectives).  Used by
    ``testing_tools/scaling_bench.py`` and the port's distributed tests.

    :returns: dict(process_index, process_count, global_devices, batch,
        replans_per_sec, fleet_min_cost, fleet_actions, tick_ms,
        collective_share, collective_share_how, tick_form, device); with
        ``return_results`` also the gathered ``cost``, ``valid`` and
        ``traj_sum`` (per scenario, the sum of |trajs|).
    """
    mesh = make_dist_mesh()
    dev = mesh.device
    lat = build_lattice(make_oval_track(n=200, r=50.0, straight=150.0),
                        OfflineConfig(min_plan_horizon=200.0),
                        md5_params="scaling").to(dev)
    n_dev = math.prod(mesh.shape.values())
    batch = batch_per_device * n_dev
    scen = sc.random_scenarios(lat, batch=batch, seed=seed, n_objects=1,
                               device=dev)
    scen = shard_scenarios(scen, mesh)
    tick = sc.make_sharded_tick(lat, mesh, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    res, stats = tick(scen)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        res, stats = tick(scen)
    sync()
    dt = time.perf_counter() - t0
    share = collective_share(tick, (scen,), dt / iters * 1e3)
    rep = dict(
        process_index=mesh.rank,
        process_count=n_dev,
        global_devices=n_dev,
        batch=batch,
        replans_per_sec=batch * iters / dt,
        tick_ms=dt / iters * 1e3,
        collective_share=share["share"],
        collective_share_how=share["how"],
        tick_form=getattr(tick, "form", "eager"),
        fleet_min_cost=float(stats["fleet_min_cost"]),
        fleet_actions=int(stats["fleet_actions"]),
        device=str(dev),
    )
    if return_results:
        g = gather_results(dict(cost=res["cost"], valid=res["valid"],
                                trajs=res["trajs"]), mesh)
        rep["cost"] = g["cost"].cpu().numpy().tolist()
        rep["valid"] = g["valid"].cpu().numpy().astype(int).tolist()
        rep["traj_sum"] = g["trajs"].double().abs().sum(
            dim=(1, 2, 3)).cpu().numpy().tolist()
    return rep
