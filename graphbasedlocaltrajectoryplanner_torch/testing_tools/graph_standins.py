"""CPU stand-ins for the CUDA runtime calls of ``ops/cuda_graph.py``, so
that the capture and replay logic of the port's compiled calls runs
where there is no card (the CPU tests, and ``dist_cases``' CPU ranks).

:class:`StandInCuda` takes the place of ``cuda_graph._cuda``
(:func:`installed`).  Its graph records every operator that the
captured call runs, with its tensors (:class:`Record`, a
``TorchDispatchMode``), and a replay runs the record again on the same
tensors, each result written into the tensor the capture made, as a CUDA
graph replays its kernels on its buffers.  The Python code of the
captured function runs only at capture, as on the card.  A
``torch.distributed`` collective on a gloo group reaches the mode as one
``c10d`` operator (``c10d.allreduce_``, ``c10d.allgather_``), so the
record holds it like any other; a replay waits for the work each such
operator returns before it runs the next one, as a graph's collective
completes before the kernels after it read its output.

The stand-in runtime keeps a fake device clock (``clock``, in ms), which
each replayed node other than an event record moves on by ``node_ms``.
Its :class:`Event` reads that clock: recorded during a capture it becomes
a node of the graph and takes the clock's time whenever a replay reaches
it, as a timing event recorded in a CUDA graph does.  The graph lists its
nodes' types in capture order (``node_types``, CUDA's numbers: an event
record 7, an aten ``copy_`` a memcpy 1, a ``fill_`` or ``zero_`` a
memset 2, every other operator or recorded unit a kernel 0).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph


class Record(TorchDispatchMode):
    """Every operator run, with its arguments and its result (the
    profiler's range markers left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "profiler":
            self.ops.append((func, args, kwargs, out))
        return out


def write(dst, src):
    """A replayed result into the tensor the capture made (views and
    in-place results already live there)."""
    if torch.is_tensor(dst):
        if dst.untyped_storage().data_ptr() != \
                src.untyped_storage().data_ptr():
            dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            write(d, s)


def wait_works(x) -> int:
    """Waits for every collective's work in a replayed result; returns
    how many there were."""
    if isinstance(x, torch.ScriptObject) and hasattr(x, "wait"):
        x.wait()
        return 1
    if isinstance(x, (list, tuple)):
        return sum(wait_works(v) for v in x)
    return 0


EVENT_RECORD, MEMCPY, MEMSET, KERNEL = 7, 1, 2, 0


class Event:
    """``torch.cuda.Event`` on the fake device clock of ``cuda``."""

    def __init__(self, cuda, enable_timing=False, external=False):
        self.cuda, self.timing, self.external = cuda, enable_timing, external
        self.time = None
        cuda.events.append(self)

    def stamp(self):
        self.time = self.cuda.clock

    def record(self, stream=None):
        rec = self.cuda.recording
        if rec is None:
            self.stamp()
        elif self.external:
            rec.ops.append((self.stamp, (), {}, None))

    def elapsed_time(self, end) -> float:
        if not (self.timing and end.timing):
            raise RuntimeError("an event without timing")
        if self.time is None or end.time is None:
            raise RuntimeError("an event not recorded yet")
        return end.time - self.time


def node_type(func) -> int:
    """The graph node type a recorded entry stands for."""
    if isinstance(getattr(func, "__self__", None), Event):
        return EVENT_RECORD
    packet = getattr(func, "overloadpacket", None)
    name = packet.__name__ if packet is not None else ""
    if name == "copy_":
        return MEMCPY
    if name in ("fill_", "zero_"):
        return MEMSET
    return KERNEL


class StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the recorded operators run
    again on replay, on the tensors of the capture, each moving the
    clock of ``cuda`` on."""

    def __init__(self, cuda=None, keep_graph=False):
        self.cuda = cuda
        self.keep_graph = keep_graph
        self.ops = None
        self.instantiated = False
        self.replays = 0
        self.collectives = 0

    @property
    def node_types(self) -> list:
        return [node_type(op[0]) for op in self.ops]

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            self.collectives += wait_works(res)
            write(out, res)
            if self.cuda is not None and not isinstance(
                    getattr(func, "__self__", None), Event):
                self.cuda.clock += self.cuda.node_ms


class Stream:
    def wait_stream(self, other):
        pass


class StandInCuda:
    """The CUDA runtime calls of ``ops/cuda_graph`` on the CPU, with a
    fake device clock (``clock`` ms, ``node_ms`` a replayed node)."""

    def __init__(self, node_ms: float = 1.0):
        self.made = []
        self.events = []
        self.clock = 0.0
        self.node_ms = node_ms
        self.recording = None

    def CUDAGraph(self, keep_graph=False):
        g = StandInGraph(self, keep_graph)
        self.made.append(g)
        return g

    def Event(self, enable_timing=False, blocking=False, interprocess=False,
              external=False):
        return Event(self, enable_timing, external)

    @staticmethod
    def graph_node_types(g) -> list:
        return g.node_types

    @contextlib.contextmanager
    def graph(self, g):
        self.recording = rec = Record()
        try:
            with rec:
                yield
        finally:
            self.recording = None
        g.ops = rec.ops

    def Stream(self, device=None):
        return Stream()

    def current_stream(self, device=None):
        return Stream()

    def stream(self, s):
        return contextlib.nullcontext()

    def synchronize(self, device=None):
        pass

    def empty_cache(self):
        pass

    def memory_reserved(self, device=None):
        return 0


@contextlib.contextmanager
def installed(cuda=None):
    """``cuda_graph._cuda`` replaced by ``cuda`` (default a new
    :class:`StandInCuda`) inside the block, which it yields."""
    cuda = StandInCuda() if cuda is None else cuda
    saved, cuda_graph._cuda = cuda_graph._cuda, cuda
    try:
        yield cuda
    finally:
        cuda_graph._cuda = saved
