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


class StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the recorded operators run
    again on replay, on the tensors of the capture."""

    def __init__(self):
        self.ops = None
        self.replays = 0
        self.collectives = 0

    def replay(self):
        self.replays += 1
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            self.collectives += wait_works(res)
            write(out, res)


class Stream:
    def wait_stream(self, other):
        pass


class StandInCuda:
    """The CUDA runtime calls of ``ops/cuda_graph`` on the CPU."""

    def __init__(self):
        self.made = []

    def CUDAGraph(self):
        g = StandInGraph()
        self.made.append(g)
        return g

    @contextlib.contextmanager
    def graph(self, g):
        rec = Record()
        with rec:
            yield
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
