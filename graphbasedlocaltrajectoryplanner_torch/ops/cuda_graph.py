"""A function captured as CUDA graphs, one per input signature — the port's
counterpart of ``jax.jit`` for the fleet tick (the JAX package's
``make_batched_tick`` returns ``jax.jit(tick)``) and for the device steps
of the facade's online handler (``planner/handler.OnlineHandler.steps``).

:func:`capture` turns ``fn(*args, **kwargs)`` into a callable of the same
signature.  The signature of a call is the shape, dtype and device of every
tensor reachable from its arguments (through dataclasses such as
``Scenario``, dicts, lists and tuples) together with every other value
there, ``None`` included.  The first call of a signature captures it:

1. static input buffers on the card receive the call's tensors;
2. ``fn`` runs once eagerly on them on a side stream (the warm-up), so that
   what must not happen under capture happens before it: the kernels'
   libraries are loaded (``cuda_build.load``), their one-time
   ``cudaFuncSetAttribute`` calls are made, lazily loaded modules come in
   and the caching allocator has its blocks;
3. ``fn`` runs once more under ``torch.cuda.graph`` into a new
   ``torch.cuda.CUDAGraph`` with its own memory pool;
4. the graph is replayed and its outputs returned, so a capture fault shows
   on the first call.

Every later call of that signature copies its tensors into the static
buffers, replays the graph on the current stream and returns clones of the
outputs: like ``jax.jit``, every call hands back fresh tensors, so a caller
may keep one call's outputs (a tick's ``vx_sqp`` as the next tick's
``sqp_x0``) while the next call runs.  Nothing falls back: a capture or a
replay that fails raises torch's error.

``fn`` may issue ``torch.distributed`` collectives on a group whose
collectives a stream capture can hold (NCCL; ``DistMesh.capturable``):
the warm-up runs them eagerly, which creates every group's communicator
before the capture begins (one created under capture fails), and the
graph holds them, so every rank of the group must capture and replay the
same signature at the same call.  The capture keeps CUDA's default
``global`` error mode for these callers too: eager NCCL collectives right
before a capture (the c10d watchdog querying their events) did not
invalidate it on torch 2.11 with NCCL 2.28.9.  gloo stages card tensors
through the host, which a capture refuses; such callers capture their
collective-free stages and run the collectives between the replays
(``parallel/scenario.compile_sharded_tick``).

``fn`` must be capture-safe: no host read of a device value (``item``,
``bool``, ``tolist``) and no tensor built from Python data on the card
(a pageable host-to-device copy waits for the stream).  :func:`as_tensor`
builds a scalar without that copy.  The Python code of ``fn`` runs only at
capture, so counters it keeps (the kernels' ``launches``) move at capture
and not on replay; the eager function stays reachable as ``__wrapped__``
(``functools.wraps``), as ``jax.jit(f).__wrapped__`` is ``f``, and inside
:func:`disabled` every captured callable runs it, as every jitted function
runs op by op inside ``jax.disable_jit()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import numbers
import time

import torch

# the CUDA runtime as the capture uses it (streams, graphs, the caching
# allocator); the CPU tests put stand-ins here
_cuda = torch.cuda
# the depth of nested disabled() blocks
_disabled = 0
# the depth of captures under way (see capturing())
_capturing = 0


@contextlib.contextmanager
def disabled():
    """Inside the block every captured callable calls its eager function
    and captures and replays nothing (the counterpart of
    ``jax.disable_jit()``): the kernels' launch counters and a recorder of
    their calls see every call, as they do on the CPU."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def capturing() -> bool:
    """Whether a capture is under way: one of :func:`capture`'s (also on
    the CPU stand-ins of the tests) or any other on the current CUDA
    stream.  Code that must not be captured (a host clock around a
    collective) raises on it."""
    return _capturing > 0 or (torch.cuda.is_available()
                              and torch.cuda.is_current_stream_capturing())


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor`` without a copy from the host for a Python
    number, which becomes a 0-dim fill on ``device`` (dtype inferred as
    ``torch.as_tensor`` infers it); a tensor converts as
    ``torch.as_tensor`` converts it."""
    if isinstance(x, numbers.Number):
        if hasattr(x, "dtype"):             # a numpy scalar
            if dtype is None:
                return torch.as_tensor(x, device=device)
            x = x.item()
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def const_vector(values, dtype, device) -> torch.Tensor:
    """A short vector of Python numbers built on ``device`` by fills (the
    most frequent value everywhere, then each other entry), without a copy
    from the host."""
    values = list(values)
    base = max(set(values), key=values.count)
    out = torch.full((len(values),), base, dtype=dtype, device=device)
    for i, v in enumerate(values):
        if v != base:
            out[i:i + 1].fill_(v)
    return out


def _flatten(x, tensors: list):
    """The hashable structure of ``x`` with every tensor leaf appended to
    ``tensors`` and described by shape, dtype and device."""
    if torch.is_tensor(x):
        tensors.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dataclass", type(x),
                tuple((f.name, _flatten(getattr(x, f.name), tensors))
                      for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(v, tensors))
                              for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, tensors) for v in x))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"capture: an argument of type {type(x).__name__} "
                        "is neither a tensor nor hashable") from None
    return ("value", type(x), x)


def _build(spec, tensors):
    """The structure ``spec`` of :func:`_flatten` with its tensor leaves
    taken in order from the iterator ``tensors``."""
    kind = spec[0]
    if kind == "tensor":
        return next(tensors)
    if kind == "dataclass":
        return spec[1](**{name: _build(s, tensors) for name, s in spec[2]})
    if kind == "dict":
        return {k: _build(s, tensors) for k, s in spec[1]}
    if kind in ("list", "tuple"):
        seq = [_build(s, tensors) for s in spec[1]]
        return seq if kind == "list" else tuple(seq)
    return spec[2]


class CapturedCall:
    """One signature's graph: its static inputs and outputs, and what the
    capture cost (``warmup_ms``, ``capture_ms`` on the host clock,
    ``pool_bytes`` the device memory the caching allocator reserved for
    the graph's pool)."""

    def __init__(self, fn, spec, tensors, device: torch.device):
        self.static_in = [torch.empty(t.shape, dtype=t.dtype, device=device)
                          for t in tensors]
        self._copy_in(tensors)
        args, kwargs = _build(spec, iter(self.static_in))
        cur = _cuda.current_stream(device)
        side = _cuda.Stream(device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with _cuda.stream(side):
            fn(*args, **kwargs)
        cur.wait_stream(side)
        _cuda.synchronize(device)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        gc.collect()
        _cuda.empty_cache()
        reserved = _cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = _cuda.CUDAGraph()
        global _capturing
        _capturing += 1
        try:
            with _cuda.graph(self.graph):
                out = fn(*args, **kwargs)
        finally:
            _capturing -= 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = _cuda.memory_reserved(device) - reserved
        self.static_out = []
        self.out_spec = _flatten(out, self.static_out)

    def _copy_in(self, tensors):
        for s, t in zip(self.static_in, tensors):
            s.copy_(t)

    def __call__(self, tensors):
        self._copy_in(tensors)
        self.graph.replay()
        return _build(self.out_spec, iter([t.clone()
                                           for t in self.static_out]))


def capture(fn, device=None):
    """``fn`` captured as one CUDA graph per input signature (see the
    module docstring).  The static buffers live on ``device`` (default the
    current CUDA device); tensors given on another device are copied there.
    The callable's ``graphs`` maps each signature to its
    :class:`CapturedCall`; ``__wrapped__`` is ``fn``, which every call
    inside :func:`disabled` runs instead."""
    device = torch.device("cuda" if device is None else device)
    graphs = {}

    @functools.wraps(fn)
    def captured(*args, **kwargs):
        if _disabled:
            return fn(*args, **kwargs)
        tensors = []
        spec = _flatten((args, dict(sorted(kwargs.items()))), tensors)
        call = graphs.get(spec)
        if call is None:
            call = CapturedCall(fn, spec, tensors, device)
            graphs[spec] = call
        return call(tensors)

    captured.graphs = graphs
    return captured


def capture_on_card(fn, device, kernels: bool = True):
    """The port's rule for its compiled calls: ``fn`` captured
    (:func:`capture`) on a CUDA ``device`` with the kernels, ``fn`` itself
    on the CPU and on the plain path (whose velocity scan reads the host,
    which a capture refuses)."""
    if torch.device(device).type == "cuda" and kernels:
        return capture(fn, device)
    return fn


def eager(fn):
    """The eager function behind a captured one (``__wrapped__``), or
    ``fn`` itself when it was not captured (the CPU, the plain path)."""
    return getattr(fn, "__wrapped__", fn)
