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
   ``torch.cuda.CUDAGraph`` with its own memory pool, kept after the
   capture (``keep_graph=True``) so that its nodes are counted before it
   is instantiated;
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

Measurement.  The tick's stages open :func:`span` ranges (the ``gltpl.*``
names of ``parallel/profiling.py``), which a replay does not show to the
profiler: it runs neither their Python nor their launch calls.  Inside
:func:`tracing` a call files its signature apart from the untraced one and
captures a graph of its own, in which each span's entry and exit and the
graph's first and last node record a timing event (event-record nodes of
the graph); ``report()`` reads the last replay's device ms by span from
them, and the call's copy-in, replay, clone-out, warm-up and capture run
inside host spans ``gltpl.call.*`` for the profiler.  Outside it the
graph is the untraced one, node for node, and a replay tests one flag.
Counters are always on: ``captures``, ``replays`` and ``eager_calls`` of a
captured callable, and each graph's nodes by type, read once at capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import numbers
import time

import torch
from torch.profiler import record_function

# the graph node types that the counters name (CUDA's graph node type
# numbers); every other type counts as "other"
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 7: "event_record"}


def graph_node_types(graph) -> list:
    """The type number of every node of a captured ``torch.cuda.CUDAGraph``
    that keeps its graph (``keep_graph=True``), read with the CUDA
    driver's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _driver(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)),
            "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _driver(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
            "cuGraphGetNodes")
    kind = ctypes.c_int(0)
    out = []
    for node in nodes[:n.value]:
        _driver(lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)),
                "cuGraphNodeGetType")
        out.append(kind.value)
    return out


def _driver(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA driver error {rc}")


class _Runtime:
    """``torch.cuda`` and the graph node query: the CUDA runtime as the
    capture uses it."""

    def __getattr__(self, name):
        return getattr(torch.cuda, name)

    graph_node_types = staticmethod(graph_node_types)


# the CUDA runtime as the capture uses it (streams, graphs, events, the
# caching allocator, the graph node query); the CPU tests put stand-ins here
_cuda = _Runtime()
# the depth of nested disabled() blocks
_disabled = 0
# the depth of captures under way (see capturing())
_capturing = 0
# the depth of nested tracing() blocks
_tracing = 0
# the traced CapturedCall whose capture is under way: its spans record
# events
_recording = None


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


@contextlib.contextmanager
def tracing():
    """Inside the block every captured callable runs the traced graph of
    the call's signature (captured at its first traced call): the spans'
    and the graph's timing events are nodes of it, and the call's host
    work runs inside ``gltpl.call.*`` spans.  Outside it the untraced
    graphs run as they were captured."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


class _Span:
    """A ``record_function`` range that, in a traced capture, also
    records a timing event at its entry and its exit."""

    def __init__(self, name: str):
        self.name = name
        self.range = record_function(name)
        self.call = self.index = None

    def __enter__(self):
        self.range.__enter__()
        self.call = _recording
        if self.call is not None:
            self.index = self.call._open(self.name)
        return self

    def __exit__(self, *exc):
        if self.call is not None:
            self.call._close(self.index)
        return self.range.__exit__(*exc)


def span(name: str):
    """The range ``name`` around a stage of a captured body: the
    profiler's ``record_function`` range, and inside :func:`tracing`, while
    a graph is captured, a pair of timing events in the graph too (see
    ``CapturedCall.report``)."""
    if not _tracing:
        return record_function(name)
    return _Span(name)


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
    """One signature's graph: its static inputs and outputs, what the
    capture cost (``warmup_ms``, ``capture_ms`` on the host clock,
    ``pool_bytes`` the device memory the caching allocator reserved for
    the graph's pool), its nodes by type (``nodes``, ``kernel_nodes``) and
    its ``replays``.  A ``traced`` graph (captured inside :func:`tracing`)
    holds the timing events of its spans (``spans``: name, the index of
    the enclosing span or None, entry and exit event, in capture order)
    and of its first and last node (``bounds``)."""

    def __init__(self, fn, spec, tensors, device: torch.device,
                 traced: bool = False, n: int = 0):
        self.traced = traced
        self.replays = 0
        self.spans, self.bounds, self._open_spans = [], None, []
        self.static_in = [torch.empty(t.shape, dtype=t.dtype, device=device)
                          for t in tensors]
        self._copy_in(tensors)
        args, kwargs = _build(spec, iter(self.static_in))
        cur = _cuda.current_stream(device)
        side = _cuda.Stream(device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with self._host("gltpl.call.warmup", n), _cuda.stream(side):
            fn(*args, **kwargs)
        cur.wait_stream(side)
        _cuda.synchronize(device)
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        gc.collect()
        _cuda.empty_cache()
        reserved = _cuda.memory_reserved(device)
        t0 = time.perf_counter()
        # the graph is kept after capture, for its node count
        self.graph = _cuda.CUDAGraph(keep_graph=True)
        global _capturing, _recording
        _capturing += 1
        outer, _recording = _recording, (self if traced else None)
        try:
            with self._host("gltpl.call.capture", n), \
                    _cuda.graph(self.graph):
                if traced:
                    self.bounds = (self._event(), None)
                out = fn(*args, **kwargs)
                if traced:
                    self.bounds = (self.bounds[0], self._event())
        finally:
            _capturing -= 1
            _recording = outer
        types = _cuda.graph_node_types(self.graph)
        self.graph.instantiate()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = _cuda.memory_reserved(device) - reserved
        self.nodes = dict.fromkeys(("kernel", "memcpy", "memset",
                                    "event_record", "other"), 0)
        for t in types:
            self.nodes[NODE_TYPES.get(t, "other")] += 1
        self.kernel_nodes = self.nodes["kernel"]
        self.static_out = []
        self.out_spec = _flatten(out, self.static_out)

    def _host(self, name: str, n: int):
        """The host span ``name`` of call ``n`` in a traced graph."""
        if self.traced:
            return record_function(name, str(n))
        return contextlib.nullcontext()

    @staticmethod
    def _event():
        ev = _cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    def _open(self, name: str) -> int:
        parent = self._open_spans[-1] if self._open_spans else None
        self.spans.append([name, parent, self._event(), None])
        self._open_spans.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def _close(self, index: int) -> None:
        self.spans[index][3] = self._event()
        self._open_spans.pop()

    def _copy_in(self, tensors):
        for s, t in zip(self.static_in, tensors):
            s.copy_(t)

    def _clone_out(self):
        return _build(self.out_spec, iter([t.clone()
                                           for t in self.static_out]))

    def __call__(self, tensors, n: int = 0):
        self.replays += 1
        if not self.traced:
            self._copy_in(tensors)
            self.graph.replay()
            return self._clone_out()
        arg = str(n)
        with record_function("gltpl.call.copy_in", arg):
            self._copy_in(tensors)
        with record_function("gltpl.call.replay", arg):
            self.graph.replay()
        with record_function("gltpl.call.clone_out", arg):
            return self._clone_out()

    def report(self) -> dict:
        """What this graph cost and holds, and for a traced graph the
        device ms of its last replay: ``ranges`` (per span name its
        inclusive ms summed over its occurrences, the name of the span
        around its first occurrence or None, and its count), ``graph_ms``
        (first node to last) and ``other_ms`` (``graph_ms`` less the
        outermost spans).  Read after the stream has synchronised: the
        reading itself never waits for the device."""
        rep = dict(traced=self.traced, replays=self.replays,
                   warmup_ms=self.warmup_ms, capture_ms=self.capture_ms,
                   pool_bytes=self.pool_bytes,
                   kernel_nodes=self.kernel_nodes, nodes=dict(self.nodes))
        if not (self.traced and self.replays):
            return rep
        ranges, outer = {}, 0.0
        for name, parent, a, b in self.spans:
            ms = a.elapsed_time(b)
            r = ranges.setdefault(name, dict(
                ms=0.0, count=0,
                parent=None if parent is None else self.spans[parent][0]))
            r["ms"] += ms
            r["count"] += 1
            outer += ms if parent is None else 0.0
        graph_ms = self.bounds[0].elapsed_time(self.bounds[1])
        rep.update(ranges=ranges, graph_ms=graph_ms,
                   other_ms=graph_ms - outer)
        return rep


def capture(fn, device=None):
    """``fn`` captured as one CUDA graph per input signature (see the
    module docstring).  The static buffers live on ``device`` (default the
    current CUDA device); tensors given on another device are copied there.
    The callable's ``graphs`` maps each signature and whether it is traced
    (:func:`tracing`) to its :class:`CapturedCall`; ``__wrapped__`` is
    ``fn``, which every call inside :func:`disabled` runs instead.  Its
    counters: ``captures``, ``replays`` (every call outside
    :func:`disabled`, the capturing calls included) and ``eager_calls``
    (the calls inside it); ``report()`` gives them with every graph's
    :meth:`CapturedCall.report`, in capture order."""
    device = torch.device("cuda" if device is None else device)
    graphs = {}

    @functools.wraps(fn)
    def captured(*args, **kwargs):
        if _disabled:
            captured.eager_calls += 1
            return fn(*args, **kwargs)
        captured.replays += 1
        tensors = []
        spec = _flatten((args, dict(sorted(kwargs.items()))), tensors)
        key = (spec, _tracing > 0)
        call = graphs.get(key)
        if call is None:
            call = CapturedCall(fn, spec, tensors, device, key[1],
                                captured.replays)
            graphs[key] = call
            captured.captures += 1
        return call(tensors, captured.replays)

    def report() -> dict:
        return dict(captures=captured.captures, replays=captured.replays,
                    eager_calls=captured.eager_calls,
                    graphs=[c.report() for c in graphs.values()])

    captured.graphs = graphs
    captured.captures = captured.replays = captured.eager_calls = 0
    captured.report = report
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
