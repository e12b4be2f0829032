"""One CUDA graph a step: the port's counterpart of ``jax.jit`` for the hot
step and ``entry()``.

``run(fn, *args)`` calls ``fn(*args)`` when no tensor among ``args`` lies
on a CUDA device: the CPU route has no graph. Otherwise the first call
with a new key warms up on a side stream with ``fn(*args)``, outside any
capture (that builds the kernel library and cuBLAS's workspace, neither of
which may happen inside a capture), captures ``fn(*args)`` into a
``torch.cuda.CUDAGraph`` on the same stream, and replays it; later calls
with the same key only replay. ``fn`` may take another form inside the
capture by asking :func:`capturing` (the steady-state tail of ``step.py``
takes its extra rounds as conditional nodes there, as ``torch.where``
rounds outside one): the same kernels at the same shapes.

* The key is ``fn`` itself plus every leaf of ``args``: a tensor by
  ``(data_ptr, shape, stride, dtype, device)``, anything else by value. A
  replay reads the inputs' memory as it is at replay time, so new values
  written into the same tensors are seen, as by a jitted function of
  buffers. A new key captures anew.
* At most ``CACHE_SIZE`` graphs are kept, the least recently used dropped
  first, and a graph is dropped as soon as one of its input tensors is
  freed (its replay would read freed memory).
* The outputs are copied out after every replay, so the next replay does
  not overwrite what a caller holds.
* The kernel wrappers count the launches of the warm-up; a capture only
  records launches and counts none (``ops._ext._count_launch``), so a
  replay's launches show only in a trace of it (``torch.profiler``).
* A capture that fails raises; nothing falls back to eager launches.

Conditional nodes. A conditional node exists only in a graph: inside a
capture ``with conditional(flag):`` makes the work of its block an IF node
of the graph, captured into a graph of its own on a second stream and run
at replay only where the 0-dim bool tensor ``flag`` holds
(``csrc/graph_if.cu``), the counterpart of the JAX package's
``lax.while_loop``.

Tracing (``tracing.py``). While a ``tracing.collect()`` block is open or a
``torch.profiler`` records, a run opens three spans: ``graph.lookup``
(from :func:`run`'s entry: flattening, the device check, key, finding or
capturing the entry, and under ``collect()`` the collector's read of the
last traced replay), ``graph.launch`` (``graph.replay()`` in its device
context) and ``graph.copy_out`` (the output clones and the unflatten); on
the CPU route only ``graph.lookup`` opens. With neither on, a run opens no
span: it reads one count and the profiler's flag once. Under ``collect()``
the step replays its traced graph, a capture of its own
(``graph_key(..., traced=True)``). Three hooks let the step describe
itself to it; outside a capture they do nothing:

* :func:`mark` ``(name)`` records an event node where it is called; the
  device interval from there to the next mark, or to the graph's end, goes
  to ``device_ms[name]`` once a traced replay;
* :func:`count` ``(name, n)`` adds ``n`` to ``counts[name]`` once a traced
  replay (a route the capture took);
* :func:`counter` ``(name)`` is the traced capture's one 0-dim ``int32``
  device counter, which the graph's kernels add to (``None`` outside a
  traced capture), zeroed at the block's first replay and read into
  ``counts[name]`` when the block closes. It is allocated before the
  capture: a tensor allocated inside one may share memory with an
  intermediate that an earlier node of the graph writes at every replay.

The block's collector reads each replay's intervals and counts before the
next traced replay overwrites them. The hot step names them:
``device_ms["assign_flux"]`` and ``device_ms["tail"]`` (``entry.py``,
``step.steady_state_from_flux``), ``counts["tail_fused"]``,
``counts["tail_f64"]``, ``counts["tail_rounds"]`` (the tail) and
``counts["assign_grouped"]`` (``entry.py``).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager, nullcontext

import torch
from torch.utils import _pytree as pytree

from . import tracing
from .ops._ext import check, library

__all__ = ["CACHE_SIZE", "GraphCache", "capture", "capturing", "conditional",
           "count", "counter", "graph_key", "mark", "run"]

CACHE_SIZE = 4
_local = threading.local()  # .capture: the _Capture under way in this thread


def graph_key(fn, leaves, traced=False):
    """The cache key of ``fn`` over the flattened arguments ``leaves``
    (``traced``: the traced graph's, never the plain graph's)."""
    key = [fn, traced]
    for x in leaves:
        if isinstance(x, torch.Tensor):
            key.append((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                        x.device))
        else:
            hash(x)  # a value that cannot key a graph raises here
            key.append((type(x), x))
    return tuple(key)


class _Capture:
    """A step as :func:`capture` captures it, then its graph. While the
    capture runs, the hooks add to it: ``bodies`` (the graphs of its
    conditional nodes, kept with it), ``counts`` (name -> per replay), and
    in a traced capture ``marks`` (``(name, event)`` in graph order) and
    the name of its ``counter``. A traced capture, with its ``end`` event,
    is a traced source of ``tracing.Collector``."""

    def __init__(self, device, traced=False):
        self.device = device
        self.traced = traced
        self.stream = self.body_stream = None
        self.bodies = []
        self.marks = []
        self.end = None
        self.counts = {}
        self.counter = self.counter_name = None
        self.graph = self.outputs = self.spec = None

    def launch(self):
        with torch.cuda.device(self.device):
            self.graph.replay()

    def copy_out(self):
        outs = [x.clone() if isinstance(x, torch.Tensor) else x
                for x in self.outputs]
        return pytree.tree_unflatten(outs, self.spec)

    def replay(self):
        self.launch()
        return self.copy_out()

    def open(self, col):
        with torch.cuda.device(self.device):
            self.counter.zero_()

    def read(self, col):
        self.end.synchronize()
        ends = [e for _name, e in self.marks[1:]] + [self.end]
        for (name, start), end in zip(self.marks, ends):
            col.device_ms.setdefault(name, []).append(start.elapsed_time(end))
        for name, n in self.counts.items():
            col.counts[name] = col.counts.get(name, 0) + n

    def close(self, col):
        name = self.counter_name
        if name is not None:
            col.counts[name] = col.counts.get(name, 0) + int(self.counter)


def _under_way():
    return getattr(_local, "capture", None)


def capturing():
    """Whether a capture by :func:`capture` is under way in this thread
    (host state: no device read)."""
    return _under_way() is not None


def _event():
    return torch.cuda.Event(enable_timing=True, external=True)


def mark(name):
    """In a traced capture: an event node here, opening the interval
    ``device_ms[name]`` (to the next mark or the graph's end)."""
    cap = _under_way()
    if cap is not None and cap.traced:
        cap.marks.append((name, _event()))
        cap.marks[-1][1].record(cap.stream)


def count(name, n):
    """In a capture: each traced replay adds ``n`` to ``counts[name]``."""
    cap = _under_way()
    if cap is not None:
        cap.counts[name] = cap.counts.get(name, 0) + int(n)


def counter(name):
    """In a traced capture: its 0-dim ``int32`` device counter, read into
    ``counts[name]``; else ``None``. A capture holds one counter, under one
    name."""
    cap = _under_way()
    if cap is None or cap.counter is None:
        return None
    if cap.counter_name not in (None, name):
        raise ValueError(f"the capture counts {cap.counter_name!r}, not {name!r}")
    cap.counter_name = name
    return cap.counter


def _check_precision():
    # A graph freezes the products as captured: keep _device.py's IEEE f32
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matrix products are enabled; the port's f32 products must "
            "stay IEEE (msm_we_tpu_torch/_device.py) before a step is captured"
        )


@contextmanager
def conditional(flag):
    """Inside a :func:`capture`: the block's work becomes an IF node on the
    0-dim bool CUDA tensor ``flag``. The block is captured into a graph of
    its own on a second stream, in a memory pool that the conditional
    bodies of the capture share (their captures follow one another), and
    may read and write only tensors that outlive it. At replay the block
    runs where ``flag`` holds and launches nothing where it does not."""
    cap = _under_way()
    if cap is None:
        raise RuntimeError("conditional() needs a capture by _graph.capture")
    body = torch.cuda.CUDAGraph(keep_graph=True)
    pool = cap.bodies[0].pool() if cap.bodies else None
    with torch.cuda.stream(cap.body_stream):
        body.capture_begin(pool=pool)
        try:
            yield
        finally:
            body.capture_end()
    cap.bodies.append(body)
    check(library().msm_graph_add_if(flag.data_ptr(), body.raw_cuda_graph(),
                                     cap.stream.cuda_stream), "conditional node")


def capture(fn, args, device, traced=False):
    """Warm ``fn(*args)`` up on a side stream of ``device``, then capture
    it into a CUDA graph on that stream. Returns the captured step;
    ``traced`` adds the counter, what the hooks record and an event at its
    end."""
    _check_precision()
    cap = _Capture(device, traced)
    with torch.cuda.device(device):
        cap.stream = torch.cuda.Stream()
        cap.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(cap.stream):
            fn(*args)
        torch.cuda.current_stream().wait_stream(cap.stream)
        cap.body_stream = torch.cuda.Stream()
        if traced:
            cap.counter = torch.zeros((), dtype=torch.int32, device=device)
        cap.graph = torch.cuda.CUDAGraph()
        _local.capture = cap
        try:
            with torch.cuda.graph(cap.graph, stream=cap.stream):
                out = fn(*args)
                if traced:
                    cap.end = _event()
                    cap.end.record(cap.stream)
        finally:
            _local.capture = None
    cap.outputs, cap.spec = pytree.tree_flatten(out)
    return cap


class GraphCache:
    """Captured steps by :func:`graph_key`, at most ``CACHE_SIZE`` of them,
    for tensors on devices of ``device_type``. ``capture(fn, args, device,
    traced)`` makes an entry with ``launch()`` and ``copy_out()``, and with
    ``traced=True`` a traced entry, a source of ``tracing.Collector``
    (:func:`capture`; a test may pass another)."""

    def __init__(self, capture=capture, device_type="cuda"):
        self._capture = capture
        self._device_type = device_type
        self._entries = OrderedDict()  # key -> (entry, finalizers)
        self._lock = threading.RLock()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def run(self, fn, *args):
        """``fn(*args)`` where no tensor among ``args`` lies on a device of
        the cache's type, else a replay of the entry of ``fn`` over
        ``args``, captured first where there is none (on the device of the
        first tensor); with tracing on, under the module's spans (under
        ``collect()`` the entry is the traced graph, and the collector
        reads what the last traced replay left first)."""
        span = tracing.span if tracing.active() else nullcontext
        col = tracing.collector()
        with span("graph.lookup"):
            leaves = pytree.tree_leaves(args)
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            entry = None
            if any(t.device.type == self._device_type for t in tensors):
                entry = self._lookup(fn, args, leaves, tensors, col is not None)
                if col is not None:
                    col.using(entry)
        if entry is None:
            return fn(*args)
        with span("graph.launch"):
            entry.launch()
        with span("graph.copy_out"):
            return entry.copy_out()

    def _lookup(self, fn, args, leaves, tensors, traced):
        key = graph_key(fn, leaves, traced)
        with self._lock:
            item = self._entries.get(key)
            if item is not None:
                self._entries.move_to_end(key)
        if item is not None:
            return item[0]
        entry = self._capture(fn, args, tensors[0].device, traced=traced)
        self._insert(key, entry, tensors)
        return entry

    def _insert(self, key, entry, tensors):
        finalizers = []
        for t in tensors:
            f = weakref.finalize(t, self._drop, key)
            f.atexit = False
            finalizers.append(f)
        with self._lock:
            self._pop(key)
            self._entries[key] = (entry, finalizers)
            while len(self._entries) > CACHE_SIZE:
                self._pop(next(iter(self._entries)))

    def _pop(self, key):
        item = self._entries.pop(key, None)
        if item is not None:
            for f in item[1]:
                f.detach()

    def _drop(self, key):
        with self._lock:
            self._pop(key)


_CACHE = GraphCache()


def run(fn, *args):
    """``fn(*args)`` where no tensor among ``args`` lies on a CUDA device,
    else a replay of the CUDA graph of ``fn(*args)`` (captured at the first
    call with a new key): ``GraphCache.run`` of the module's cache."""
    return _CACHE.run(fn, *args)