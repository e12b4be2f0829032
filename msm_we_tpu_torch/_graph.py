"""One CUDA graph a step: the port's counterpart of ``jax.jit`` for the hot
step and ``entry()``.

``run(eager, graphed, *args)`` calls ``eager(*args)`` when no tensor among
``args`` lies on a CUDA device: the CPU route has no graph. Otherwise the
first call with a new key warms up on a side stream with ``eager(*args)``
(that builds the kernel library and cuBLAS's workspace, neither of which
may happen inside a capture), captures ``graphed(*args)`` into a
``torch.cuda.CUDAGraph`` on the same stream, and replays it; later calls
with the same key only replay. ``graphed`` is ``eager`` with
:func:`steady_state_conditional` as its steady-state tail: the same kernels
at the same shapes (one kernel for the tail of a CUDA f32 flux matrix of at
most ``ops.steady_tail.S_MAX`` states, else the tail's extra squarings as
conditional nodes, in float64 for a larger f32 matrix).

* The key is ``graphed`` itself plus every leaf of ``args``: a tensor by
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
  records launches and counts none (``ops.stratified_assign``), so a
  replay's launches show only in a trace of it (``torch.profiler``).
* A capture that fails raises; nothing falls back to eager launches.

Tracing (``tracing.py``). While a ``tracing.collect()`` block is open or a
``torch.profiler`` records, a run opens three spans: ``graph.lookup``
(from :func:`run`'s entry: the device check, flattening, key, finding or
capturing the entry, and under ``collect()`` the collector's read of the
last traced replay), ``graph.launch`` (``graph.replay()`` in its device
context) and ``graph.copy_out`` (the output clones and the unflatten).
Under ``collect()`` the step replays its traced graph, a capture of its
own (``graph_key(..., traced=True)``): the same kernels, with timing
events recorded as event nodes at the graph's start, where the
steady-state tail begins and at its end, and a device ``int32`` counter of
the tail's extra rounds (the tail kernel adds the rounds it took; on the
PyTorch route each conditional round adds one). The block's collector reads
each replay's two intervals, ``device_ms["assign_flux"]`` and
``device_ms["tail"]``, before the next traced replay overwrites them, and
counts the replays whose tail took the kernel, ``counts["tail_fused"]``,
those whose tail took the float64 route (an f32 flux matrix of more
than ``S_MAX`` states, ``ops.steady_tail.tail_dtype``),
``counts["tail_f64"]``, and those whose ``two_transform`` assignment
scored bin-grouped (``entry.grouped_route``), ``counts["assign_grouped"]``;
it reads the counter, ``counts["tail_rounds"]``, once when the block
closes.
With neither on, a run opens no span: it reads one count and the
profiler's flag in :func:`run` and again in ``GraphCache.run``.

Why two forms of the PyTorch tail (the route above ``S_MAX`` states, for
other dtypes and on the CPU): a conditional node exists only in a graph, and
the eager and CPU routes may not read the device, so they keep every round
and let a ``torch.where`` on the flag discard it
(``step.steady_state_from_flux``). Inside a capture ``with
conditional(flag):`` makes the work of its block an IF node of the graph:
captured into a graph of its own on a second stream and run at replay
only where the 0-dim bool tensor ``flag`` holds (``csrc/graph_if.cu``), the
counterpart of the JAX package's ``lax.while_loop``.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager

import torch
from torch.utils import _pytree as pytree

from . import step, tracing
from .ops import steady_tail
from .ops._ext import check, library

__all__ = ["CACHE_SIZE", "GraphCache", "assign_grouped", "conditional",
           "conditional_rounds", "graph_key", "run", "steady_state_conditional"]

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


class _Captured:
    """A captured graph and its static outputs (``bodies``: the graphs of
    its conditional nodes, kept with it). A traced graph also holds its
    three timing events (``marks``: start, tail, end), its round counter
    (``rounds``), whether its tail is the tail kernel (``fused``), whether
    it runs in float64 for an f32 flux matrix (``f64``) and whether its
    assignment scored bin-grouped (``grouped``), and is a traced source of
    ``tracing.Collector``."""

    def __init__(self, graph, device, outputs, spec, bodies, marks=None,
                 rounds=None, fused=False, f64=False, grouped=False):
        self.graph = graph
        self.device = device
        self.outputs = outputs
        self.spec = spec
        self.bodies = bodies
        self.marks = marks
        self.rounds = rounds
        self.fused = fused
        self.f64 = f64
        self.grouped = grouped

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
            self.rounds.zero_()

    def read(self, col):
        start, tail, end = self.marks
        end.synchronize()
        col.device_ms.setdefault("assign_flux", []).append(start.elapsed_time(tail))
        col.device_ms.setdefault("tail", []).append(tail.elapsed_time(end))
        col.counts["tail_fused"] = col.counts.get("tail_fused", 0) + int(self.fused)
        col.counts["tail_f64"] = col.counts.get("tail_f64", 0) + int(self.f64)
        col.counts["assign_grouped"] = (col.counts.get("assign_grouped", 0)
                                        + int(self.grouped))

    def close(self, col):
        col.counts["tail_rounds"] = col.counts.get("tail_rounds", 0) + int(self.rounds)


class _Capture:
    """What :func:`conditional` and the tail need of the capture under way
    (``marks`` and ``rounds``: a traced capture's events and counter;
    ``fused``: set where the tail took the tail kernel; ``f64``: where it
    took the float64 route; ``grouped``: where the assignment scored
    bin-grouped)."""

    def __init__(self, stream, marks=None, rounds=None):
        self.stream = stream
        self.body_stream = torch.cuda.Stream()
        self.bodies = []
        self.marks = marks
        self.rounds = rounds
        self.fused = False
        self.f64 = False
        self.grouped = False


def assign_grouped():
    """Marks the capture under way, if any, as a step whose assignment
    scored bin-grouped (``entry.grouped_route``): its traced replays count
    in ``counts["assign_grouped"]``."""
    cap = getattr(_local, "capture", None)
    if cap is not None:
        cap.grouped = True


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
    cap = getattr(_local, "capture", None)
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


def conditional_rounds(Tn, p, residual, T, tol, n_rounds):
    """``step._where_rounds`` inside a capture: each round is a conditional
    node on ``residual > tol`` (so a round after convergence launches no
    more than the flag's kernels) and writes its result into the tail's own
    ``Tn``, ``p`` and ``residual``, whose addresses the rest of the graph
    reads. A traced capture's rounds also add one to its counter."""
    cap = getattr(_local, "capture", None)
    counter = cap.rounds if cap is not None else None
    for _ in range(n_rounds):
        with conditional(residual > tol):
            if counter is not None:
                counter.add_(1)
            Tc = step._square(Tn)
            pc, rc = step._stationary(Tc, T)
            Tn.copy_(Tc)
            p.copy_(pc)
            residual.copy_(rc)
    return Tn, p, residual


def steady_state_conditional(fm, basis_mask, target_mask, n_iters=512,
                             tol=1e-6, max_extra_squarings=16):
    """``step.steady_state_from_flux`` for a capture by :func:`capture`: the
    tail kernel where ``ops.steady_tail.uses_kernel`` takes it (one kernel
    node, its loop inside; a traced capture hands it the round counter),
    else the extra squarings as conditional nodes
    (:func:`conditional_rounds`), in ``ops.steady_tail.tail_dtype``: the
    same result as the eager route, and a round after convergence costs no
    squaring. A traced capture records its tail event here, right before
    the tail's first launch."""
    cap = getattr(_local, "capture", None)
    if cap is not None and cap.marks is not None:
        cap.marks[1].record(cap.stream)
    if steady_tail.uses_kernel(fm.device, fm.dtype, fm.shape[0]):
        if cap is not None:
            cap.fused = True
        return steady_tail.steady_tail(
            fm, basis_mask, target_mask, n_iters, tol, max_extra_squarings,
            counter=None if cap is None else cap.rounds)[:4]
    if cap is not None:
        cap.f64 = steady_tail.tail_dtype(fm.dtype, fm.shape[0]) != fm.dtype
    return step._steady_state(fm, basis_mask, target_mask, n_iters, tol,
                              max_extra_squarings, conditional_rounds)


def capture(eager, graphed, args, device, traced=False):
    """Warm ``eager(*args)`` up on a side stream of ``device``, then capture
    ``graphed(*args)`` into a CUDA graph on that stream. Returns the
    captured step; ``traced`` adds the timing events and the round counter
    (the module's docstring: ``graphed`` must end in
    :func:`steady_state_conditional`, which marks where its tail starts)."""
    _check_precision()
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager(*args)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        marks = rounds = None
        if traced:
            marks = [torch.cuda.Event(enable_timing=True, external=True)
                     for _ in range(3)]
            rounds = torch.zeros((), dtype=torch.int32, device=device)
        cap = _local.capture = _Capture(stream, marks, rounds)
        try:
            with torch.cuda.graph(graph, stream=stream):
                if traced:
                    marks[0].record(stream)
                out = graphed(*args)
                if traced:
                    marks[2].record(stream)
        finally:
            _local.capture = None
    outputs, spec = pytree.tree_flatten(out)
    return _Captured(graph, device, outputs, spec, cap.bodies, marks, rounds,
                     cap.fused, cap.f64, cap.grouped)


class GraphCache:
    """Captured steps by :func:`graph_key`, at most ``CACHE_SIZE`` of them.
    ``capture(eager, graphed, args, device, traced)`` makes an entry with a
    ``replay()`` method, and with ``traced=True`` a traced entry, a source
    of ``tracing.Collector``; with tracing on, an entry's ``launch()`` and
    ``copy_out()`` run in turn instead (:func:`capture`; a test may pass
    another)."""

    def __init__(self, capture=capture):
        self._capture = capture
        self._entries = OrderedDict()  # key -> (entry, finalizers)
        self._lock = threading.RLock()

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def run(self, eager, graphed, *args):
        """Replay the entry of ``graphed`` over ``args``, capturing it first
        where there is none (on the device of the first tensor); with
        tracing on, under the module's spans."""
        if tracing.active():
            return self.run_spanned(eager, graphed, args)
        return self._lookup(eager, graphed, args, False).replay()

    def run_spanned(self, eager, graphed, args, check_device=False):
        """:meth:`run` under the spans ``graph.lookup`` (from this call to
        the entry; under ``collect()`` the entry is the traced graph, and
        the collector reads what the last traced replay left first),
        ``graph.launch`` and ``graph.copy_out``. With ``check_device``,
        ``eager(*args)`` runs instead where no tensor among ``args`` lies on
        a CUDA device (:func:`run`'s check, inside the lookup's span)."""
        col = tracing.collector()
        with tracing.span("graph.lookup"):
            entry = None
            if not check_device or _on_cuda(args):
                entry = self._lookup(eager, graphed, args, col is not None)
                if col is not None:
                    col.using(entry)
        if entry is None:
            return eager(*args)
        with tracing.span("graph.launch"):
            entry.launch()
        with tracing.span("graph.copy_out"):
            return entry.copy_out()

    def _lookup(self, eager, graphed, args, traced):
        leaves = pytree.tree_leaves(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = graph_key(graphed, leaves, traced)
        with self._lock:
            item = self._entries.get(key)
            if item is not None:
                self._entries.move_to_end(key)
        if item is not None:
            return item[0]
        entry = self._capture(eager, graphed, args, tensors[0].device,
                              traced=traced)
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


def _on_cuda(args):
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in pytree.tree_leaves(args))


def run(eager, graphed, *args):
    """``eager(*args)`` where no tensor among ``args`` lies on a CUDA
    device, else a replay of the CUDA graph of ``graphed(*args)`` (captured
    at the first call with a new key). With tracing on, the span
    ``graph.lookup`` starts here (on the CPU route it holds the check
    alone)."""
    if tracing.active():
        return _CACHE.run_spanned(eager, graphed, args, check_device=True)
    if not _on_cuda(args):
        return eager(*args)
    return _CACHE.run(eager, graphed, *args)
