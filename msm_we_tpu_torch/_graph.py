"""One CUDA graph a step: the port's counterpart of ``jax.jit`` for the hot
step and ``entry()``.

``run(eager, graphed, *args)`` calls ``eager(*args)`` when no tensor among
``args`` lies on a CUDA device: the CPU route has no graph. Otherwise the
first call with a new key warms up on a side stream with ``eager(*args)``
(that builds the kernel library and cuBLAS's workspace, neither of which
may happen inside a capture), captures ``graphed(*args)`` into a
``torch.cuda.CUDAGraph`` on the same stream, and replays it; later calls
with the same key only replay. ``graphed`` is ``eager`` with the
steady-state tail's extra squarings as conditional nodes
(:func:`steady_state_conditional`): the same kernels at the same shapes.

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

Why two forms of the tail: a conditional node exists only in a graph, and
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

from . import step
from .ops._ext import check, library

__all__ = ["CACHE_SIZE", "GraphCache", "conditional", "conditional_rounds",
           "graph_key", "run", "steady_state_conditional"]

CACHE_SIZE = 4
_local = threading.local()  # .capture: the _Capture under way in this thread


def graph_key(fn, leaves):
    """The cache key of ``fn`` over the flattened arguments ``leaves``."""
    key = [fn]
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
    its conditional nodes, kept with it)."""

    def __init__(self, graph, device, outputs, spec, bodies):
        self.graph = graph
        self.device = device
        self.outputs = outputs
        self.spec = spec
        self.bodies = bodies

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
            outs = [x.clone() if isinstance(x, torch.Tensor) else x
                    for x in self.outputs]
        return pytree.tree_unflatten(outs, self.spec)


class _Capture:
    """What :func:`conditional` needs of the capture under way."""

    def __init__(self, stream):
        self.stream = stream
        self.body_stream = torch.cuda.Stream()
        self.bodies = []


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
    reads."""
    for _ in range(n_rounds):
        with conditional(residual > tol):
            Tc = step._square(Tn)
            pc, rc = step._stationary(Tc, T)
            Tn.copy_(Tc)
            p.copy_(pc)
            residual.copy_(rc)
    return Tn, p, residual


def steady_state_conditional(fm, basis_mask, target_mask, n_iters=512,
                             tol=1e-6, max_extra_squarings=16):
    """``step.steady_state_from_flux`` for a capture by :func:`capture`,
    its extra squarings as conditional nodes (:func:`conditional_rounds`):
    the same result, and a round after convergence costs no squaring."""
    return step._steady_state(fm, basis_mask, target_mask, n_iters, tol,
                              max_extra_squarings, conditional_rounds)


def capture(eager, graphed, args, device):
    """Warm ``eager(*args)`` up on a side stream of ``device``, then capture
    ``graphed(*args)`` into a CUDA graph on that stream. Returns the
    captured step."""
    _check_precision()
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            eager(*args)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        cap = _local.capture = _Capture(stream)
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = graphed(*args)
        finally:
            _local.capture = None
    outputs, spec = pytree.tree_flatten(out)
    return _Captured(graph, device, outputs, spec, cap.bodies)


class GraphCache:
    """Captured steps by :func:`graph_key`, at most ``CACHE_SIZE`` of them.
    ``capture(eager, graphed, args, device)`` makes an entry with a ``replay()``
    method (:func:`capture`; a test may pass another)."""

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
        where there is none (on the device of the first tensor)."""
        leaves = pytree.tree_leaves(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = graph_key(graphed, leaves)
        with self._lock:
            item = self._entries.get(key)
            if item is not None:
                self._entries.move_to_end(key)
        if item is None:
            entry = self._capture(eager, graphed, args, tensors[0].device)
            self._insert(key, entry, tensors)
        else:
            entry = item[0]
        return entry.replay()

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


def run(eager, graphed, *args):
    """``eager(*args)`` where no tensor among ``args`` lies on a CUDA
    device, else a replay of the CUDA graph of ``graphed(*args)`` (captured
    at the first call with a new key)."""
    if not any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in pytree.tree_leaves(args)):
        return eager(*args)
    return _CACHE.run(eager, graphed, *args)
