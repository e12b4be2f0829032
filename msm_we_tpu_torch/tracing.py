"""Per-stage timing, spans and profiler traces of the port (counterpart of
``msm_we_tpu/tracing.py``: ``StageTimer``, ``live_stage_display`` and
``profile_trace``, here over ``torch.profiler``). rich is imported only
when the live display is enabled.

Spans. ``span(name)`` times a block of code anywhere in the port:
* inside a running :class:`StageTimer` stage of the same thread it is a
  sub-span of that stage (``StageTimer.spans``), always on;
* inside a :func:`collect` block of the same thread its seconds go to the
  block's :class:`Collector`;
* while a ``torch.profiler`` records, it (like every ``StageTimer`` stage)
  also opens a range of the same name (``_RecordFunctionFast``, a
  ``cpu_op`` event of the trace), so stages and spans sit on the trace's
  own clock, nested as they ran. The range is entered just before the
  timer's first clock read and left just after its last, and both edges
  are stamped in C: the two measure the same interval, and no Python
  work (nor a garbage collection it may set off) lies between them.
Where none of these holds, entering a span reads one module-level count
and the profiler's flag, and nothing else.

Counts. ``count(name, n)`` adds ``n`` to ``counts[name]`` of the thread's
innermost :func:`collect` block, and does nothing outside one.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import torch._C._profiler as _C_profiler
import torch.autograd.profiler as _profiler

from ._logging import log

__all__ = ["Collector", "StageTimer", "active", "collect", "collector", "count",
           "live_stage_display", "profile_trace", "span"]

# Open collect() blocks and running StageTimer stages, in every thread: a
# span with none of them and no profiler does nothing
_listeners = 0
_listeners_lock = threading.Lock()
_local = threading.local()  # .timer: StageTimer; .collector: Collector


def _listen(n):
    global _listeners
    with _listeners_lock:
        _listeners += n


def active():
    """Whether a span would record anything: a ``collect()`` block or a
    timer's stage is open somewhere, or a profiler records."""
    return bool(_listeners) or _profiler._is_profiler_enabled


def collector():
    """The :class:`Collector` of this thread's innermost ``collect()``
    block, or None."""
    return getattr(_local, "collector", None)


def count(name, n=1):
    """Add ``n`` to ``counts[name]`` of this thread's innermost ``collect()``
    block; nothing where none is open."""
    col = getattr(_local, "collector", None)
    if col is not None:
        col.counts[name] = col.counts.get(name, 0) + int(n)


def _open_range(name):
    """A profiler range of ``name``, entered, while a profiler records;
    else None."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _C_profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class span:
    """``with span(name):`` times its block (see the module's docstring);
    ``@span(name)`` times each call of the function it decorates."""

    __slots__ = ("name", "_t0", "_rf", "_timer", "_slot", "_col")

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return timed

    def __enter__(self):
        if not (_listeners or _profiler._is_profiler_enabled):
            return self
        self._timer = getattr(_local, "timer", None)
        if self._timer is not None:
            self._slot = self._timer._open_span(self.name)
        self._col = getattr(_local, "collector", None)
        self._rf = _open_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        elapsed = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._t0 = None
        if self._col is not None:
            self._col.add(self.name, elapsed)
        if self._timer is not None:
            self._timer._close_span(self._slot, elapsed)
        return False


class Collector:
    """What one :func:`collect` block recorded, read after the block.

    ``spans``: the host seconds of each span, by name, in order.
    ``device_ms``: device intervals by name, in milliseconds, one a run of
    a traced source (the hot step's traced CUDA graph, ``_graph.py``).
    ``counts``: counters by name: device counters summed over the block's
    runs, and the host's :func:`count`.

    A traced source has ``open(col)`` (called at its first run in the
    block), ``read(col)`` (called before any traced source runs again,
    and at the end of the block: what its last run left in device memory
    would be overwritten) and ``close(col)`` (called at the end of the
    block)."""

    def __init__(self):
        self.spans = {}
        self.device_ms = {}
        self.counts = {}
        self._sources = []
        self._last = None

    def add(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def using(self, source):
        """Before a run of the traced ``source``: read what the last run of a
        traced source left."""
        self._settle()
        if not any(s is source for s in self._sources):
            self._sources.append(source)
            source.open(self)
        self._last = source

    def _settle(self):
        if self._last is not None:
            self._last.read(self)
            self._last = None

    def close(self):
        self._settle()
        for s in self._sources:
            s.close(self)
        self._sources = []


@contextlib.contextmanager
def collect():
    """Turn on step tracing in this thread for the block: spans record into
    the yielded :class:`Collector`, and a CUDA graph step replays its traced
    form (``_graph.py``). Everything stays in memory."""
    col = Collector()
    prev = collector()
    _local.collector = col
    _listen(1)
    try:
        yield col
    finally:
        _listen(-1)
        _local.collector = prev
        col.close()


class StageTimer:
    """Collects named stage durations; renderable as text or JSON.

    ``on_change`` fires whenever a stage starts, finishes, or gains a note
    (the hook :func:`live_stage_display` uses to refresh its table).

    While a stage runs, each :func:`span` of its thread is a sub-span of it:
    ``spans`` holds ``(name, seconds, parent, stage)`` in the order they
    opened, where ``parent`` is the index in ``spans`` of the enclosing span
    (-1 where the stage itself encloses it) and ``stage`` the index in
    ``stages`` of the innermost running stage. Sub-spans stay out of
    ``stages``, ``total`` and ``report()``.
    """

    def __init__(self, on_change=None):
        self.stages = []  # list of (name, seconds, note)
        self.spans = []  # list of (name, seconds, parent, stage)
        self.failed = set()  # indices of stages that raised
        self.running = None  # index of the innermost running stage
        self._stack = []  # indices of nested running stages
        self._span_stack = []  # indices of this timer's open spans
        self._on_change = on_change

    def _notify(self):
        if self._on_change is not None:
            try:
                self._on_change()
            except Exception:  # noqa: BLE001 - a display must never kill a build
                log.debug("stage display update failed", exc_info=True)

    @contextlib.contextmanager
    def stage(self, name, note=""):
        self.stages.append((name, 0.0, note))
        idx = len(self.stages) - 1
        self._stack.append(idx)
        self.running = idx
        self._notify()
        prev = getattr(_local, "timer", None)
        _local.timer = self
        _listen(1)
        rf = _open_range(name)
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException:
            self.failed.add(idx)
            raise
        finally:
            elapsed = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            _listen(-1)
            _local.timer = prev
            n, _, note_now = self.stages[idx]
            self.stages[idx] = (n, elapsed, note_now)
            self._stack.pop()
            self.running = self._stack[-1] if self._stack else None
            self._notify()
            log.info(f"[stage] {name}: {elapsed:.3f}s {note_now}")

    def _open_span(self, name):
        parent = self._span_stack[-1] if self._span_stack else -1
        self.spans.append((name, 0.0, parent, self.running))
        self._span_stack.append(len(self.spans) - 1)
        return self._span_stack[-1]

    def _close_span(self, idx, seconds):
        name, _, parent, stage = self.spans[idx]
        self.spans[idx] = (name, seconds, parent, stage)
        self._span_stack.remove(idx)

    def self_seconds(self):
        """``(name, seconds)`` of each stage, in ``stages``' order, less the
        seconds of its direct sub-spans."""
        own = [s for _n, s, _note in self.stages]
        for _n, seconds, parent, stage in self.spans:
            if parent == -1:
                own[stage] -= seconds
        return [(n, s) for (n, _s, _note), s in zip(self.stages, own)]

    def set_note(self, note):
        if self.stages:
            idx = self.running if self.running is not None else len(self.stages) - 1
            name, elapsed, _ = self.stages[idx]
            self.stages[idx] = (name, elapsed, note)
            self._notify()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_on_change"] = None
        return state

    def __setstate__(self, state):
        # A timer pickled before sub-spans existed has none
        self.__dict__.update({"spans": [], "_span_stack": [], **state})

    @property
    def total(self):
        return sum(s[1] for s in self.stages)

    def as_dict(self):
        """The stages, their total, and the sub-spans, each with the name of
        its parent (the enclosing span, else its stage)."""
        def parent(p, stage):
            return self.spans[p][0] if p >= 0 else self.stages[stage][0]

        return {
            "stages": [
                {"name": n, "seconds": round(s, 4), "note": note}
                for n, s, note in self.stages
            ],
            "total_seconds": round(self.total, 4),
            "spans": [
                {"name": n, "seconds": round(s, 4), "parent": parent(p, stage)}
                for n, s, p, stage in self.spans
            ],
        }

    def report(self):
        lines = ["haMSM build timing:"]
        for name, seconds, note in self.stages:
            lines.append(f"  {name:<32s} {seconds:8.3f}s  {note}")
        lines.append(f"  {'TOTAL':<32s} {self.total:8.3f}s")
        return "\n".join(lines)

    def to_json(self, path):
        with open(path, "w") as fp:
            json.dump(self.as_dict(), fp, indent=2)


@contextlib.contextmanager
def live_stage_display(timer, enabled=True):
    """Rich ``Live`` step table driven by a :class:`StageTimer`; a no-op when
    disabled or when rich is not installed."""
    if not enabled:
        yield None
        return
    try:
        from rich.live import Live
        from rich.table import Table
    except ImportError:  # pragma: no cover - rich is optional
        log.debug("rich unavailable; live display disabled")
        yield None
        return

    def render():
        table = Table(title="haMSM build")
        table.add_column("")
        table.add_column("Step")
        table.add_column("Time", justify="right")
        table.add_column("Note")
        for idx, (name, seconds, note) in enumerate(timer.stages):
            in_progress = idx == timer.running or idx in timer._stack
            if idx in timer.failed:
                mark = "[red]x[/]"
            elif in_progress:
                mark = "[yellow]>[/]"
            else:
                mark = "[green]OK[/]"
            shown = f"{seconds:.2f}s" if (seconds or not in_progress) else "..."
            table.add_row(mark, name, shown, str(note))
        return table

    with Live(render(), refresh_per_second=4, transient=False) as live:
        prev = timer._on_change
        timer._on_change = lambda: live.update(render())
        try:
            yield live
        finally:
            live.update(render())
            timer._on_change = prev


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """Optionally wrap a block in a ``torch.profiler`` trace.

    No-op when ``log_dir`` is None (yields None), so callers can pass a
    config value straight through. Otherwise the block runs under
    ``torch.profiler.profile`` with the CPU activity and, when CUDA is
    available, the CUDA activity; shapes, stacks and memory are not
    recorded. On exit, also when the block raises, one Chrome trace file
    is written into ``log_dir`` (created if absent) and its path logged
    and kept as ``prof.trace_path``. Yields the profiler, so a caller can
    read ``key_averages()`` after the block.
    """
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"build_trace_{os.getpid()}_{time.time_ns()}.json"
    )
    prof = profile(activities=activities)
    prof.trace_path = path
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        log.info(f"torch.profiler trace written to {path}")
