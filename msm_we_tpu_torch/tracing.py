"""Per-stage timing of a build (counterpart of ``msm_we_tpu/tracing.py``:
``StageTimer`` and ``live_stage_display``; the JAX profiler hook is not
ported). rich is imported only when the live display is enabled.
"""
from __future__ import annotations

import contextlib
import json
import time

from ._logging import log

__all__ = ["StageTimer", "live_stage_display"]


class StageTimer:
    """Collects named stage durations; renderable as text or JSON.

    ``on_change`` fires whenever a stage starts, finishes, or gains a note
    (the hook :func:`live_stage_display` uses to refresh its table).
    """

    def __init__(self, on_change=None):
        self.stages = []  # list of (name, seconds, note)
        self.failed = set()  # indices of stages that raised
        self.running = None  # index of the innermost running stage
        self._stack = []  # indices of nested running stages
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
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException:
            self.failed.add(idx)
            raise
        finally:
            elapsed = time.perf_counter() - t0
            n, _, note_now = self.stages[idx]
            self.stages[idx] = (n, elapsed, note_now)
            self._stack.pop()
            self.running = self._stack[-1] if self._stack else None
            self._notify()
            log.info(f"[stage] {name}: {elapsed:.3f}s {note_now}")

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

    @property
    def total(self):
        return sum(s[1] for s in self.stages)

    def as_dict(self):
        return {
            "stages": [
                {"name": n, "seconds": round(s, 4), "note": note}
                for n, s, note in self.stages
            ],
            "total_seconds": round(self.total, 4),
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
