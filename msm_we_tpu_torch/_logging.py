"""Package logger (counterpart of ``msm_we_tpu/_logging.py``).

A plain stream handler and no-op progress objects (``DefaultProgress``,
``ProgressBar``): the compute paths never depend on a TTY or on rich, which
the port imports only inside the optional live display.
"""
from __future__ import annotations

import logging

log = logging.getLogger("msm_we_tpu_torch")
if not log.handlers:
    log.addHandler(logging.StreamHandler())
# INFO by default, like the JAX package; embedders can pin a level before
# importing the package
if log.level == logging.NOTSET:
    log.setLevel(logging.INFO)
log.propagate = False


class _NullTask:
    pass


class DefaultProgress:
    """Minimal stand-in for a ``rich.progress.Progress`` object: the
    ``add_task``/``update``/``advance`` surface the pipeline calls, so
    callers can pass a real rich Progress or nothing at all."""

    def add_task(self, description="", total=None, completed=0, **kwargs):
        return _NullTask()

    def update(self, task, advance=None, visible=True, **kwargs):
        return None

    def advance(self, task, advance=1):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ProgressBar:
    """Context manager over an optional progress object: enter yields the
    shared progress object given, or a :class:`DefaultProgress`."""

    def __init__(self, progress_bar=None):
        self.progress_bar = progress_bar if progress_bar is not None else DefaultProgress()

    def __enter__(self):
        return self.progress_bar

    def __exit__(self, *exc):
        return False
