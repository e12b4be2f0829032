"""Driver of the build cells whose per-state and per-bin work is read on its
own: ``drivers/build.py``'s cell (the same set-up, window, end-to-end
numbers, profile and check), and in the record of a ``trace`` run two
things more.

* ``build_spans``: for each window build, the seconds of the program's
  spans ``clean`` (flux cleaning) and ``steady_state`` (the steady-state
  solve) in ``model.stage_timings.spans``, each summed over the build by
  its outermost occurrences: the main model's and every validation
  group's.
* ``trace_counts``: for each of the ``trace_builds`` profiled builds, the
  host counts it left under ``tracing.collect()``: ``fold_host_bins`` and
  ``fold_device_bins`` (the streaming clustering's bin batches by the
  family that ran them), ``fold_gathered_iterations`` (the iterations its
  fill batches held after their first) and ``fold_remapped_bins`` (the
  bins remapped to the nearest filled bin when the data ran out).

A program without one of these spans or counts leaves it None, and its
reader reports nothing.
"""
from __future__ import annotations

import importlib.util
import os

_HERE = os.path.dirname(os.path.abspath(__file__))

SPANS = ("clean", "steady_state")
COUNTS = ("fold_host_bins", "fold_device_bins", "fold_gathered_iterations",
          "fold_remapped_bins")


def _base():
    """``drivers/build.py`` of this checkout, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "bench_driver_build_base", os.path.join(_HERE, "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _base()


def outermost_seconds(spans, name):
    """The seconds of the spans ``name`` among ``spans`` (a
    ``StageTimer``'s ``(name, seconds, parent, stage)``) that no span of
    the same name encloses, summed; None where none occurs."""
    total, found = 0.0, False
    for n, seconds, parent, _stage in spans:
        if n != name:
            continue
        while parent >= 0 and spans[parent][0] != name:
            parent = spans[parent][2]
        if parent < 0:
            total += seconds
            found = True
    return total if found else None


class Cell(base.Cell):
    def __init__(self, config, workload, seed, device):
        self._spans, self._counts = [], []
        super().__init__(config, workload, seed, device)

    def _build(self, profile_dir=None):
        from msm_we_tpu_torch import tracing

        if profile_dir is None:
            model = super()._build()
        else:
            with tracing.collect() as col:
                model = super()._build(profile_dir=profile_dir)
            self._counts.append({n: col.counts.get(n) for n in COUNTS})
        spans = model.stage_timings.spans
        self._spans.append({n: outermost_seconds(spans, n) for n in SPANS})
        return model

    def window(self, seconds, trace=False):
        self._spans, self._counts = [], []
        res = super().window(seconds, trace=trace)
        if trace:
            res["record"].update(build_spans=self._spans[:res["attempted"]],
                                 trace_counts=list(self._counts))
        return res
