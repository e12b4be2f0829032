"""Driver of the build cells at NTL9 widths: ``drivers/build_spans.py``'s
cell (the same set-up, window, end-to-end numbers, profile and check, with
its spans ``clean`` and ``steady_state`` and its fold counts) over the run
of ``traffic/we_run_wide.py``, the configuration's ``wide`` coordinates
on ``westpa_default``'s WE run; and in the record of a ``trace`` run
more of the program's spans and counts.

* ``build_spans``: also, for each window build, the seconds of the spans
  ``reduce_moments`` (``modelWE.dimReduce``'s moment accumulation and
  eigensolve) and ``project`` (each ``PCAModel.transform``), each summed
  over the build by its outermost occurrences.
* ``trace_counts``: also, for each profiled build, the host counts
  ``parent_rows_gathered`` and ``parent_rows_projected`` (the parent
  feature rows ``features.featurize_all`` gathered from child rows and
  projected from their own frames) and ``dedup_fallback`` (1 where the
  gather's bitwise checks failed and every parent row was projected).

A program without one of these spans or counts leaves it None, and its
reader reports nothing. ``reference/build_wide.py`` judges the builds:
``reference/build.py``'s judge with a control whose PCA moments take TF32
products.
"""
from __future__ import annotations

import functools
import importlib.util
import os

from benchmark.reference import build_wide as reference
from benchmark.traffic import we_run_wide

_HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# A copy of ``build_spans.py`` of this checkout of its own, so that the
# spans and counts it keeps, and the run its cell makes, are this driver's
spans = _load(os.path.join(_HERE, "build_spans.py"), "bench_driver_build_wide_spans")
spans.SPANS = spans.SPANS + ("reduce_moments", "project")
spans.COUNTS = spans.COUNTS + ("parent_rows_gathered", "parent_rows_projected",
                               "dedup_fallback")


class Cell(spans.Cell):
    def __init__(self, config, workload, seed, device):
        spans.base.generate = functools.partial(we_run_wide.generate, wide=config["wide"])
        super().__init__(config, workload, seed, device)

    def _judge(self):
        return reference.Judge(self.data, self.config, self.device)
