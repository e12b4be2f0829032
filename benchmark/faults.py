"""Faults planted in the program, to read what a check's limit has to
catch (``calibrate.py --fault``, ``tests/test_bench_faults.py``).

Each is a context manager that patches the program while it is open.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def centers_unchanged():
    """The streaming clustering's state left unchanged after seeding:
    ``StratifiedKmeans`` seeds each bin as before (k-means++ and its Lloyd
    sweeps over the first rows that fill it) and never moves its centers
    again, on the host and on the device route."""
    from msm_we_tpu_torch.ops.stratified import StratifiedKmeans

    fit, scan = StratifiedKmeans.partial_fit, StratifiedKmeans.minibatch_scan_run

    def seed_only(self, X, seg_bins, weights=None):
        seg_bins = np.asarray(seg_bins)
        new = ~self.initialized[seg_bins]
        fit(self, np.asarray(X)[new], seg_bins[new],
            None if weights is None else np.asarray(weights)[new])
        return set(int(b) for b in np.unique(seg_bins) if self.initialized[b])

    StratifiedKmeans.partial_fit = seed_only
    StratifiedKmeans.minibatch_scan_run = lambda self, *args, **kwargs: None
    try:
        yield
    finally:
        StratifiedKmeans.partial_fit, StratifiedKmeans.minibatch_scan_run = fit, scan


FAULTS = {"centers_unchanged": centers_unchanged}
