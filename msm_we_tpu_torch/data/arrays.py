"""In-memory weighted-ensemble dataset.

``ArrayWEDataset`` exposes the members of ``msm_we_tpu/data/westh5.py``'s
``WEDataset`` that the haMSM build reads, over a list of per-iteration
dicts (the output of ``generate_trajectory_arrays``: ``weights``,
``parent_ids``, ``pcoords`` (n, pcoord_len, ndim) and ``coords``
(n, 2, n_atoms, 3) with frame 0 the segment's start and frame 1 its end).
It is the port's ingest seam: ``modelWE.initialize`` accepts one in place
of a list of west.h5 paths.

It follows the reader's convention that the last iteration is incomplete:
with ``L`` dicts, iterations ``1 .. L-1`` are usable. Every coordinate
accessor returns a fresh array, as a file read would, so callers may
mutate what they get.
"""
from __future__ import annotations

import numpy as np

from .._logging import log
from .common import WEDataAccess

__all__ = ["ArrayWEDataset"]


class ArrayWEDataset(WEDataAccess):
    """WE data held in memory, one dict per iteration."""

    def __init__(self, iterations, pcoord_ndim=1):
        self._iters = list(iterations)
        if len(self._iters) < 2:
            raise ValueError(
                "need at least two iterations (the last one is incomplete)"
            )
        self.pcoord_ndim = int(pcoord_ndim)
        self.maxIter = len(self._iters) - 1
        counts = [len(d["weights"]) for d in self._iters[: self.maxIter]]
        self.numSegments = np.array(counts, dtype=float)
        self._iter_index = {i + 1: [(0, n)] for i, n in enumerate(counts)}
        self.pcoord_len = int(np.asarray(self._iters[0]["pcoords"]).shape[1])
        self._iter_data = {}

    def _raw(self, n_iter):
        if n_iter not in self._iter_index:
            raise KeyError(f"Iteration {n_iter} not present/usable")
        return self._iters[n_iter - 1]

    # -------------------------------------------------------- index data
    def iter_data(self, n_iter):
        """Index data for one iteration (cached; no coordinates): weights,
        parent ids (plain and global), first/last pcoords, origin ids."""
        if n_iter in self._iter_data:
            return self._iter_data[n_iter]
        d = self._raw(n_iter)
        pcoord = np.asarray(d["pcoords"])
        if pcoord.shape[2] < self.pcoord_ndim:
            raise ValueError(
                f"pcoord has only {pcoord.shape[2]} dims but pcoord_ndim="
                f"{self.pcoord_ndim} was requested"
            )
        n = len(d["weights"])
        parents = np.array(d["parent_ids"], dtype=np.int64)
        data = dict(
            weights=np.array(d["weights"], dtype=np.float64),
            parent_ids=parents,
            pcoord0=pcoord[:, 0, : self.pcoord_ndim].copy(),
            pcoord1=pcoord[:, -1, : self.pcoord_ndim].copy(),
            west_idx=np.zeros(n, dtype=int),
            seg_idx=np.arange(n),
            n_segs=n,
            # One source: parent ids already index the previous iteration's
            # concatenated ordering
            parent_ids_global=parents.copy(),
        )
        self._iter_data[n_iter] = data
        return data

    # ------------------------------------------------------- coordinates
    def _coords(self, n_iter):
        return np.asarray(self._raw(n_iter)["coords"])

    def iter_coord_pairs(self, n_iter):
        """(parent_coords, child_coords, weights); rows with NaN coordinates
        keep them but get weight 0 (the reference's convention)."""
        coords = self._coords(n_iter)
        parent = coords[:, 0].copy()
        child = coords[:, -1].copy()
        weights = self.iter_data(n_iter)["weights"].copy()
        axes = tuple(range(1, parent.ndim))
        bad = np.isnan(parent).any(axis=axes) | np.isnan(child).any(axis=axes)
        if bad.any():
            log.warning(
                f"Bad coordinates for segments {np.flatnonzero(bad)} in "
                f"iteration {n_iter}, setting weights to 0"
            )
            weights[bad] = 0.0
        return parent, child, weights

    def _iter_frame_block(self, n_iter, frame, consume=False, transient=False):
        """One frame's coordinates for every segment (NaN kept), as a fresh
        array; ``consume``/``transient`` are accepted for signature parity
        with the file reader's block cache."""
        del consume, transient
        return self._coords(n_iter)[:, frame].copy()

    def iter_frame_subset(self, n_iter, rows, frame):
        """One frame's coordinates for a subset of segments."""
        return self._coords(n_iter)[np.asarray(rows, dtype=np.int64), frame]

    def check_continuity(self, sample_per_iter=8, full_iters=2, seed=0,
                         last_iter=None):
        """True iff segments' frame-0 coordinates are bit-identical to their
        parent's final frame: all rows of the first ``full_iters`` usable
        iterations, ``sample_per_iter`` random rows of every later one
        (the file reader's check, without its per-file memo)."""
        return self._check_continuity_uncached(
            sample_per_iter, full_iters, seed, last_iter
        )

    def __deepcopy__(self, memo):
        """The data are read-only: model copies (``post_cluster_model``,
        the validation models) share one dataset."""
        return self

    # ------------------------------------------- file-reader no-ops
    def start_prefetch(self, last_iter, frames=(-1,)):
        """No-op: the data are already in memory."""

    def drop_block_cache(self):
        """No-op: there is no block cache."""

    def close(self):
        """No-op: there are no file handles."""
