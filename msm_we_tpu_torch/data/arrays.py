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

__all__ = ["ArrayWEDataset"]


class ArrayWEDataset:
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

    def iter_child_coords(self, n_iter):
        """Final-frame coordinates of each segment, NaN rows dropped."""
        child = self._iter_frame_block(n_iter, -1)
        good = ~np.isnan(child).any(axis=tuple(range(1, child.ndim)))
        return child[np.flatnonzero(good)]

    def ancestor_ids(self, n_iter, n_lag):
        """Each segment's ancestor ``n_lag`` iterations back: ``(anc,
        warped)``, with ``warped`` True (and ``anc`` -1) where the lineage
        was recycled inside the window."""
        if n_lag < 0 or n_iter - n_lag < 1:
            raise ValueError(
                f"Iteration {n_iter} has no ancestry {n_lag} iterations back"
            )
        n = self.iter_data(n_iter)["n_segs"]
        anc = np.arange(n)
        warped = np.zeros(n, dtype=bool)
        for h in range(1, n_lag + 1):
            parents = self.iter_data(n_iter - h + 1)["parent_ids_global"]
            step = np.where(warped, -1, parents[np.where(warped, 0, anc)])
            warped |= step < 0
            anc = np.where(warped, -1, step)
        return anc, warped

    def iter_transition_pairs(self, n_iter, n_lag, basis_coords=None):
        """Transition pairs at lag ``n_lag`` ending in iteration ``n_iter``
        (the file reader's rule): start = frame 0 of the ancestor ``n_lag``
        iterations back, end = the segment's final frame; a lineage
        recycled inside the window starts from ``basis_coords``.
        ``weights`` are the current iteration's, zeroed where either used
        frame has NaN coordinates; ``departure_weights`` the ancestor's
        (the current weight for recycled lineages). Returns a dict with
        ``start``, ``end``, ``weights``, ``departure_weights``,
        ``start_pcoord``, ``warped``, ``anc``."""
        anc, warped = self.ancestor_ids(n_iter, n_lag)
        if warped.any() and basis_coords is None:
            raise ValueError(
                f"Iteration {n_iter} has lineages recycled within the lag-"
                f"{n_lag} window; basis_coords is required to substitute "
                "their start structures (reference semantics, _data.py:170-182)"
            )
        d_now = self.iter_data(n_iter)
        d_lag = self.iter_data(n_iter - n_lag)
        start_all = self._iter_frame_block(n_iter - n_lag, 0)
        end = self._iter_frame_block(n_iter, -1)
        weights = d_now["weights"].copy()
        bad_end = np.isnan(end).any(axis=tuple(range(1, end.ndim)))
        if bad_end.any():
            log.warning(
                f"Bad end-frame coordinates for segments "
                f"{np.flatnonzero(bad_end)} in iteration {n_iter}, setting "
                "weights to 0"
            )
            weights[bad_end] = 0.0
        safe = np.where(warped, 0, anc)
        start = start_all[safe].copy()
        start_pcoord = d_lag["pcoord0"][safe].copy()
        departure = d_lag["weights"][safe].copy()
        if warped.any():
            start[warped] = np.asarray(basis_coords, dtype=start.dtype)
            start_pcoord[warped] = np.nan
            departure[warped] = d_now["weights"][warped]
        bad = np.isnan(start).any(axis=tuple(range(1, start.ndim))) & ~warped
        weights[bad] = 0.0
        return dict(
            start=start, end=end, weights=weights, departure_weights=departure,
            start_pcoord=start_pcoord, warped=warped, anc=anc,
        )

    def check_continuity(self, sample_per_iter=8, full_iters=2, seed=0,
                         last_iter=None):
        """True iff segments' frame-0 coordinates are bit-identical to their
        parent's final frame: all rows of the first ``full_iters`` usable
        iterations, ``sample_per_iter`` random rows of every later one
        (the file reader's check, without its per-file memo)."""
        rng = np.random.default_rng(seed)
        usable = sorted(
            i for i in self._iter_index
            if i >= 2 and (last_iter is None or i <= last_iter)
        )
        for pos, i in enumerate(usable):
            d = self.iter_data(i)
            rows = np.flatnonzero(d["parent_ids_global"] >= 0)
            if not len(rows):
                continue
            if i - 1 not in self._iter_index:
                return False
            if pos >= full_iters and sample_per_iter < len(rows):
                rows = np.sort(rng.choice(rows, sample_per_iter, replace=False))
            own_start = self.iter_frame_subset(i, rows, 0)
            parent_end = self.iter_frame_subset(
                i - 1, d["parent_ids_global"][rows], -1
            )
            if not np.array_equal(own_start, parent_end, equal_nan=True):
                return False
        return True

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
