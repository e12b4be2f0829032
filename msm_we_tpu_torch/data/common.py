"""What the file reader and the in-memory dataset share: the members that
read only ``iter_data``, ``iter_coord_pairs``, ``_iter_frame_block`` and
``iter_frame_subset`` of the dataset they are mixed into."""
from __future__ import annotations

import numpy as np

from .._logging import log

__all__ = ["WEDataAccess"]


class WEDataAccess:
    """Ancestry walks, lagged transition pairs, final-frame coordinates and
    the sampled continuity check over a dataset's per-iteration reads."""

    def ancestor_ids(self, n_iter, n_lag):
        """Vectorized ancestry walk: each segment's ancestor ``n_lag``
        iterations back.

        Returns ``(anc, warped)``: ``anc[s]`` is the index (into iteration
        ``n_iter - n_lag``'s concatenated ordering) of segment ``s``'s
        ancestor, and ``warped[s]`` is True when the lineage was recycled
        anywhere inside the window (in which case ``anc[s]`` is -1). Each
        step is one gather on the cached ``parent_ids_global`` arrays.
        """
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
        """Transition pairs at lag ``n_lag`` ending in iteration ``n_iter``.

        * start = frame 0 of the segment's ancestor ``n_lag`` iterations
          back; end = the segment's final frame. At ``n_lag=0`` this is
          exactly :meth:`iter_coord_pairs`.
        * a lineage recycled inside the window starts from ``basis_coords``
          instead (the post-warp trajectory was born in the basis); target
          absorption needs no special casing because end-in-target segments
          are overridden to the target state downstream, same as lag 0.
        * ``weights`` (transition weights) are the current iteration's;
          ``departure_weights`` are the ancestor's at ``n_iter - n_lag``
          (current weight for warped lineages).

        Returns a dict with ``start``, ``end``, ``weights``,
        ``departure_weights``, ``start_pcoord``, ``warped``, ``anc``.
        """
        if n_lag == 0:
            parent, child, weights = self.iter_coord_pairs(n_iter)
            d = self.iter_data(n_iter)
            return dict(
                start=parent, end=child, weights=weights,
                departure_weights=weights.copy(),
                start_pcoord=d["pcoord0"].copy(),
                warped=np.zeros(d["n_segs"], bool),
                anc=np.arange(d["n_segs"]),
            )

        anc, warped = self.ancestor_ids(n_iter, n_lag)
        if warped.any() and basis_coords is None:
            raise ValueError(
                f"Iteration {n_iter} has lineages recycled within the lag-"
                f"{n_lag} window; basis_coords is required to substitute "
                "their start structures (reference semantics, _data.py:170-182)"
            )

        d_now = self.iter_data(n_iter)
        d_lag = self.iter_data(n_iter - n_lag)
        # Only the two frames the lagged pair actually uses are read (half
        # the aux I/O of iter_coord_pairs), and only THEIR NaNs zero the
        # weight: frame 0 of the current iteration is irrelevant to a
        # lag>0 transition, so its NaNs must not zero a valid pair
        start_all = self._iter_frame_block(n_iter - n_lag, 0)
        end = self._iter_frame_block(n_iter, -1)
        weights = d_now["weights"].copy()
        end_axes = tuple(range(1, end.ndim))
        bad_end = np.isnan(end).any(axis=end_axes)
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
            # A recycled lineage has no ancestor pcoord; NaN start pcoords
            # tell the caller to treat these rows as basis departures
            start_pcoord[warped] = np.nan
            departure[warped] = d_now["weights"][warped]

        # NaN start coordinates zero the transition weight, the lag-0
        # convention (``_data.py:303-313``) applied to the lagged frame
        flat_axes = tuple(range(1, start.ndim))
        bad = np.isnan(start).any(axis=flat_axes) & ~warped
        w = weights.copy()
        if bad.any():
            w[bad] = 0.0
        return dict(
            start=start, end=end, weights=w, departure_weights=departure,
            start_pcoord=start_pcoord, warped=warped, anc=anc,
        )

    def _check_continuity_uncached(self, sample_per_iter, full_iters, seed,
                                   last_iter):
        rng = np.random.default_rng(seed)
        # Bound to the range actually consumed (a corrupt tail beyond the
        # featurized iterations should not disable dedup for the clean range)
        usable = sorted(
            i
            for i in self._iter_index
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

    def iter_child_coords(self, n_iter):
        """Final-frame coordinates of each segment (reference
        ``load_iter_coordinates``, ``_data.py:557-618``). NaN rows dropped.
        Reads only the final frame (half the I/O of iter_coord_pairs)."""
        child = self._iter_frame_block(n_iter, -1)
        good = ~np.isnan(child).any(axis=tuple(range(1, child.ndim)))
        return child[np.flatnonzero(good)]
