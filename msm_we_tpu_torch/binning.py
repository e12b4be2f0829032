"""WESTPA-free WE bin mappers (copy of ``msm_we_tpu/binning.py``).

The reference depends on ``westpa.core.binning`` for Rectilinear/Voronoi bin
mappers and unpickles mappers from the ``west.h5`` ``bin_topologies`` group
(``_clustering.py:22,588-590``). This framework ships its own mappers with the
same assignment semantics so the engine has no WESTPA dependency; a pickled
WESTPA mapper (or any object with ``.assign``/``.nbins``) can still be passed
anywhere a mapper is accepted (``user_bin_mapper`` in the reference,
``_clustering.py:581-583``).

Assignment is vectorized numpy on the host (bin counts are tiny); the
stratified-clustering *device* kernel consumes the resulting integer bin ids.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "RectilinearBinMapper",
    "VoronoiBinMapper",
    "bin_centers_of",
    "find_nearest_bin",
    "SUPPORTED_MAPPERS",
]


class RectilinearBinMapper:
    """Rectilinear (grid) bin mapper.

    ``boundaries`` is a list with one ascending boundary array per pcoord
    dimension; bins are the half-open boxes between consecutive boundaries,
    flattened in C (row-major) order -- the WESTPA convention.
    """

    def __init__(self, boundaries):
        self.boundaries = [np.asarray(b, dtype=float) for b in boundaries]
        for b in self.boundaries:
            if len(b) < 2 or not np.all(np.diff(b) > 0):
                raise ValueError("Each boundary array must be ascending with >= 2 edges")
        self._shape = tuple(len(b) - 1 for b in self.boundaries)
        self.nbins = int(np.prod(self._shape))
        self.ndim = len(self.boundaries)

    def assign(self, coords):
        """Map (n, ndim) coords to flat bin indices; raises if out of range."""
        coords = np.atleast_2d(np.asarray(coords, dtype=float))
        if coords.shape[1] < self.ndim:
            raise ValueError(
                f"coords have {coords.shape[1]} dims, mapper needs {self.ndim}"
            )
        idxs = []
        for d, bounds in enumerate(self.boundaries):
            idx = np.digitize(coords[:, d], bounds) - 1
            if (idx < 0).any() or (idx >= self._shape[d]).any():
                bad = coords[(idx < 0) | (idx >= self._shape[d]), d]
                raise ValueError(
                    f"Coordinates {bad} outside bin boundaries in dimension {d}"
                )
            idxs.append(idx)
        return np.ravel_multi_index(idxs, self._shape)


class VoronoiBinMapper:
    """Voronoi bin mapper: assign to the nearest of a fixed set of centers.

    ``dfunc(point, centers)`` returns the distance from one point to every
    center (the WESTPA convention); default is Euclidean.
    """

    def __init__(self, centers, dfunc=None):
        centers = np.asarray(centers, dtype=float)
        if centers.ndim == 1:
            # A flat list is ambiguous: np.atleast_2d would silently read
            # it as ONE ndim-len(centers) center (nbins=1). N 1-D centers
            # must be spelled with an explicit trailing axis.
            raise ValueError(
                f"centers must be 2-D (n_centers, ndim); got a flat array of "
                f"length {centers.size}. For 1-D centers pass shape "
                f"({centers.size}, 1), e.g. np.asarray(centers)[:, None]."
            )
        self.centers = np.atleast_2d(centers)
        self.nbins = self.centers.shape[0]
        self.ndim = self.centers.shape[1]
        self.dfunc = dfunc if dfunc is not None else self._euclidean

    @staticmethod
    def _euclidean(point, centers):
        return np.sqrt(np.sum((np.asarray(point) - centers) ** 2, axis=1))

    def assign(self, coords):
        coords = np.atleast_2d(np.asarray(coords, dtype=float))
        if self.dfunc is self._euclidean:
            # Vectorized all-pairs distance
            d2 = (
                np.sum(coords**2, axis=1)[:, None]
                - 2 * coords @ self.centers.T
                + np.sum(self.centers**2, axis=1)[None, :]
            )
            return np.argmin(d2, axis=1)
        return np.array(
            [int(np.argmin(self.dfunc(c, self.centers))) for c in coords]
        )


SUPPORTED_MAPPERS = {RectilinearBinMapper, VoronoiBinMapper}


def bin_centers_of(bin_mapper):
    """Representative centers for a mapper's bins.

    Voronoi: its centers. Rectilinear: midpoints of the grid cells, meshed in
    the reference's order (``_clustering.py:1374-1380``). Duck-types on
    attribute names so pickled WESTPA mappers work too.
    """
    if hasattr(bin_mapper, "centers"):
        return np.atleast_2d(np.asarray(bin_mapper.centers, dtype=float))
    if hasattr(bin_mapper, "boundaries"):
        bounds = [np.asarray(b, dtype=float) for b in bin_mapper.boundaries]
        mids = [dim[:-1] + (dim[1:] - dim[:-1]) / 2 for dim in bounds]
        # indexing='ij' so the flattened center order matches the C-order
        # flat bin indices of RectilinearBinMapper.assign. (The reference's
        # 'xy' meshgrid + .T walks the wrong axis for >=3 pcoord dims,
        # _clustering.py:1374-1380.)
        grids = np.meshgrid(*mids, indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], axis=1)
    raise TypeError(f"Cannot derive bin centers from {type(bin_mapper)}")


def find_nearest_bin(bin_mapper, bin_idx, filled_bins):
    """Index of the bin in ``filled_bins`` nearest to ``bin_idx``.

    Voronoi-style on the mapper's (synthesized) bin centers; rectilinear
    mappers use the reference's RMSD distance (``_clustering.py:1362-1396``).
    """
    filled_bins = list(filled_bins)
    assert len(filled_bins) > 0, (
        "Can't find nearest populated bin -- no WE bins are populated with "
        "clusters! Try fewer clusters/bin."
    )

    centers = bin_centers_of(bin_mapper)
    if hasattr(bin_mapper, "dfunc") and hasattr(bin_mapper, "centers"):
        distance_function = bin_mapper.dfunc
    else:
        def distance_function(point, _centers):
            return np.sqrt(np.mean((point - _centers) ** 2, axis=1))

    ignored = np.setdiff1d(np.arange(centers.shape[0]), filled_bins)
    other_centers = np.delete(centers, ignored, axis=0)
    closest = int(np.argmin(distance_function(centers[bin_idx], other_centers)))

    # Shift the compacted index back into the original numbering
    for skipped in sorted(ignored):
        if closest >= skipped:
            closest += 1
    return closest
