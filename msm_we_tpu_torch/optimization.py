"""WE binning/allocation optimization: discrepancy functions and the
optimized bin mapper.

Counterpart of ``msm_we_tpu/optimization.py`` (reference
``msm_we/optimization.py``: solve_discrepancy :15, get_uniform_mfpt_bins
:79, get_clustered_mfpt_bins :119, OptimizedBinMapper :169), without a
WESTPA dependency: the mapper implements the reference's ``assign``
semantics standalone. The discrepancy solve and the MFPT bin functions are host
float64 numpy. Two places reach the model's device:
``get_clustered_mfpt_bins`` without sklearn runs the port's own k-means
(``ops.kmeans.kmeans_fit(..., device=...)``), and
``OptimizedBinMapper.mapper`` assigns through the stratified clusterer,
which on a CUDA bank launches the H4 kernel for batches of
``HOST_BATCH_THRESHOLD`` rows or more. A pickled mapper holds CPU state;
the bytestring constructor moves it to the card unless the caller passes
``device="cpu"``, as the port's other entry points do.
"""
from __future__ import annotations

import base64
import pickle

import numpy as np

from ._logging import log

__all__ = [
    "solve_discrepancy",
    "get_uniform_mfpt_bins",
    "get_clustered_mfpt_bins",
    "OptimizedBinMapper",
]


def solve_discrepancy(tmatrix, pi, B):
    r"""Solve the Poisson equation for the discrepancy function.

    ``(I - K + pi pi^T / ||pi||^2) h = 1_B - pi(B)`` with ``h . pi = 0``, and
    the per-state variance ``sqrt(K h^2 - (K h)^2)``. Reference
    ``optimization.py:15-76``; verified against the NTL9 golden arrays.
    """
    log.info("Computing pi matrix")
    pi = np.asarray(pi, dtype=np.float64)
    tmatrix = np.asarray(tmatrix, dtype=np.float64)

    norm = np.dot(pi, pi.T)
    pi_matrix = pi * pi.T.reshape(-1, 1) / norm

    b_indicator = np.zeros_like(pi)
    b_indicator[np.asarray(B)] = 1.0

    pi_b = np.full_like(pi, pi[np.asarray(B)].sum())

    discrepancy = np.linalg.solve(
        np.identity(tmatrix.shape[0]) - tmatrix + pi_matrix, b_indicator - pi_b
    )
    variance = np.sqrt(
        np.dot(tmatrix, discrepancy**2) - np.dot(tmatrix, discrepancy) ** 2
    )
    if np.isnan(variance).any():
        log.warning("NaN elements in variance!")

    assert np.isclose(discrepancy @ pi, 0), (
        "Discrepancy solution failed normalization sanity check!"
    )
    return discrepancy, variance


def get_uniform_mfpt_bins(variance, discrepancy, steady_state, n_desired_we_bins):
    """Microstate -> WE-bin assignment by uniform partition of cumulative
    pi*v along the discrepancy ordering. Reference ``optimization.py:79-116``.
    """
    assert n_desired_we_bins > 2, (
        f"Target number of WE bins for optimization is too few -- got "
        f"{n_desired_we_bins}"
    )
    pi_v = np.asarray(steady_state) * np.asarray(variance)
    pi_v_sort = np.argsort(discrepancy).squeeze()
    cumsum = np.cumsum(pi_v[pi_v_sort])

    n_active_bins = n_desired_we_bins - 2
    bin_bounds = np.linspace(0, cumsum[-1], n_active_bins + 1)[1:]
    bin_assignments = np.digitize(cumsum, bin_bounds, right=True)
    return bin_assignments[np.argsort(pi_v_sort)]


def get_clustered_mfpt_bins(
    variance, discrepancy, steady_state, n_desired_we_bins, seed=None,
    device="cuda",
):
    """Microstate -> WE-bin assignment by k-means on the cumulative pi*v.

    Reference ``optimization.py:119-166``. Uses sklearn's KMeans where it
    is installed (reproducing the reference's seeded clustering); otherwise
    the port's own deterministic k-means on ``device`` (on CUDA its
    assignments are H4 launches on one bin). A tiny 1-D clustering, not a
    performance path.
    """
    assert n_desired_we_bins > 2, (
        f"Target number of WE bins for optimization is too few -- got "
        f"{n_desired_we_bins}"
    )
    pi_v = np.asarray(steady_state) * np.asarray(variance)
    n_active_bins = n_desired_we_bins - 2
    pi_v_sort = np.argsort(discrepancy).squeeze()
    cumsum = np.cumsum(pi_v[pi_v_sort])

    n_clusters = min(n_active_bins, len(cumsum))
    try:
        from sklearn.cluster import KMeans

        clusterer = KMeans(n_clusters=n_clusters, random_state=seed)
        we_bin_assignments = clusterer.fit_predict(cumsum.reshape(-1, 1))
    except ImportError:
        from ._device import as_device
        from .ops.kmeans import kmeans_fit

        _centers, we_bin_assignments = kmeans_fit(
            cumsum.reshape(-1, 1), None, n_clusters, seed=seed or 0,
            device=as_device(device),
        )

    bin_states = np.full_like(cumsum, fill_value=np.nan)
    for i in range(n_active_bins):
        indices = np.argwhere(we_bin_assignments == i).squeeze()
        states_in_bin = pi_v_sort[indices]
        bin_states[states_in_bin] = i
        log.debug(f"Found that bin {i} contains microstates {states_in_bin}")
    return bin_states


class _BoundsModel:
    """Minimal state-membership tester used inside the mapper."""

    def __init__(self, pcoord_ndim, basis_pcoord_bounds, target_pcoord_bounds):
        self.pcoord_ndim = pcoord_ndim
        self.basis_pcoord_bounds = np.asarray(basis_pcoord_bounds, dtype=float)
        self.target_pcoord_bounds = np.asarray(target_pcoord_bounds, dtype=float)
        self.pcoord1List = None

    def is_WE_basis(self, pcoords):
        from .utils import pcoord_in_bounds

        return pcoord_in_bounds(pcoords, self.basis_pcoord_bounds[: self.pcoord_ndim])

    def is_WE_target(self, pcoords):
        from .utils import pcoord_in_bounds

        return pcoord_in_bounds(pcoords, self.target_pcoord_bounds[: self.pcoord_ndim])


class OptimizedBinMapper:
    """WE bin mapper driven by an haMSM's optimized microstate->bin mapping.

    Maps each segment: original pcoord -> base-mapper bin; extended pcoord
    (reduced features appended to the pcoord) -> stratified cluster ->
    ``microstate_mapper`` -> WE bin; basis/target overridden to the last two
    bins. Reference semantics: ``optimization.py:169-348``.

    Construct either with keyword arguments, or with a ``bytestring=``
    keyword holding the base64-pickled mapper (the reference's transport
    format, ``optimization.py:187-199``). The bytestring holds CPU state;
    the restored clusterer assigns on ``device`` ("cuda" unless the caller
    passes ``device="cpu"``; without a CUDA device the default raises).
    """

    def __init__(self, *args, **kwargs):
        if not args and "bytestring" in kwargs and set(kwargs) <= {"bytestring", "device"}:
            log.info("Unpickling OptimizedBinMapper from bytestring")
            self.unpickle(**kwargs)
        elif len(args) + len(kwargs) > 1:
            self.create_new(*args, **kwargs)
        else:
            raise TypeError(
                "OptimizedBinMapper takes either the full construction "
                "arguments (see create_new) or bytestring=<b64 pickle>; "
                "a single positional argument would construct an empty, "
                "unusable mapper"
            )

    def unpickle(self, bytestring, device="cuda"):
        """Take the state of a base64-pickled mapper and move its
        clusterer's bank to ``device``."""
        from ._device import as_device

        device = as_device(device)
        loaded = pickle.loads(base64.b64decode(bytestring))
        assert type(loaded) is type(self), "Invalid pickled object provided"
        for k, v in vars(loaded).items():
            setattr(self, k, v)
        self.clusterer.strat.to(device)

    def pickle_and_encode(self):
        """Base64 transport encoding (inverse of the bytestring constructor)."""
        return base64.b64encode(pickle.dumps(self))

    def create_new(
        self,
        nbins: int,
        n_original_pcoord_dims: int,
        target_pcoord_bounds,
        basis_pcoord_bounds,
        previous_binmapper,
        microstate_mapper: dict,
        stratified_clusterer,
        cluster_on_pcoord: bool = False,
        *args,
        **kwargs,
    ):
        self.nbins = nbins
        self.microstate_mapper = microstate_mapper
        self.n_original_pcoord_dims = n_original_pcoord_dims
        self.base_mapper = previous_binmapper
        self.cluster_on_pcoord = cluster_on_pcoord

        self.simple_model = _BoundsModel(
            n_original_pcoord_dims, basis_pcoord_bounds, target_pcoord_bounds
        )
        self.clusterer = stratified_clusterer
        self.clusterer.model = self.simple_model

        n_clusters = 2
        for cluster_model in self.clusterer.cluster_models:
            if hasattr(cluster_model, "cluster_centers_"):
                n_clusters += len(cluster_model.cluster_centers_)
        self.n_clusters = n_clusters
        log.info(
            f"Clusterer has {n_clusters} total clusters "
            "(including 1 for basis and 1 for target)"
        )

    def mapper(self, coords, mask, output, *args, **kwargs):
        """WESTPA FuncBinMapper-style callback; also used by :meth:`assign`."""
        coords = np.asarray(coords)
        if coords.ndim == 3:
            final_coords = coords[:, -1]
        else:
            final_coords = coords

        original_pcoords = final_coords[:, : self.n_original_pcoord_dims]
        if not getattr(self, "cluster_on_pcoord", False):
            extended_pcoords = final_coords[:, self.n_original_pcoord_dims :]
        else:
            extended_pcoords = final_coords[:, : self.n_original_pcoord_dims]

        basis_we_bin_idx, target_we_bin_idx = self.nbins - 2, self.nbins - 1

        self.clusterer.model.pcoord1List = original_pcoords
        stratified_cluster_assignments = self.clusterer.predict(extended_pcoords)

        microstate_mapper = self.microstate_mapper
        # One vectorized table lookup instead of a per-segment python loop
        # (this runs inside WESTPA's resampling step every WE iteration).
        # Missing microstates -> -1.0: for a dict with non-contiguous keys
        # (e.g. after a microstate was cleaned) the table rows between keys
        # stay -1, preserving the membership-test semantics. The table is
        # cached per mapper object (it only changes when reassigned).
        cached = getattr(self, "_microstate_lut", None)
        if cached is not None and cached[0] is microstate_mapper:
            lut = cached[1]
        else:
            if isinstance(microstate_mapper, dict):
                size = max(microstate_mapper.keys(), default=-1) + 1
                lut = np.full(size, -1.0)
                if size:
                    keys = np.fromiter(
                        microstate_mapper.keys(), dtype=np.int64
                    )
                    lut[keys] = [float(microstate_mapper[k]) for k in keys]
            else:
                lut = np.asarray(microstate_mapper, dtype=float)
            self._microstate_lut = (microstate_mapper, lut)
        m = np.asarray(stratified_cluster_assignments, dtype=np.int64)
        if len(lut):
            known = (m >= 0) & (m < len(lut))
            we_bin_assignments = np.where(
                known, lut[np.clip(m, 0, len(lut) - 1)], -1.0
            )
        else:
            we_bin_assignments = np.full(len(m), -1.0)

        we_bin_assignments[
            self.clusterer.model.is_WE_target(original_pcoords)
        ] = target_we_bin_idx
        we_bin_assignments[
            self.clusterer.model.is_WE_basis(original_pcoords)
        ] = basis_we_bin_idx

        if output is None:
            output = np.empty(len(final_coords))
        if len(output) == len(we_bin_assignments):
            try:
                output[:] = we_bin_assignments
            except (TypeError, ValueError):
                # Exotic output buffers without slice support
                for i in range(len(output)):
                    output[i] = we_bin_assignments[i]
        else:
            # Reference loop semantics (``optimization.py:340-341``): a
            # longer buffer fails loudly with IndexError, a shorter one
            # truncates -- a silent slice fill would leave np.empty
            # garbage in the tail that passes the asserts below
            for i in range(len(output)):
                output[i] = we_bin_assignments[i]

        assert not np.isnan(output).any(), "Some segments couldn't get assigned WE bins"
        assert all(np.asarray(output) >= 0), (
            "Some target/basis microstates didn't get correctly remapped"
        )
        return np.asarray(output).astype(int)

    def assign(self, coords):
        """Standalone assignment (no WESTPA machinery required)."""
        coords = np.asarray(coords)
        n = len(coords)
        return self.mapper(coords, np.ones(n, bool), np.empty(n))
