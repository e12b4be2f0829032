"""Load fitted state from plain arrays into a port ``modelWE``.

``fitted_state_from_arrays`` installs what ``dimReduce`` and
``cluster_coordinates`` would have fitted -- the PCA transform, the
stratified center bank and the WE bin mapper -- from numpy arrays, so a
build's later stages (discretization -> flux -> cleaning -> analysis) can
run from the fitted state of another build, for example the JAX package's.
``tica_state_from_arrays`` installs a fitted TICA/VAMP transform and
``aggregated_state_from_arrays`` an aggregated k-means bank the same way.
The installed stratified bank carries no dtrajs: it is the state a
``defer_discretization=True`` clustering leaves, so the device flux route
can run from it directly. ``optimized_mapper_from_arrays`` builds an
:class:`~msm_we_tpu_torch.optimization.OptimizedBinMapper` from a bank and
its mapping tables. They take numpy arrays only.
"""
from __future__ import annotations

import numpy as np

from .binning import RectilinearBinMapper
from .model import StratifiedClustersShim, _AggregateClustersShim
from .ops.pca import IdentityCoordinates, PCAModel, TICAModel
from .ops.stratified import StratifiedKmeans

__all__ = [
    "fitted_state_from_arrays",
    "tica_state_from_arrays",
    "aggregated_state_from_arrays",
    "optimized_mapper_from_arrays",
]


def _drop_derived(model):
    """Forget features, their caches and the dtrajs (the transform or the
    bank changed): they are recomputed on next use."""
    model._features = None
    model._raw_bins_cache = None
    model._pc_masks_cache = None
    model._dev_feats_cache = None
    model._device_flux_row_cache = None
    model._device_p1_cache = None
    model.dtrajs = model.pair_dtrajs = None
    model._parent_idx = model._child_idx = None


def tica_state_from_arrays(model, *, mean, components, scales):
    """Install a fitted TICA/VAMP transform (``mean`` (D,), ``components``
    (D, n), ``scales`` (n,)) as ``dimReduce`` would leave it."""
    model.coordinates = TICAModel(np.asarray(mean), np.asarray(components),
                                  np.asarray(scales), device=model.device)
    model.ndim = model.coordinates.output_dimension
    _drop_derived(model)
    return model


def aggregated_state_from_arrays(model, *, centers):
    """Install an aggregated k-means bank (``centers`` (K, d)) as
    ``cluster_coordinates(stratified=False)`` would leave it before its
    discretization. Call ``model.launch_discretization()`` next."""
    centers = np.asarray(centers, np.float32)
    model.clusters = _AggregateClustersShim(centers, device=model.device)
    model.clustering_method = "aggregated"
    model.n_clusters = len(centers)
    model._strat = None
    model._bin_mapper = None
    _drop_derived(model)
    return model


def fitted_state_from_arrays(model, *, centers, counts, center_bin, valid,
                             initialized, we_remap, bin_edges, pca_mean=None,
                             pca_components=None, pca_explained_variance=None,
                             seed=0):
    """Install a fitted PCA transform, stratified bank and rectilinear bin
    mapper into ``model`` (after ``initialize``/``get_iterations``), leaving
    it as ``cluster_coordinates`` would before its discretization.

    ``centers`` (K, d), ``counts`` (K,), ``center_bin`` (K,), ``valid``
    (K,) are the flat bank (``K = n_bins * k``, bins contiguous);
    ``initialized`` and ``we_remap`` are per WE bin; ``bin_edges`` is one
    ascending edge array per pcoord dimension. Without ``pca_components``
    the features are the processed coordinates themselves (the
    ``dim_reduce_method="none"`` identity). Call
    ``model.launch_discretization()`` next.
    """
    strat = _bank_from_arrays(centers, counts, center_bin, valid, initialized,
                              we_remap, seed, model.device)
    if pca_components is None:
        model.coordinates = IdentityCoordinates()
        model.ndim = strat.d
    else:
        components = np.asarray(pca_components)
        model.coordinates = PCAModel(
            np.asarray(pca_mean), components, np.asarray(pca_explained_variance),
            device=model.device,
        )
        model.ndim = components.shape[0]
    if model.ndim != strat.d:
        raise ValueError(
            f"centers have {strat.d} features, the transform {model.ndim}")

    model._bin_mapper = RectilinearBinMapper(bin_edges)
    model._strat = strat
    model.clusters = StratifiedClustersShim(model._bin_mapper, model, strat)
    model.clustering_method = "stratified"
    model.n_clusters = strat.n_bins * strat.k
    # Features follow the transform: recompute on next use
    _drop_derived(model)
    return model


def _bank_from_arrays(centers, counts, center_bin, valid, initialized,
                      we_remap, seed, device):
    """A :class:`StratifiedKmeans` holding the flat bank of the arrays."""
    centers = np.asarray(centers, np.float32)
    initialized = np.asarray(initialized, bool)
    n_bins = len(initialized)
    K, d = centers.shape
    if K % n_bins:
        raise ValueError(f"{K} centers do not split into {n_bins} bins")
    k = K // n_bins
    center_bin = np.asarray(center_bin, np.int32)
    if not np.array_equal(center_bin, np.repeat(np.arange(n_bins, dtype=np.int32), k)):
        raise ValueError("the bank must hold each bin's k centers contiguously")
    strat = StratifiedKmeans(n_bins, k, d, seed=seed, device=device)
    strat.centers = centers.copy()
    strat.counts = np.asarray(counts, np.float32).copy()
    strat.valid = np.asarray(valid, bool).copy()
    strat.initialized = initialized.copy()
    strat.we_remap = np.asarray(we_remap, np.int32).copy()
    strat._refresh_ids()
    return strat


def optimized_mapper_from_arrays(*, centers, counts, center_bin, valid,
                                 initialized, we_remap, bin_edges,
                                 microstate_mapper, nbins,
                                 n_original_pcoord_dims, basis_pcoord_bounds,
                                 target_pcoord_bounds, cluster_on_pcoord=False,
                                 seed=0, device="cuda"):
    """An ``OptimizedBinMapper`` over a stratified bank given as arrays (the
    layout of :func:`fitted_state_from_arrays`), its rectilinear base mapper
    (``bin_edges``), the ``microstate_mapper`` table (a dict or an array
    indexed by cluster id, basis and target last) and the basis/target
    bounds. ``device`` is where the clusterer assigns."""
    from .optimization import OptimizedBinMapper

    strat = _bank_from_arrays(centers, counts, center_bin, valid, initialized,
                              we_remap, seed, device)
    base = RectilinearBinMapper(bin_edges)
    if not isinstance(microstate_mapper, dict):
        microstate_mapper = np.asarray(microstate_mapper)
    return OptimizedBinMapper(
        nbins=int(nbins),
        n_original_pcoord_dims=int(n_original_pcoord_dims),
        target_pcoord_bounds=np.asarray(target_pcoord_bounds, float),
        basis_pcoord_bounds=np.asarray(basis_pcoord_bounds, float),
        previous_binmapper=base,
        microstate_mapper=microstate_mapper,
        stratified_clusterer=StratifiedClustersShim(base, None, strat),
        cluster_on_pcoord=cluster_on_pcoord,
    )
