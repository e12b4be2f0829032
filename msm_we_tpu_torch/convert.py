"""Load fitted state from plain arrays into a port ``modelWE``.

``fitted_state_from_arrays`` installs what ``dimReduce`` and
``cluster_coordinates`` would have fitted -- the PCA transform, the
stratified center bank and the WE bin mapper -- from numpy arrays, so a
build's later stages (discretization -> flux -> cleaning -> analysis) can
run from the fitted state of another build, for example the JAX package's.
``tica_state_from_arrays`` installs a fitted TICA/VAMP transform and
``aggregated_state_from_arrays`` an aggregated k-means bank the same way.
They take numpy arrays only.
"""
from __future__ import annotations

import numpy as np

from .binning import RectilinearBinMapper
from .model import StratifiedClustersShim, _AggregateClustersShim
from .ops.pca import PCAModel, TICAModel
from .ops.stratified import StratifiedKmeans

__all__ = [
    "fitted_state_from_arrays",
    "tica_state_from_arrays",
    "aggregated_state_from_arrays",
]


def _drop_derived(model):
    """Forget features, their caches and the dtrajs (the transform or the
    bank changed): they are recomputed on next use."""
    model._features = None
    model._raw_bins_cache = None
    model._pc_masks_cache = None
    model._dev_feats_cache = None
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


def fitted_state_from_arrays(model, *, pca_mean, pca_components,
                             pca_explained_variance, centers, counts,
                             center_bin, valid, initialized, we_remap,
                             bin_edges, seed=0):
    """Install a fitted PCA transform, stratified bank and rectilinear bin
    mapper into ``model`` (after ``initialize``/``get_iterations``), leaving
    it as ``cluster_coordinates`` would before its discretization.

    ``centers`` (K, d), ``counts`` (K,), ``center_bin`` (K,), ``valid``
    (K,) are the flat bank (``K = n_bins * k``, bins contiguous);
    ``initialized`` and ``we_remap`` are per WE bin; ``bin_edges`` is one
    ascending edge array per pcoord dimension. Call
    ``model.launch_discretization()`` next.
    """
    components = np.asarray(pca_components)
    model.coordinates = PCAModel(
        np.asarray(pca_mean), components, np.asarray(pca_explained_variance),
        device=model.device,
    )
    model.ndim = components.shape[0]

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
    if components.shape[0] != d:
        raise ValueError(f"centers have {d} features, the transform {components.shape[0]}")

    strat = StratifiedKmeans(n_bins, k, d, seed=seed, device=model.device)
    strat.centers = centers.copy()
    strat.counts = np.asarray(counts, np.float32).copy()
    strat.valid = np.asarray(valid, bool).copy()
    strat.initialized = initialized.copy()
    strat.we_remap = np.asarray(we_remap, np.int32).copy()
    strat._refresh_ids()

    model._bin_mapper = RectilinearBinMapper(bin_edges)
    model._strat = strat
    model.clusters = StratifiedClustersShim(model._bin_mapper, model, strat)
    model.clustering_method = "stratified"
    model.n_clusters = n_bins * k
    # Features follow the transform: recompute on next use
    _drop_derived(model)
    return model
