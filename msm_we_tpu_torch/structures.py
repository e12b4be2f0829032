"""Cluster-center statistics and cluster-structure export.

Counterpart of ``get_cluster_centers`` (host and device routes) and
``update_cluster_structures`` in ``msm_we_tpu/structures.py`` (reference
``_clustering.py:1528-1599, 1398-1526``). The host route is grouped array
passes (bincount, sort + ``ufunc.reduceat``) over the host dtrajs, in
float64. The device route (opt-in, for builds whose ids are still
deferred) assigns the child rows on the model's device and reduces the
child pcoords per cluster there (``step.cluster_stats``, f64 sums of the
f32 pcoords; over a mesh ``parallel.sharded.build_sharded_cluster_stats``,
each rank on its row block, the tables reduced over 'data'); only four
small tables come back.
"""
from __future__ import annotations

import os

import numpy as np

from ._logging import log

#: Row count from which a ``device_pipeline`` build with still-deferred ids
#: computes the per-cluster pcoord statistics on the device instead of
#: materializing host dtrajs (default: never)
DEVICE_STATS_MIN_ROWS_ENV = "MSM_WE_TPU_DEVICE_STATS_MIN_ROWS"


def _device_stats_route(model):
    if not model.device_pipeline:
        return False
    if model._child_idx is not None:
        return False  # ids already on the host: the f64 host path is exact
    if model._strat is None:
        return False
    n_rows = int(model._featurize_all()["offsets"][-1])
    return n_rows >= int(os.environ.get(DEVICE_STATS_MIN_ROWS_ENV, str(10**18)))


def get_cluster_centers(model):
    """Mean/min/max child-pcoord per cluster; returns the pcoord-sort
    permutation (reference ``_clustering.py:1528-1599``).

    Basis/target rows get NaN centers, so the stable argsort pins them to
    the last two positions -- the property that makes
    ``indBasis = [n_clusters]`` correct after sorting.

    A ``device_pipeline`` build with deferred ids and at least
    ``MSM_WE_TPU_DEVICE_STATS_MIN_ROWS`` rows takes the device route
    (:func:`_get_cluster_centers_device`); a failure there surfaces, it is
    not retried on the host.
    """
    if _device_stats_route(model):
        return _get_cluster_centers_device(model)

    n = model.n_clusters
    centers = np.full((n + 2, model.pcoord_ndim), np.nan)
    crange = np.full((n + 2, model.pcoord_ndim, 2), np.nan)

    feats = model._featurize_all()
    model._ensure_discretized()
    child_idx = model._child_idx
    p1 = feats["pcoord1"]

    # Grouped mean/min/max in one pass per statistic (bincount for
    # count/sum; a group sort + ufunc.reduceat for min/max -- ufunc.at
    # is an unbuffered scalar loop, ~3 s at 2M rows where the sort-based
    # grouping is ~0.3 s) instead of an O(n_clusters * N) masked python
    # loop -- this runs inside every cleaning pass
    in_range = np.flatnonzero((child_idx >= 0) & (child_idx < n))
    idx = child_idx[in_range]
    vals = p1[in_range]
    good = ~np.isnan(vals)
    counts = np.zeros((n, model.pcoord_ndim))
    sums = np.zeros((n, model.pcoord_ndim))
    mins = np.full((n, model.pcoord_ndim), np.inf)
    maxs = np.full((n, model.pcoord_ndim), -np.inf)
    for dim in range(model.pcoord_ndim):
        g = np.flatnonzero(good[:, dim])
        gi = idx[g]
        gv = vals[g, dim]
        counts[:, dim] = np.bincount(gi, minlength=n)
        sums[:, dim] = np.bincount(gi, weights=gv, minlength=n)
        if len(gi):
            order_g = np.argsort(gi, kind="stable")
            gis = gi[order_g]
            gvs = gv[order_g]
            starts = np.r_[0, np.flatnonzero(np.diff(gis)) + 1]
            present = gis[starts]
            mins[present, dim] = np.minimum.reduceat(gvs, starts)
            maxs[present, dim] = np.maximum.reduceat(gvs, starts)
    populated = counts > 0
    centers[:n][populated] = sums[populated] / counts[populated]
    crange[:n, :, 0][populated] = mins[populated]
    crange[:n, :, 1][populated] = maxs[populated]
    empty = np.flatnonzero(~populated.any(axis=1))
    for cluster in empty:
        log.warning(f"No trajectories in cluster {cluster}!")

    order = np.argsort(centers[:, 0], kind="stable")
    model.targetRMSD_centers = centers[order]
    model.targetRMSD_minmax = crange[order]
    return order


def _device_p1(model, mesh=None):
    """This rank's row block of the child pcoords as an (n, ndim) f32
    tensor on the mesh's device (every row on one device), padded with NaN
    (excluded from the statistics), cached per feature set and mesh
    (default: the model's)."""
    mesh = model._active_mesh() if mesh is None else mesh
    feats = model._featurize_all()
    cache = getattr(model, "_device_p1_cache", None)
    if cache is not None and cache[0] is feats and cache[2] is mesh:
        return cache[1]
    p1 = np.asarray(feats["pcoord1"], dtype=np.float32)
    if p1.ndim == 1:
        p1 = p1[:, None]
    dev = mesh.rows(p1, float("nan"))
    model._device_p1_cache = (feats, dev, mesh)
    return dev


def _get_cluster_centers_device(model):
    """Device route of :func:`get_cluster_centers`: the child ids
    (``discretization.device_child_assign``, one H4 launch on CUDA) and the
    child pcoords stay on the device; four ``(k_max + 1, ndim)`` tables come
    back (reduced over the mesh's 'data' axis: each rank holds its row
    block).

    Same semantics as the host route (NaN pcoords excluded per dimension,
    NaN centers for empty, basis and target rows, stable pcoord argsort)
    with f64 sums of f32 pcoords: the means agree with the host f64 ones to
    the f32 rounding of each pcoord, so two clusters whose means lie closer
    than that may swap places in the sort."""
    from .discretization import device_child_assign
    from .parallel.sharded import build_sharded_cluster_stats

    strat = model._strat
    n = model.n_clusters
    ndim = int(model.pcoord_ndim)
    k_max = int(strat.n_bins * strat.k)
    mesh = model._active_mesh()

    cid_dev = device_child_assign(model, strat)
    stats = build_sharded_cluster_stats(mesh, k_max)(
        cid_dev, _device_p1(model, mesh), n)
    counts, sums, vmin, vmax = (
        t[:n].cpu().numpy().astype(np.float64) for t in stats
    )

    centers = np.full((n + 2, ndim), np.nan)
    crange = np.full((n + 2, ndim, 2), np.nan)
    populated = counts > 0
    centers[:n][populated] = sums[populated] / counts[populated]
    crange[:n, :, 0][populated] = vmin[populated]
    crange[:n, :, 1][populated] = vmax[populated]
    for cluster in np.flatnonzero(~populated.any(axis=1)):
        log.warning(f"No trajectories in cluster {cluster}!")

    order = np.argsort(centers[:, 0], kind="stable")
    model.targetRMSD_centers = centers[order]
    model.targetRMSD_minmax = crange[order]
    return order


def update_cluster_structures(model, build_pcoord_cache=False):
    """Map each cluster to its member structures, weights, and provenance
    (reference ``_clustering.py:1398-1526``).

    Grouping is one stable argsort + split over the concatenated arrays
    instead of the reference's per-segment python loop -- O(N log N)
    array work, so it stays off the critical path even at millions of
    segments (the restart plugin calls it on every restart).
    """
    assert model.clusters is not None, "Clusters have not been computed!"
    model._ensure_discretized()

    coords_parts, weights_parts, dtraj_parts = [], [], []
    iter_parts, segidx_parts, westidx_parts, pcoord_parts = [], [], [], []
    for iteration in range(1, model.maxIter - 1):
        d = model._dataset.iter_data(iteration)
        coords_parts.append(model._dataset._iter_frame_block(iteration, -1))
        weights_parts.append(d["weights"])
        dtraj_parts.append(np.asarray(model.dtrajs[iteration - 1]))
        iter_parts.append(np.full(d["n_segs"], iteration))
        segidx_parts.append(d["seg_idx"])
        westidx_parts.append(d["west_idx"])
        if build_pcoord_cache:
            pcoord_parts.append(d["pcoord1"])

    if not dtraj_parts:  # fewer than 3 usable iterations: nothing to map
        model.cluster_structures = {}
        model.cluster_structure_weights = {}
        model.structure_iteration_segments = {}
        model.pcoord_cache = {} if build_pcoord_cache else None
        return

    dtraj = np.concatenate(dtraj_parts)
    order = np.argsort(dtraj, kind="stable")
    sorted_clusters = dtraj[order]
    uniq, starts = np.unique(sorted_clusters, return_index=True)
    bounds = np.append(starts[1:], len(sorted_clusters))

    coords = np.concatenate(coords_parts)[order]
    weights = np.concatenate(weights_parts)[order]
    iters = np.concatenate(iter_parts)[order]
    segidx = np.concatenate(segidx_parts)[order]
    westidx = np.concatenate(westidx_parts)[order]
    pcoords = np.concatenate(pcoord_parts)[order] if build_pcoord_cache else None

    cluster_structures = {}
    cluster_structure_weights = {}
    structure_iteration_segments = {}
    pcoord_cache = {} if build_pcoord_cache else None
    for c, a, b in zip(uniq, starts, bounds):
        c = int(c)
        cluster_structures[c] = list(coords[a:b])
        cluster_structure_weights[c] = list(weights[a:b])
        structure_iteration_segments[c] = [
            [int(it), int(si), model.fileList[int(wi)]]
            for it, si, wi in zip(iters[a:b], segidx[a:b], westidx[a:b])
        ]
        if build_pcoord_cache:
            pcoord_cache[c] = list(pcoords[a:b])

    model.cluster_structures = cluster_structures
    model.cluster_structure_weights = cluster_structure_weights
    model.structure_iteration_segments = structure_iteration_segments
    model.pcoord_cache = pcoord_cache
