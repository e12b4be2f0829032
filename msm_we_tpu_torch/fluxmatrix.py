"""Flux-matrix estimation: the host float64 bincount route, at any lag.

Counterpart of ``get_flux_matrix`` and ``get_iter_flux_matrix`` in
``msm_we_tpu/fluxmatrix.py``. The ids come from the device
discretization; the (n+2)^2 accumulation is one f64 bincount on the host
(WE weights span hundreds of decades). The fused device flux route
(``device_flux_lag0``) is not ported yet (ROADMAP, queue 1: device flux
and stats route).
"""
from __future__ import annotations

import numpy as np

from ._logging import log


def get_flux_matrix(model, n_lag, first_iter=1, last_iter=None,
                    iters_to_use=None):
    """Weighted flux matrix over iterations, normalized by the number of
    iterations used (reference ``get_fluxMatrix``,
    ``_fluxmatrix.py:166-345``). Stores ``model.fluxMatrixRaw``.

    ``n_lag > 0`` builds (n_lag+1)-tau transitions: the start state is the
    ancestor's parent-row id ``n_lag`` iterations back (already
    discretized), lineages recycled inside the window depart from the
    basis state, and a zero ancestor weight (bad coordinates at the lagged
    frame) zeroes the transition.
    """
    model._fluxMatrixParams = [n_lag, first_iter, last_iter, iters_to_use]
    if iters_to_use is None:
        if last_iter is None:
            last_iter = model.maxIter
        iters_to_use = range(max(first_iter + 1, n_lag + 1), last_iter)
    in_range = [i for i in iters_to_use if i - n_lag >= 1 and i < model.maxIter]
    if len(in_range) != len(iters_to_use):
        dropped = sorted(set(iters_to_use) - set(in_range))
        log.warning(
            f"Dropping iterations {dropped} from the flux matrix: outside "
            f"the usable range [{n_lag + 1}, {model.maxIter - 1}] at "
            f"n_lag={n_lag}"
        )
    iters_to_use = in_range
    if not iters_to_use:
        raise ValueError(
            f"No iterations have enough history for n_lag={n_lag} "
            f"(first_iter={first_iter}, last_iter={last_iter})"
        )
    model.n_lag = n_lag
    model.errorWeight = 0.0
    model.errorCount = 0

    feats = model._featurize_all()
    model._ensure_discretized()
    n_states = model.n_clusters + 2
    masks = model._pc_masks()
    if n_lag == 0:
        start_idx, end_idx, weights = _lag0_ids(model, feats, masks, iters_to_use)
    else:
        start_idx, end_idx, weights = _lagged_ids(
            model, feats, masks, iters_to_use, n_lag
        )
    flat = start_idx * n_states + end_idx
    fm = np.bincount(
        flat, weights=weights, minlength=n_states * n_states
    ).reshape(n_states, n_states)
    model.fluxMatrixRaw = fm / len(iters_to_use)


def _lag0_ids(model, feats, masks, iters_to_use):
    """(start, end, weight) of every lag-0 transition in the window, with
    the flux-order basis/target overrides."""
    n_iters_all = len(feats["offsets"]) - 1
    u = np.unique(iters_to_use)
    if (
        len(u) == len(iters_to_use)
        and u[-1] - u[0] + 1 == len(u)
        and u[0] >= 1
        and u[-1] <= n_iters_all
    ):
        # Rows are ordered by iteration: a contiguous range is a slice
        offs = feats["offsets"]
        sel = slice(int(offs[u[0] - 1]), int(offs[u[-1]]))
    else:
        sel = np.flatnonzero(np.isin(feats["iteration"], iters_to_use))
    weights = feats["weights"][sel]
    start_idx = np.asarray(model._parent_idx[sel], dtype=np.int64)
    end_idx = np.asarray(model._child_idx[sel], dtype=np.int64)
    stratified = model.clustering_method == "stratified"
    strat = model._strat
    if stratified and strat is not None and model.n_clusters == strat.n_total_clusters:
        # Stored stratified dtrajs carry the predict-order overrides (target
        # wins) in the current numbering; the flux build's basis-wins order
        # differs only on rows inside both regions
        if masks["overlap_p"] is not None:
            start_idx = start_idx.copy()
            start_idx[masks["overlap_p"][sel]] = model.n_clusters
        if masks["overlap_c"] is not None:
            end_idx = end_idx.copy()
            end_idx[masks["overlap_c"][sel]] = model.n_clusters
    else:
        # Aggregated ids carry no overrides, and pre-cleaning stratified
        # ids carry the live-total states: apply the flux-order overrides
        # at the nominal numbering (end-in-target, start-in-target for
        # stratified clustering only, then basis)
        end_idx = np.where(masks["target_c"][sel], model.n_clusters + 1, end_idx)
        if stratified:
            start_idx = np.where(masks["target_p"][sel], model.n_clusters + 1,
                                 start_idx)
        start_idx = np.where(masks["basis_p"][sel], model.n_clusters, start_idx)
        end_idx = np.where(masks["basis_c"][sel], model.n_clusters, end_idx)
    return start_idx, end_idx, weights


def _lagged_ids(model, feats, masks, iters_to_use, n_lag):
    """(start, end, weight) of every lag-``n_lag`` transition ending in the
    window's iterations, with the flux-order overrides at the nominal
    numbering."""
    offsets = feats["offsets"]
    starts, ends, ws, b0s, t0s, b1s, t1s, warps = ([] for _ in range(8))
    for it in iters_to_use:
        anc, warped = model._dataset.ancestor_ids(it, n_lag)
        rows_now = np.arange(offsets[it - 1], offsets[it])
        rows_lag = offsets[it - n_lag - 1] + np.where(warped, 0, anc)
        starts.append(model._parent_idx[rows_lag])
        ends.append(model._child_idx[rows_now])
        w_now = feats["weights"][rows_now].copy()
        w_now[(feats["weights"][rows_lag] == 0.0) & ~warped] = 0.0
        ws.append(w_now)
        b0s.append(masks["basis_p"][rows_lag])
        t0s.append(masks["target_p"][rows_lag])
        b1s.append(masks["basis_c"][rows_now])
        t1s.append(masks["target_c"][rows_now])
        warps.append(warped)
    start_idx = np.concatenate(starts).astype(np.int64)
    end_idx = np.concatenate(ends).astype(np.int64)
    warped_all = np.concatenate(warps)
    # Recycled lineages depart from the basis state whatever the ancestor
    # pcoord gathered at the safe index says
    basis_start = np.concatenate(b0s) | warped_all
    target_start = np.concatenate(t0s) & ~warped_all
    # Reference composition: end-in-target, start-in-target (nominal
    # target index; stratified clustering only), then basis unconditionally
    # (basis wins overlaps)
    end_idx = np.where(np.concatenate(t1s), model.n_clusters + 1, end_idx)
    if model.clustering_method == "stratified":
        start_idx = np.where(target_start, model.n_clusters + 1, start_idx)
    start_idx = np.where(basis_start, model.n_clusters, start_idx)
    end_idx = np.where(np.concatenate(b1s), model.n_clusters, end_idx)
    return start_idx, end_idx, np.concatenate(ws)


def get_iter_flux_matrix(model, n_iter):
    """Single-iteration lag-0 flux matrix, not normalized (reference
    ``_fluxmatrix.py:21-72``)."""
    d = model._dataset.iter_data(n_iter)
    model._ensure_discretized()
    feats = model._featurize_all()
    offs = feats["offsets"]
    weights = feats["weights"][offs[n_iter - 1]: offs[n_iter]]
    pairs = np.asarray(model.pair_dtrajs[n_iter - 1])
    start_idx, end_idx = pairs[:, 0].copy(), pairs[:, 1].copy()
    n_states = model.n_clusters + 2
    end_idx = np.where(
        model.is_WE_target(d["pcoord1"]), model.n_clusters + 1, end_idx
    )
    # Stratified predict sends target-region parents to its own target id:
    # route them to the nominal target row, before start-in-basis (basis
    # wins overlaps). Aggregated ids carry no overrides.
    if model.clustering_method == "stratified":
        start_idx = np.where(
            model.is_WE_target(d["pcoord0"]), model.n_clusters + 1, start_idx
        )
    start_idx = np.where(model.is_WE_basis(d["pcoord0"]), model.n_clusters, start_idx)
    end_idx = np.where(model.is_WE_basis(d["pcoord1"]), model.n_clusters, end_idx)
    flat = start_idx.astype(np.int64) * n_states + end_idx.astype(np.int64)
    return np.bincount(flat, weights=weights, minlength=n_states**2).reshape(
        n_states, n_states
    )
