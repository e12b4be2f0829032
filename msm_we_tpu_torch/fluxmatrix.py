"""Flux-matrix estimation: the lag-0 host float64 bincount route.

Counterpart of ``msm_we_tpu/fluxmatrix.py::get_flux_matrix`` at lag 0. The
ids come from the device discretization; the (n+2)^2 accumulation is one
f64 bincount on the host (WE weights span hundreds of decades). The fused
device flux route (``device_flux_lag0``) and lagged transitions are not
ported yet (ROADMAP, queue 1).
"""
from __future__ import annotations

import numpy as np

from ._logging import log


def get_flux_matrix(model, n_lag, first_iter=1, last_iter=None,
                    iters_to_use=None):
    """Weighted lag-0 flux matrix over iterations, normalized by the number
    of iterations used (reference ``get_fluxMatrix``,
    ``_fluxmatrix.py:166-345``). Stores ``model.fluxMatrixRaw``."""
    if n_lag != 0:
        raise NotImplementedError(
            "lagged flux matrices (n_lag > 0) are not ported yet "
            "(ROADMAP, queue 1: lagged flux)"
        )
    model._fluxMatrixParams = [n_lag, first_iter, last_iter, iters_to_use]
    if iters_to_use is None:
        if last_iter is None:
            last_iter = model.maxIter
        iters_to_use = range(first_iter + 1, last_iter)
    in_range = [i for i in iters_to_use if i >= 1 and i < model.maxIter]
    if len(in_range) != len(iters_to_use):
        dropped = sorted(set(iters_to_use) - set(in_range))
        log.warning(
            f"Dropping iterations {dropped} from the flux matrix: outside "
            f"the usable range [1, {model.maxIter - 1}]"
        )
    iters_to_use = in_range
    if not iters_to_use:
        raise ValueError(
            f"No usable iterations (first_iter={first_iter}, last_iter={last_iter})"
        )
    model.n_lag = 0
    model.errorWeight = 0.0
    model.errorCount = 0

    feats = model._featurize_all()
    n_states = model.n_clusters + 2
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
    masks = model._pc_masks()
    start_idx = np.asarray(model._parent_idx[sel], dtype=np.int64)
    end_idx = np.asarray(model._child_idx[sel], dtype=np.int64)
    strat = model._strat
    if model.n_clusters == strat.n_total_clusters:
        # Stored dtrajs carry the predict-order overrides (target wins) in
        # the current numbering; the flux build's basis-wins order differs
        # only on rows inside both regions
        if masks["overlap_p"] is not None:
            start_idx = start_idx.copy()
            start_idx[masks["overlap_p"][sel]] = model.n_clusters
        if masks["overlap_c"] is not None:
            end_idx = end_idx.copy()
            end_idx[masks["overlap_c"][sel]] = model.n_clusters
    else:
        # Pre-cleaning the stored basis/target ids use the live total:
        # re-apply the flux-order overrides at the nominal numbering
        end_idx = np.where(masks["target_c"][sel], model.n_clusters + 1, end_idx)
        start_idx = np.where(masks["target_p"][sel], model.n_clusters + 1, start_idx)
        start_idx = np.where(masks["basis_p"][sel], model.n_clusters, start_idx)
        end_idx = np.where(masks["basis_c"][sel], model.n_clusters, end_idx)

    flat = start_idx * n_states + end_idx
    fm = np.bincount(
        flat, weights=weights, minlength=n_states * n_states
    ).reshape(n_states, n_states)
    model.fluxMatrixRaw = fm / len(iters_to_use)
