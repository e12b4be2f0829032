"""Flux-matrix cleaning: SCC-based state removal, incremental
re-discretization, empty-bin remapping, and the clean-until-fixpoint loop.

Counterpart of ``organize_flux_cleaning``, ``organize_stratified``,
``incremental_rediscretize``, ``assign_rows_subset`` and
``organize_aggregated_simple`` in ``msm_we_tpu/cleaning.py``. The rows a
pass must re-score are assigned on the model's device (the H4-family
kernel on CUDA); the per-pass flux recompute is the host f64 bincount
when the updated ids are in hand. On a ``device_pipeline`` build whose ids
are still deferred, the bank surgery is the whole re-discretization: the
flux recompute and the pcoord sort are free to take their device routes
(``fluxmatrix.device_flux_lag0``, ``structures._get_cluster_centers_device``)
and the dtrajs stay deferred until a host consumer asks for them.
"""
from __future__ import annotations

import numpy as np

from ._logging import log
from .binning import find_nearest_bin
from .features import _feat_parent_rows


def organize_flux_cleaning(model, remove_and_rediscretize, max_passes=10,
                           host_flux=False):
    """Each pass: find strongly connected sets (with the artificial
    target->basis recycle edge), delete everything outside the largest via
    ``remove_and_rediscretize``, recompute the flux matrix at the new
    clustering, pcoord-sort and normalize. Repeats until the matrix is
    clean (re-discretization can itself disconnect states), at most
    ``max_passes`` times. ``host_flux`` recomputes each pass's flux with
    the host bincount even where the device route is open: after an
    incremental update the ids are in hand, and the device route would only
    assign every row again."""
    from .utils import find_connected_sets

    fmatrix_original = model.fluxMatrixRaw.copy()

    for _pass in range(max_passes):
        fmatrix = model.fluxMatrixRaw.copy()
        fmatrix[-1, -2] = 1.0
        connected_sets = find_connected_sets(fmatrix, directed=True)

        if len(connected_sets) == 1 and _pass > 0:
            break  # clean; keep the previous pass's results

        if len(connected_sets) == 1:
            log.info("Nothing to clean")
            states_to_remove = np.array([], dtype=int)
        else:
            states_to_remove = np.concatenate(connected_sets[1:]).astype(int)
            log.debug(f"Pass {_pass}: cleaning states {states_to_remove}")

        basis_target = {model.n_clusters, model.n_clusters + 1}
        if basis_target & set(states_to_remove.tolist()):
            raise RuntimeError(
                "The basis or target state is disconnected from the main "
                "flux network -- this data contains no transitions into "
                "the target (or out of the basis), so no steady-state "
                "model can be built from it. Use more iterations or a "
                "dataset with recycling events."
            )

        remove_and_rediscretize(states_to_remove)

        pcoord_sort_indices = model.get_cluster_centers()
        model.pcoord_sort_indices = pcoord_sort_indices
        model._flux_prefer_host = host_flux
        try:
            model.get_fluxMatrix(*model._fluxMatrixParams)
        finally:
            model._flux_prefer_host = False
        fluxMatrix = model.fluxMatrixRaw[
            np.ix_(pcoord_sort_indices, pcoord_sort_indices)
        ]
        model.fluxMatrix = fluxMatrix / fluxMatrix.sum()

    model.fluxMatrixRaw = fmatrix_original
    model.indBasis = np.array([model.n_clusters])
    model.indTargets = np.array([model.n_clusters + 1])
    model.nBins = model.n_clusters + 2
    model.update_sorted_cluster_centers()

    fcheck = model.fluxMatrix.copy()
    fcheck[-1, -2] = 1.0
    if len(find_connected_sets(fcheck, directed=True)) != 1:
        raise RuntimeError("Still not clean after cleaning!")


def organize_stratified(model, max_passes=10, incremental=True):
    """Stratified cleaning (reference ``organize_stratified``,
    ``_clustering.py:920-1142``): remove everything outside the largest
    strongly connected set, remap emptied WE bins, re-discretize,
    recompute, sort by mean pcoord, normalize.

    ``incremental`` (default) re-scores only the segments whose winning
    center was removed or whose WE-bin remap changed; everyone else is
    relabeled through the old -> new id map (removing centers a row did not
    win cannot change its argmin). ``incremental=False`` re-discretizes
    every row; both give identical ids.
    """
    strat = model._strat

    def remove_and_rediscretize(states_to_remove):
        real_removals = states_to_remove[states_to_remove < strat.n_total_clusters]
        old_remap = strat.we_remap.copy()
        old_global = strat.global_id.copy()
        old_total = strat.n_total_clusters

        emptied = strat.remove_global_clusters(real_removals)
        # Bins never initialized also count as empty
        for b in range(strat.n_bins):
            if not strat.initialized[b]:
                emptied.add(b)

        model.n_clusters = strat.n_total_clusters
        if model.n_clusters <= 1:
            raise RuntimeError(
                "All clusters would be cleaned! You probably need more data, "
                "fewer clusters, or both."
            )
        populated = np.setdiff1d(np.arange(strat.n_bins), sorted(emptied))
        if emptied:
            log.warning(
                f"All clusters were cleaned from bins {emptied} (normal "
                "for source/target WE bins)."
            )
        for b in emptied:
            strat.set_remap(
                int(b), find_nearest_bin(model._bin_mapper, int(b), populated)
            )
        if incremental and model._parent_idx is not None:
            incremental_rediscretize(model, strat, old_remap, old_global, old_total)
        elif model.device_pipeline and model._parent_idx is None:
            # Deferred ids: the bank surgery above is the whole
            # re-discretization. The next flux recompute assigns against
            # the updated bank, and a later host consumer materializes the
            # dtrajs once, against the final bank (_ensure_discretized)
            model.dtrajs = None
            model.pair_dtrajs = None
        else:
            model.launch_discretization()

    organize_flux_cleaning(
        model, remove_and_rediscretize, max_passes=max_passes,
        # Only with the updated ids in hand; a deferred build stays free to
        # take the device route in every pass
        host_flux=incremental and model._parent_idx is not None,
    )
    model.cluster_mapping = {x: x for x in range(model.n_clusters + 2)}


def incremental_rediscretize(model, strat, old_remap, old_global, old_total):
    """Patch the stored dtrajs after center removal/remap instead of
    re-discretizing every segment: survivors (and basis/target rows, whose
    stored ids already carry the predict-order priority) relabel through
    one old-state -> new-state table; rows whose winner was removed, or
    whose ``we_remap`` target changed, are re-scored."""
    feats = model._featurize_all()
    pbins_raw, cbins_raw = model._raw_we_bins()
    masks = model._pc_masks()
    remap_changed = strat.we_remap != old_remap
    any_remap_changed = bool(remap_changed.any())

    table = np.full(old_total + 2, -1, np.int32)
    still = np.flatnonzero(strat.valid)
    table[old_global[still]] = strat.global_id[still]
    table[old_total] = strat.basis_cluster_index
    table[old_total + 1] = strat.target_cluster_index

    def update(idx_old, rows_of, raw_bins, is_b, is_t):
        new_idx = table[idx_old]
        affected = new_idx < 0
        if any_remap_changed:
            affected |= remap_changed[raw_bins] & ~(is_b | is_t)
        if affected.any():
            sub = np.flatnonzero(affected)
            new_idx[sub] = assign_rows_subset(
                model, strat, rows_of(sub), strat.we_remap[raw_bins[sub]]
            )
        if not (new_idx >= 0).all():
            raise RuntimeError("incremental re-discretization left rows unassigned")
        return new_idx

    parent_idx = update(
        model._parent_idx, lambda r: _feat_parent_rows(feats, r),
        pbins_raw, masks["basis_p"], masks["target_p"],
    )
    child_idx = update(
        model._child_idx, lambda r: feats["child"][r], cbins_raw,
        masks["basis_c"], masks["target_c"],
    )
    model._store_dtrajs(parent_idx, child_idx)


def assign_rows_subset(model, strat, X, bins_eff):
    """Stratified global ids for a (usually small) row subset, in the
    scoring family the full discretization used (``model._scored_on_host``,
    recorded by ``launch_discretization``): the two families round
    near-ties differently, and incremental cleaning must equal a full
    re-discretization."""
    return strat.global_id[strat.assign_flat(X, bins_eff, model._scored_on_host)]


def organize_aggregated_simple(model, max_passes=10, incremental=True):
    """Aggregate-path cleaning: the SCC criterion of
    :func:`organize_flux_cleaning` applied to the aggregate bank (the
    reference's ``organize_aggregated`` is deprecated and raises,
    ``_fluxmatrix.py:452-454``).

    ``incremental`` (default): survivors relabel through the old -> new id
    map (removing centers a row did not win cannot change its argmin);
    only rows assigned to a removed center are re-scored against the kept
    bank. ``incremental=False`` re-discretizes every row; both give
    identical ids."""
    from .model import _AggregateClustersShim

    def remove_and_rediscretize(states_to_remove):
        old_n = model.n_clusters
        keep = np.setdiff1d(np.arange(old_n), states_to_remove)
        relabel = np.full(old_n, -1, np.int64)
        relabel[keep] = np.arange(len(keep))
        model.removed_clusters = states_to_remove
        model.clusters = _AggregateClustersShim(
            model.clusters.cluster_centers_[keep], device=model.device
        )
        model.n_clusters = len(keep)
        if not incremental or model._parent_idx is None:
            model._discretize_all_aggregated()
        elif len(keep) < old_n:
            feats = model._featurize_all()

            def upd(idx, rows_of):
                new_idx = relabel[idx]
                aff = np.flatnonzero(new_idx < 0)
                if len(aff):
                    new_idx[aff] = model.clusters.predict(rows_of(aff))
                return new_idx

            model._store_dtrajs(
                upd(model._parent_idx, lambda r: _feat_parent_rows(feats, r)),
                upd(model._child_idx, lambda r: feats["child"][r]),
            )

    organize_flux_cleaning(
        model, remove_and_rediscretize, max_passes=max_passes,
        host_flux=incremental,
    )
    model.removed_clusters = []
