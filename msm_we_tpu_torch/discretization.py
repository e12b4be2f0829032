"""Discretization engine: assignment of every segment pair to stratified
cluster ids on the model's device, and the streaming-clustering batch
runner.

Counterpart of ``msm_we_tpu/discretization.py``. The pair and single
(dedup) routes run the sharded programs of ``parallel/sharded.py`` over the
model's mesh (``model._active_mesh()``): each rank scores its row block and
the ids are gathered over the mesh's 'data' axis. On one device (the (1, 1)
mesh) each program is one launch of the H4-family kernel,
``ops/stratified_assign.py::pair_assign``, with the predict-order override
epilogue. Ids are identical to the JAX package's up to near-ties.
"""
from __future__ import annotations

import numpy as np
import torch

from ._logging import log
from .features import _feat_parent_rows, mesh_row_feats
from .parallel.sharded import build_sharded_pair_assign, build_sharded_single_assign
from .tracing import collector, count, span


def _check_live_centers(strat, pbins, cbins):
    """A present (remapped) WE bin with no live centers would give junk
    ids on the device; ``StratifiedKmeans.check_live_bins`` raises."""
    strat.check_live_bins(np.concatenate([pbins, cbins]))


@span("discretize")
def launch_discretization(model):
    """Discretize every iteration's parent and child features in one pass
    (the reference's per-iteration fan-out, ``_clustering.py:1144-1242``)
    and store the dtrajs.

    ``model.device_pipeline`` picks the route: the pair route
    (:func:`pair_discretize`, one or two kernel launches over the
    device-resident features), or the predict route, which sends the 2N
    concatenated parent and child rows through ``StratifiedKmeans.predict``
    in one call (on CUDA from ``HOST_BATCH_THRESHOLD`` rows up: one H4
    launch through ``ops.kmeans.masked_assign``). Both give the same ids.
    The scoring family is recorded in ``model._scored_on_host`` for
    cleaning's re-scores.
    """
    parent_bins, child_bins = model._raw_we_bins()
    strat = model._strat
    if model.device_pipeline:
        pidx, cidx = pair_discretize(model, strat, parent_bins, child_bins)
        model._scored_on_host = False
    else:
        feats = model._featurize_all()
        masks = model._pc_masks()
        n = len(parent_bins)
        X = np.concatenate([feats["parent"], feats["child"]])
        model._scored_on_host = strat.scores_on_host(len(X))
        both = strat.predict(
            X, np.concatenate([parent_bins, child_bins]),
            is_basis=np.concatenate([masks["basis_p"], masks["basis_c"]]),
            is_target=np.concatenate([masks["target_p"], masks["target_c"]]),
        )
        pidx, cidx = both[:n], both[n:]
    model._store_dtrajs(pidx, cidx)


def device_child_assign(model, strat):
    """Child-row cluster ids (predict-order overrides) of this rank's row
    block as a device tensor (``build_sharded_single_assign`` over the
    model's mesh; every row on one device: one kernel launch over the
    device-resident child features). Padded rows get id 0."""
    mesh = model._active_mesh()
    _pb, child_bins = model._raw_we_bins()
    cbins = strat.we_remap[child_bins].astype(np.int32)
    strat.check_live_bins(cbins)
    masks = model._pc_masks()
    _fp, fc_blk = mesh_row_feats(model, mesh, need_parent=False)
    return build_sharded_single_assign(mesh, strat.n_total_clusters + 2)(
        fc_blk, mesh.rows(cbins, -1), mesh.rows(masks["basis_c"], False),
        mesh.rows(masks["target_c"], False), *strat.compact_bank_device(),
    )


def pair_discretize(model, strat, parent_bins, child_bins):
    """Parent and child ids for every row, from the device-resident
    feature arrays (``sharded_pair_discretize`` in JAX): each rank of the
    model's mesh scores its row block, the blocks are gathered over 'data'.
    Returns host int32 ``(pidx, cidx)``, equal on every rank.

    Dedup fast path: under WE continuity parent row i is a bit-copy of
    child row src[i]; when its WE bin and basis/target flags also agree
    with that child row (checked here), its id IS the child's. Then only
    the N child rows are scored on the device and the parent ids are a
    host gather; the disagreeing and fallback rows (iteration 1, recycled
    parents) are scored by a second, small launch.
    """
    feats = model._featurize_all()
    mesh = model._active_mesh()
    N = len(parent_bins)
    pbins = strat.we_remap[parent_bins].astype(np.int32)
    cbins = strat.we_remap[child_bins].astype(np.int32)
    _check_live_centers(strat, pbins, cbins)
    masks = model._pc_masks()
    basis_p, basis_c = masks["basis_p"], masks["basis_c"]
    target_p, target_c = masks["target_p"], masks["target_c"]
    n_states = strat.n_total_clusters + 2

    src = getattr(feats, "_parent_src", None)
    direct = s = None
    if src is not None:
        s = np.maximum(src, 0)
        agree = (
            (src >= 0)
            & (pbins == cbins[s])
            & (basis_p == basis_c[s])
            & (target_p == target_c[s])
        )
        direct = np.flatnonzero(~agree)
    if direct is not None and len(direct) <= max(N // 4, 1):
        cid = mesh.gather_rows(device_child_assign(model, strat), N).cpu().numpy()
        pid = cid[s]
        if len(direct):
            # The disagreeing rows, split over 'data' in turn
            single = build_sharded_single_assign(mesh, n_states)
            pid[direct] = mesh.gather_rows(single(
                mesh.rows(_feat_parent_rows(feats, direct), 0.0),
                mesh.rows(pbins[direct], -1), mesh.rows(basis_p[direct], False),
                mesh.rows(target_p[direct], False), *strat.compact_bank_device(),
            ), len(direct)).cpu().numpy()
        return np.ascontiguousarray(pid), cid

    fp_blk, fc_blk = mesh_row_feats(model, mesh, need_parent=True)
    pid, cid = build_sharded_pair_assign(mesh, n_states, with_target_p=True)(
        fp_blk, fc_blk, mesh.rows(pbins, -1), mesh.rows(cbins, -1),
        mesh.rows(basis_p, False), mesh.rows(basis_c, False),
        mesh.rows(target_c, False), *strat.compact_bank_device(),
        mesh.rows(target_p, False),
    )
    return (mesh.gather_rows(pid, N).cpu().numpy(),
            mesh.gather_rows(cid, N).cpu().numpy())


@span("cluster_fold")
def run_streaming_batches(model, strat, feats, batches, delegated,
                          bin_mapper, all_filled, iters_to_use,
                          scan_small_batches=False):
    """Execute the streaming-clustering batch plan.

    Batches are classified on the host (a bin seeds when it is
    uninitialized and has >= k members in the batch). Maximal runs of
    batches that seed nothing, were not remapped when the data ran out,
    and clear ``HOST_BATCH_THRESHOLD`` live rows (any live row with
    ``scan_small_batches``) go through ``StratifiedKmeans.minibatch_scan_run``
    on the device, which equals the per-batch sequence. Everything else
    runs through ``partial_fit``. A lone scannable batch is scanned only
    with ``scan_small_batches`` (so every non-seeding batch then shares
    the device numerics family).
    """
    from .ops.stratified import HOST_BATCH_THRESHOLD

    use_weights = model.use_weights_in_clustering
    ascending = len(iters_to_use) <= 1 or bool(
        np.all(np.diff(np.asarray(iters_to_use)) > 0)
    )

    # Simulate the initialized state forward (only delegated batches seed)
    sim_init = strat.initialized.copy()
    plan = []
    live_floor = 1 if scan_small_batches else HOST_BATCH_THRESHOLD
    for (_rows, _bins, ub, cnt), remapped in zip(batches, delegated):
        seeds = (~sim_init[ub]) & (cnt >= strat.k)
        live = int(cnt[sim_init[ub]].sum())
        if not ascending or remapped or seeds.any() or live < live_floor:
            plan.append(False)
            sim_init[ub[seeds]] = True
        else:
            plan.append(True)

    scan_ctx = None

    def scan_context():
        # The device feature array shared with the discretization, the
        # effective training bin of every row (-1 = excluded) and the
        # optional f32 weights, built once
        nonlocal scan_ctx
        if scan_ctx is None:
            eff = np.full(int(feats["offsets"][-1]), -1, np.int32)
            for rows, bins, _ub, _cnt in batches:
                eff[rows] = bins
            dev = model.device
            scan_ctx = (
                model._device_row_feats(need_parent=False)[1],
                torch.as_tensor(eff, device=dev),
                torch.as_tensor(feats["weights"].astype(np.float32), device=dev)
                if use_weights else None,
            )
        return scan_ctx

    i = 0
    while i < len(batches):
        if plan[i]:
            j = i
            while j + 1 < len(batches) and plan[j + 1]:
                j += 1
            if j > i or scan_small_batches:
                X_dev, eff_dev, w_dev = scan_context()
                run = range(i, j + 1)
                starts = [int(batches[b][0][0]) for b in run]
                lengths = [
                    int(batches[b][0][-1] + 1 - batches[b][0][0]) for b in run
                ]
                strat.minibatch_scan_run(X_dev, eff_dev, w_dev, starts, lengths)
                if collector() is not None:
                    trainable = strat.initialized & (strat.n_centers_per_bin > 0)
                    count("fold_device_bins",
                          sum(int(trainable[batches[b][2]].sum()) for b in run))
                for b in run:
                    ub = batches[b][2]
                    all_filled.update(int(x) for x in ub[strat.initialized[ub]])
                i = j + 1
                continue
        rows, bins = batches[i][:2]
        w = feats["weights"][rows] if use_weights else None
        all_filled.update(strat.partial_fit(feats["child"][rows], bins, weights=w))
        i += 1


def build_batch_plan(bin_mapper, iters_to_use, n_clusters,
                     kept_rows_all, kept_bins_all, offsets):
    """Pass 1 of stratified clustering: group iterations into fill batches.

    Accumulates iterations until every seen WE bin has >= ``n_clusters``
    kept segments (the reference's streaming fill criterion). Returns
    ``(batches, delegated)``: each batch is ``(rows, bins, unique_bins,
    counts)`` (bins after any ran-out remap), and ``delegated`` flags
    batches whose members were remapped to the nearest filled bins when
    the data ran out (they must run through ``partial_fit``).

    Under ``tracing.count``: ``fold_gathered_iterations``, the iterations
    a batch holds after its first (none where each iteration fills every
    bin it reaches), and ``fold_remapped_bins``, the bins remapped when
    the data ran out.
    """
    from .binning import find_nearest_bin

    batches = []
    delegated = []
    idx = 0
    while idx < len(iters_to_use):
        kept_rows = []
        kept_bins = []
        batch_counts = np.zeros(bin_mapper.nbins, dtype=np.int64)
        j = idx
        ran_out = False
        while True:
            if j >= len(iters_to_use):
                ran_out = True
                break
            iteration = iters_to_use[j]
            if 1 <= iteration < len(offsets):
                lo, hi = np.searchsorted(
                    kept_rows_all,
                    (offsets[iteration - 1], offsets[iteration]),
                )
            else:
                lo = hi = 0
            rows_it = kept_rows_all[lo:hi]
            bins_it = kept_bins_all[lo:hi]
            kept_rows.append(rows_it)
            kept_bins.append(bins_it)
            if len(bins_it):
                batch_counts += np.bincount(bins_it, minlength=bin_mapper.nbins)
            seen = batch_counts > 0
            if seen.any() and (batch_counts[seen] >= n_clusters).all():
                break
            j += 1

        rows = np.concatenate(kept_rows) if kept_rows else np.array([], int)
        if len(rows):
            bins = np.concatenate(kept_bins)
            unique_bins, counts = np.unique(bins, return_counts=True)
            unfilled = unique_bins[counts < n_clusters]
            filled = np.setdiff1d(unique_bins, unfilled)
            remapped = False
            if ran_out and len(unfilled) and len(filled):
                log.warning(
                    f"Couldn't fill bins {unfilled}; remapping members to "
                    "nearest filled bins for clustering."
                )
                for ub in unfilled:
                    nearest = find_nearest_bin(bin_mapper, int(ub), list(filled))
                    bins[bins == ub] = nearest
                remapped = True
                unique_bins, counts = np.unique(bins, return_counts=True)
            batches.append((rows, bins, unique_bins, counts))
            delegated.append(remapped)
            count("fold_gathered_iterations", j - idx - ran_out)
            count("fold_remapped_bins", len(unfilled) if remapped else 0)
        idx = j + 1
    return batches, delegated
