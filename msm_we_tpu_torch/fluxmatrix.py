"""Flux-matrix estimation: the host float64 bincount route at any lag, the
fused device route at lag 0, and the routing between them.

Counterpart of ``get_flux_matrix``, ``device_f64_weights_ok``,
``device_flux_lag0`` and ``get_iter_flux_matrix`` in
``msm_we_tpu/fluxmatrix.py``.

Host route (the default): the ids come from the device discretization; the
(n+2)^2 accumulation is one f64 bincount on the host (WE weights span
hundreds of decades).

Device route (``device_flux_lag0``, opt-in): the sharded step of
``parallel/sharded.py`` over the model's mesh. On one device it is one H3
launch (``ops.stratified_assign.assign_flux``) that assigns the
device-resident parent and child features, applies the flux-order
overrides and scatters the f64 weights into the flux matrix with f64
``atomicAdd``; on a mesh each rank does that on its row block (or, with a
model axis, H4 with scores on its bank shard, the (min, id) combine, the
overrides and an f64 scatter) and the f64 partials are summed over 'data'.
Only the (n+2)^2 matrix comes back. The route is open when
``model.device_pipeline`` is set, and taken when ``model._force_device_flux``
is set, when the mesh has more than one rank, or when the ids are still
deferred and the build has at least ``MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS``
rows (default: never). ``MSM_WE_TPU_DEVICE_FLUX_F32=1`` accumulates in f32
instead. The atomics add in an order that changes between runs, so the
device flux equals the host bincount to f64 rounding (bitwise for dyadic
weights), not bit for bit.

Left out on purpose: the JAX package's packed-sparse flux download
(``build_sharded_step_packed*``, ``flux_pack_capacity``,
``unpack_packed_flux``). It shrinks the matrix for a slow device-to-host
link; here the dense (n+2)^2 f64 matrix is one small copy.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ._logging import log

DEVICE_FLUX_MIN_ROWS_ENV = "MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS"
DEVICE_FLUX_F32_ENV = "MSM_WE_TPU_DEVICE_FLUX_F32"


def _min_rows(env_name):
    """Row count from which an opt-in device route is taken (default:
    never)."""
    return int(os.environ.get(env_name, str(10**18)))


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

    use_device_flux = (
        n_lag == 0
        and model.device_pipeline
        and model.clusters is not None
        and not getattr(model, "_flux_prefer_host", False)
        and device_f64_weights_ok(model, feats["weights"])
    )
    if (use_device_flux and not model._force_device_flux
            and model._active_mesh().world_size == 1):
        # With the ids in hand (or cheap to get: one discretization whose
        # ids every later stage reuses) the host bincount needs no second
        # assignment of every row. The device route is for deferred ids on
        # builds of at least DEVICE_FLUX_MIN_ROWS rows (default: never), and
        # for meshes of several ranks, whatever the rows.
        big = int(feats["offsets"][-1]) >= _min_rows(DEVICE_FLUX_MIN_ROWS_ENV)
        if model._parent_idx is not None or not big:
            use_device_flux = False
    if use_device_flux:
        model.fluxMatrixRaw = device_flux_lag0(model, iters_to_use) / len(
            iters_to_use
        )
        return

    # Every host-route build (lag > 0, the default, a deferred clustering)
    # needs the stored ids
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


def device_f64_weights_ok(model, weights):
    """Whether the model's device can accumulate these WE weights in genuine
    f64: always, on CUDA and on the CPU. Both have native f64 with its full
    exponent range (and CUDA an f64 ``atomicAdd``), so weights down to
    1e-300 neither flush to zero nor vanish beside O(1) cellmates. The JAX
    package routes weights outside f32's exponent range to the host because
    its accelerator emulates f64; nothing here needs that guard, and the
    function is kept so that the routing reads like its counterpart."""
    del model, weights
    return True


def _remap_gather(raw, remap):
    """Remapped WE bins on the device from the cached raw bins and the
    (small) current ``we_remap``; rows of bin -1 stay -1."""
    return torch.where(
        raw >= 0, remap[raw.clamp(min=0).long()], torch.full_like(raw, -1)
    ).to(torch.int32)


def _flux_rows(model, feats, masks, iters_to_use, f32_tier, mesh):
    """The call-invariant row tensors of :func:`device_flux_lag0`, this
    rank's row block of them on the mesh's device (every row on one
    device), cached on the model per (feature set, iteration window, tier,
    mesh): the basis/target masks, the weights with the iteration selection
    folded in (``w * isin(iteration, iters)``; adding 0.0 is exact, so the
    feature arrays need no gather), and for stratified clustering the raw
    WE bins. Padded rows carry weight 0, masks False and bin -1. Cleaning
    recomputes the flux once a pass with the same window."""
    key = (tuple(iters_to_use), f32_tier)
    cache = getattr(model, "_device_flux_row_cache", None)
    if (cache is not None and cache[0] is feats and cache[1] == key
            and cache[3] is mesh):
        return cache[2]
    sel = np.isin(feats["iteration"], list(iters_to_use))
    w = np.where(sel, feats["weights"], 0.0).astype(
        np.float32 if f32_tier else np.float64
    )
    rows = {"w": mesh.rows(w, 0.0)}
    for name in ("basis_p", "basis_c", "target_p", "target_c"):
        rows[name] = mesh.rows(masks[name], False)
    if model._strat is not None:
        raw_p, raw_c = model._raw_we_bins()
        rows["raw_p"] = mesh.rows(raw_p.astype(np.int32), -1)
        rows["raw_c"] = mesh.rows(raw_c.astype(np.int32), -1)
    model._device_flux_row_cache = (feats, key, rows, mesh)
    return rows


def _flux_launch_args(model, iters_to_use, mesh=None):
    """``(args, target_p)`` of the sharded step of :func:`device_flux_lag0`
    (the H3 launch on one device), this rank's row block on the mesh's
    device: the feature rows, the remapped WE bins (gathered on the device
    from the cached raw bins and the current ``we_remap``), the weights and
    masks of :func:`_flux_rows`, the whole compact bank and the nominal
    state count, in ``assign_flux``'s order (``mesh`` default: the
    model's). Aggregated clustering is one implicit bin holding every
    center and has no ``target_p``."""
    from .features import mesh_row_feats

    mesh = model._active_mesh() if mesh is None else mesh
    feats = model._featurize_all()
    strat = model._strat
    dev = mesh.device
    f32_tier = os.environ.get(DEVICE_FLUX_F32_ENV, "") == "1"
    fp_dev, fc_dev = mesh_row_feats(model, mesh)
    rows = _flux_rows(model, feats, model._pc_masks(), iters_to_use, f32_tier,
                      mesh)
    if strat is not None:
        bank = strat.compact_bank_device()
        remap = torch.as_tensor(strat.we_remap.astype(np.int32), device=dev)
        pbins = _remap_gather(rows["raw_p"], remap)
        cbins = _remap_gather(rows["raw_c"], remap)
        target_p = rows["target_p"]
    else:
        centers = np.asarray(model.clusters.cluster_centers_, np.float32)
        bank = (
            torch.as_tensor(centers, device=dev).contiguous(),
            torch.zeros(len(centers), dtype=torch.int32, device=dev),
            torch.ones(len(centers), dtype=torch.bool, device=dev),
        )
        pbins = cbins = mesh.rows(
            np.zeros(int(feats["offsets"][-1]), np.int32), -1)
        target_p = None
    args = (fp_dev, fc_dev, pbins, cbins, rows["w"], rows["basis_p"],
            rows["basis_c"], rows["target_c"], *bank, model.n_clusters + 2)
    return args, target_p


def device_flux_lag0(model, iters_to_use):
    """Fused lag-0 flux matrix on the model's mesh: on one device one H3
    launch (``assign_flux``) over the device-resident features assigns
    parent and child rows against the compact bank, applies the flux-order
    overrides and scatters the weights; on a mesh of ranks each scores its
    row block (``parallel.sharded._discretize_and_flux``) and the f64
    partials are summed over 'data'. Returns the (n+2, n+2) float64 sum
    over the window, not yet divided by the number of iterations, equal on
    every rank.

    Stratified clustering scores each row against its (remapped) WE bin's
    centers and sends target-region parents to the target state; aggregated
    clustering is one bin holding every center, and leaves such parents at
    their cluster (the reference's aggregated path). The weights are f64,
    or f32 with ``MSM_WE_TPU_DEVICE_FLUX_F32=1`` (the accumulator has the
    weights' dtype).

    With the ids still deferred and fewer rows than
    ``MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS`` the same launch also mints the
    build's dtrajs: H3's ids carry the flux-order overrides at the nominal
    numbering, so the rows inside a region are rewritten in predict order
    (target wins) at the bank's live numbering, as ``pair_discretize``
    numbers them. From that row count on the ids stay on the device and the
    dtrajs deferred: a later host consumer materializes them once, against
    the final bank. Minted ids are gathered over the mesh's 'data' axis.
    """
    from .discretization import _check_live_centers
    from .parallel.sharded import _discretize_and_flux
    from .step import _apply_overrides

    strat = model._strat
    n_states = model.n_clusters + 2
    mesh = model._active_mesh()
    N = int(model._featurize_all()["offsets"][-1])
    args, target_p = _flux_launch_args(model, iters_to_use, mesh)
    want_ids = (
        model._parent_idx is None
        and strat is not None
        and N < _min_rows(DEVICE_FLUX_MIN_ROWS_ENV)
    )
    if want_ids:
        # Same junk-id guard as pair_discretize: this launch is about to
        # mint the build's dtrajs
        raw_p, raw_c = model._raw_we_bins()
        _check_live_centers(strat, strat.we_remap[raw_p], strat.we_remap[raw_c])
    fp, fc, pbins, cbins, w, basis_p, basis_c, target_c = args[:8]
    *shard, offset = mesh.bank_shard(*args[8:11])
    fm, pidx, cidx = _discretize_and_flux(
        mesh, fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, *shard,
        n_states, offset, target_p=target_p,
    )
    if want_ids:
        pid, cid = _apply_overrides(
            pidx, cidx, basis_p, basis_c, target_c,
            strat.n_total_clusters + 2, target_p=target_p, predict_order=True,
        )
        model._scored_on_host = False
        model._store_dtrajs(mesh.gather_rows(pid, N).cpu().numpy(),
                            mesh.gather_rows(cid, N).cpu().numpy())
    fm = fm.to(torch.float64).cpu().numpy()
    if fm.shape != (n_states, n_states):
        raise RuntimeError(f"device flux has shape {fm.shape}")
    return fm


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
