"""Block-bootstrap error bars for haMSM observables.

Counterpart of ``msm_we_tpu/bootstrap.py`` (host float64 numpy, as in the
JAX package). Replicates are drawn with ``np.random.default_rng(seed)``,
so one seed gives the JAX package's replicates. An extension over the
reference, which has only point estimates plus block cross-validation
(``msm_we/msm_we.py:884-1009``); each replicate runs the same
``ops.linalg`` solvers as the point estimate.
"""
from __future__ import annotations

import numpy as np

from ._logging import log
from .ops import linalg


def bootstrap_target_flux(
    model,
    n_boot=200,
    seed=0,
    alpha=0.05,
    block_size=1,
    iters_to_use=None,
    flux_fractional_convergence=1e-4,
    max_iters=10,
    observables=("flux",),
):
    """Block-bootstrap confidence interval for ``JtargetSS`` over WE
    iterations (an extension; the reference has only point estimates
    plus block cross-validation).

    WE iterations are the natural resampling unit: each contributes an
    independent per-iteration flux matrix, and the build's estimate is
    their mean. Replicates resample iterations with replacement
    (``block_size > 1`` draws contiguous circular blocks, for runs whose
    iteration-to-iteration fluxes are correlated), rebuild the flux
    matrix, and run the same Tmatrix -> refined-steady-state -> target
    flux chain as the point estimate. Per-iteration matrices are in the
    current (cleaned) cluster numbering, a pure permutation of the
    model's sorted numbering, so replicate fluxes are directly
    comparable to ``model.JtargetSS``.

    Replicates whose resampled matrix disconnects basis from target are
    counted in ``n_failed`` and excluded from the percentiles.

    Returns a dict: ``flux`` (point estimate), ``mean``, ``std``,
    ``ci`` ((lo, hi) percentile interval at ``1 - alpha``),
    ``fluxes`` (per-replicate values, NaN where failed), ``n_failed``.

    ``observables`` may additionally include ``"pss"`` and/or
    ``"committor"``: each surviving replicate's steady-state
    distribution / forward committor is collected and per-state
    percentile bands are added to the result (``pss_mean``/``pss_ci``
    of shapes (n_states,) / (2, n_states), and likewise
    ``committor_mean``/``committor_ci``). The committor adds one
    absorbing-BC power iteration per replicate (reference
    ``_analysis.py:527-606`` semantics via ``ops.linalg.committor``).
    """
    observables = tuple(observables)
    unknown = set(observables) - {"flux", "pss", "committor"}
    if unknown:
        raise ValueError(
            f"Unknown bootstrap observables {sorted(unknown)}; "
            "supported: 'flux', 'pss', 'committor'"
        )
    model._ensure_discretized()
    if iters_to_use is None:
        params = getattr(model, "_fluxMatrixParams", None) or [0, 1, None, None]
        if params[3] is not None:
            iters_to_use = list(params[3])
        else:
            first = params[1] if params[1] is not None else 1
            last = params[2] if params[2] is not None else model.maxIter
            iters_to_use = list(
                range(max(first + 1, model.n_lag + 1), last)
            )
    iters = [int(i) for i in iters_to_use]
    n_it = len(iters)
    if n_it < 2:
        raise ValueError(
            f"Bootstrap needs at least 2 iterations, got {n_it}"
        )
    if model.n_lag != 0:
        raise NotImplementedError(
            "bootstrap_target_flux currently supports lag-0 models "
            "(per-iteration matrices are lag-0)."
        )
    block_size = int(block_size)
    if not 1 <= block_size <= n_it:
        raise ValueError(f"block_size must be in [1, {n_it}]")

    per_iter = np.stack([model.get_iter_fluxMatrix(i) for i in iters])
    n_states = model.n_clusters + 2
    lagtime = model.tau * (model.n_lag + 1)
    # Per-iteration matrices carry basis/target at the override indices
    ind_basis = np.array([model.n_clusters])
    ind_targets = np.array([model.n_clusters + 1])

    want_pss = "pss" in observables
    want_q = "committor" in observables
    # Per-iteration matrices are in the cleaned-but-unsorted (raw)
    # numbering; the model's pSS/committor are pcoord-sorted. The scalar
    # flux is permutation-invariant (basis/target stay at n, n+1 under
    # the NaN-pinned stable sort), but per-state vectors must be
    # reordered into the model's numbering before percentiles.
    sort_idx = getattr(model, "pcoord_sort_indices", None)
    if sort_idx is not None and len(sort_idx) != n_states:
        # Stale: a re-clustering after the last organize left a sort
        # index for a different state count. Flux is permutation-
        # invariant, but per-state vectors would be mislabeled (or
        # crash), so require a fresh organize for those observables.
        if want_pss or want_q:
            raise ValueError(
                f"pcoord_sort_indices has length {len(sort_idx)} but the "
                f"model now has {n_states} states -- re-run "
                "organize_fluxMatrix before bootstrapping per-state "
                "observables."
            )
        sort_idx = None
    if sort_idx is None:
        sort_idx = np.arange(n_states)

    def _eval(F):
        T = linalg.tmatrix_from_flux(F, ind_targets, ind_basis, n_states)
        pSS, J = linalg.steady_state_refined(
            T,
            ind_targets,
            ind_basis,
            n_states,
            lagtime,
            flux_fractional_convergence=flux_fractional_convergence,
            max_iters=max_iters,
        )
        q = (
            linalg.committor(F, ind_targets, ind_basis, n_states)[sort_idx]
            if want_q
            else None
        )
        return J, np.ravel(pSS)[sort_idx], q

    rng = np.random.default_rng(seed)
    fluxes = np.full(n_boot, np.nan)
    pss_boot = np.full((n_boot, n_states), np.nan) if want_pss else None
    q_boot = np.full((n_boot, n_states), np.nan) if want_q else None
    n_failed = 0
    n_blocks = -(-n_it // block_size)
    # Degenerate resamples legitimately trigger per-replicate solver
    # retries / zero-flux warnings; hundreds of those drown the log.
    # Silence the package logger for the loop and summarize after.
    import logging as _logging

    prev_level = log.level
    log.setLevel(_logging.CRITICAL)
    try:
        for b in range(n_boot):
            if block_size == 1:
                picks = rng.integers(0, n_it, n_it)
            else:
                starts = rng.integers(0, n_it, n_blocks)
                picks = (
                    starts[:, None] + np.arange(block_size)[None, :]
                ).reshape(-1)[:n_it] % n_it
            try:
                J, pSS_b, q_b = _eval(per_iter[picks].mean(axis=0))
            except (ValueError, AssertionError):
                n_failed += 1
                continue
            fluxes[b] = J
            if want_pss:
                pss_boot[b] = pSS_b
            if want_q:
                q_boot[b] = q_b
    finally:
        log.setLevel(prev_level)
    if n_failed:
        log.warning(
            f"{n_failed}/{n_boot} bootstrap replicates disconnected the "
            "basis from the target and were excluded."
        )

    ok = fluxes[np.isfinite(fluxes)]
    if not len(ok):
        raise RuntimeError(
            "Every bootstrap replicate disconnected basis from target; "
            "the model has too little recycling data for error bars."
        )
    lo, hi = np.percentile(ok, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    point, point_pss, point_q = _eval(per_iter.mean(axis=0))
    result = {
        "flux": float(point),
        "mean": float(ok.mean()),
        "std": float(ok.std(ddof=1)) if len(ok) > 1 else 0.0,
        "ci": (float(lo), float(hi)),
        "alpha": alpha,
        "fluxes": fluxes,
        "n_failed": int(n_failed),
        # Zero-flux replicates are legitimate bootstrap mass (a resample
        # holding no recycling events), surfaced for interpretability
        "n_zero_flux": int((ok == 0.0).sum()),
        "block_size": block_size,
        "n_iterations": n_it,
        # Staleness stamp: consumers (plot_committor) compare this to
        # the model's current sort index -- a same-size re-organize
        # changes state identities without changing n_states
        "sort_indices": np.asarray(sort_idx).copy(),
    }
    pcts = [100 * alpha / 2, 100 * (1 - alpha / 2)]
    for name, boot, pt in (
        ("pss", pss_boot, point_pss),
        ("committor", q_boot, point_q),
    ):
        if boot is None:
            continue
        rows = boot[np.all(np.isfinite(boot), axis=1)]
        result[name] = pt
        result[f"{name}_mean"] = rows.mean(axis=0)
        result[f"{name}_ci"] = np.percentile(rows, pcts, axis=0)
    model.flux_bootstrap = result
    return result
