"""Host float64 analysis tail of the build: transition matrix, steady state,
target flux (copies of the numpy part of ``msm_we_tpu/ops/linalg.py``).

These matrices are small (hundreds of states) but ill-conditioned,
spanning many orders of magnitude, so they stay float64 numpy/scipy on
the host, the numerics of the reference. Committors, flux profiles,
implied timescales, PCCA+, the Chapman-Kolmogorov test and the device
power iterations are not ported yet (ROADMAP, queue 1).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sparse

from .._logging import log
from ..utils import inverse_iteration, is_connected

__all__ = [
    "tmatrix_from_flux",
    "steady_state_algebraic",
    "steady_state_refined",
    "target_flux",
]


def _row_stochastic(matrix):
    """Row-normalize in place semantics: positive rows divided by their sum,
    zero-outflow rows become self-transitions. The single shared home of the
    zero-row convention (reference ``_analysis.py:44-60``)."""
    M = np.array(matrix, dtype=np.float64)
    out = M.sum(axis=1)
    pos = out > 0
    M[pos] = M[pos] / out[pos, None]
    zero_rows = np.flatnonzero(out == 0.0)
    M[zero_rows, zero_rows] = 1.0
    return M


def tmatrix_from_flux(flux_matrix, ind_targets, ind_basis, n_bins):
    """Row-normalize a flux matrix into a steady-state transition matrix.

    Zero-outflow rows become self-transitions; target (sink) rows recycle
    uniformly into the basis. Reference ``_analysis.py:23-79``.
    """
    fm = _row_stochastic(flux_matrix)

    sink_rates = np.zeros(n_bins)
    sink_rates[np.asarray(ind_basis)] = 1.0 / np.size(ind_basis)
    tmatrix = fm.copy()
    tmatrix[np.asarray(ind_targets), :] = sink_rates[None, :]
    return tmatrix


def _power_correct(tmatrix, pSS, max_iters):
    """Matrix-power fallback for an eigenvector with negative entries.

    Repeated-squaring power iteration (reference ``_analysis.py:236-261``);
    returns ``(corrected_pSS_or_input, corrected_flag)``. Unlike the
    reference, which keys success on ``N == max_iters - 1`` and thereby
    discards a correction that lands exactly on the final iteration, success
    is tracked explicitly.
    """
    pSS_last = pSS
    _tmatrix = tmatrix.copy()
    for N in range(max_iters):
        pSS_new = _tmatrix.T @ pSS_last
        if (pSS_new < 0).sum() == 0:
            log.info(f"Corrected to semidefinite pSS in {N} iterations")
            return pSS_new, True
        pSS_last = pSS_new
        _tmatrix = tmatrix @ _tmatrix
    log.warning("Power method did NOT obtain semidefinite pSS.")
    return pSS, False


def steady_state_algebraic(tmatrix, max_iters=1000, check_negative=True):
    """Dense eigensolve for the stationary distribution, with the reference's
    matrix-power fallback when the eigenvector has negative entries
    (``_analysis.py:193-282``)."""
    tmatrix = np.asarray(tmatrix, dtype=np.float64)
    eigenvalues, eigenvectors = np.linalg.eig(tmatrix.T)
    pSS = np.real(eigenvectors[:, np.argmax(np.real(eigenvalues))]).squeeze()

    assert not np.isclose(pSS.sum(), 0), "Steady-state distribution sums to 0!"
    pSS = pSS / pSS.sum()

    if (pSS < 0).sum() > 0 and max_iters > 0:
        log.info(
            "Negative elements in pSS after normalization, attempting to correct "
            "with matrix power method."
        )
        pSS, _corrected = _power_correct(tmatrix, pSS, max_iters)

    if not np.all(pSS >= 0) and check_negative:
        assert np.all(pSS >= 0), f"Negative elements in steady-state: {pSS}"
    return pSS


def target_flux(tmatrix, pSS, ind_targets, n_bins, lagtime):
    """Total steady-state flux into the target states, per unit lagtime.

    Returns -1 if the basis cannot reach the target (caller passes
    connectivity). Reference ``_analysis.py:317-384``.
    """
    ind_targets = np.asarray(ind_targets)
    ind_not_targets = np.setdiff1d(np.arange(n_bins), ind_targets)
    Jt = float(
        np.sum(pSS[ind_not_targets][:, None] * tmatrix[np.ix_(ind_not_targets, ind_targets)])
    )
    return Jt / lagtime


def steady_state_refined(
    tmatrix,
    ind_targets,
    ind_basis,
    n_bins,
    lagtime,
    flux_fractional_convergence=1e-4,
    max_iters=10,
):
    """Algebraic estimate refined by sparse inverse iteration, converged on the
    change in target flux. Reference ``get_steady_state``
    (``_analysis.py:97-191``). Returns (pSS, JtargetSS_estimate).

    Raises ``ValueError`` if the basis cannot reach the target: the flux
    convergence criterion is meaningless then. (The reference burns all
    iterations on the -1 sentinel flux and dies on a bare
    ``assert last_flux >= 0``, ``_analysis.py:184-188``.)"""
    sparse_mat = sparse.csr_matrix(tmatrix)

    if not is_connected(sparse_mat, np.asarray(ind_basis), np.asarray(ind_targets)):
        raise ValueError(
            "There is no path from the basis to the target in this transition "
            "matrix, so a flux-converged steady state cannot be computed. "
            "Check bin connectivity (e.g. too-aggressive cleaning or an "
            "unreachable target definition)."
        )

    algebraic_pss = steady_state_algebraic(tmatrix, max_iters=10, check_negative=False)

    def _flux(p):
        return target_flux(np.asarray(tmatrix), p, ind_targets, n_bins, lagtime)

    last_flux = _flux(algebraic_pss)
    last_pSS = algebraic_pss
    flux_warned = False

    for N in range(max_iters):
        iterated = inverse_iteration(matrix=sparse_mat, guess=last_pSS)
        last_pSS = iterated
        new_flux = _flux(last_pSS)
        flux_change = new_flux - last_flux
        last_flux = new_flux
        criterion = last_flux * flux_fractional_convergence

        if N > 0 and last_flux == 0 and not flux_warned:
            log.warning(
                "Flux is 0; steady-state solver will only converge after max "
                "iterations. If you're looking for equilibrium this is probably OK."
            )
            flux_warned = True

        if abs(flux_change) < criterion:
            log.info(
                f"Flux converged to {last_flux:.4e} after {N + 1} iterations of "
                "inverse iteration."
            )
            break
        elif N == max_iters - 1 and last_flux != 0:
            log.warning("Flux is nonzero and did not converge!")

    assert (last_pSS >= 0).all(), "Negative elements in pSS"
    assert last_flux >= 0, "Negative flux estimate from this pSS"
    return last_pSS, last_flux
