"""haMSM analysis linear algebra: transition matrix, steady state, target
flux, committors, flux profiles, implied timescales, PCCA+ and the
Chapman-Kolmogorov test (the numpy part of ``msm_we_tpu/ops/linalg.py``,
copied), plus the two device iterations as torch functions.

These matrices are small (hundreds of states) but ill-conditioned,
spanning many orders of magnitude, so the analysis stays float64
numpy/scipy on the host, the numerics of the reference.
:func:`steady_state_power` and :func:`committor_device` (counterparts of
``steady_state_power_jax`` and ``committor_jax``) run on the device and in
the dtype of the tensors they are given.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sparse
import torch

from .._device import f64_threshold
from .._logging import log
from ..tracing import span
from ..utils import find_connected_sets, inverse_iteration, is_connected

__all__ = [
    "tmatrix_from_flux",
    "equilibrium_tmatrix_from_flux",
    "steady_state_algebraic",
    "steady_state_refined",
    "steady_state_power",
    "target_flux",
    "committor",
    "backwards_committor",
    "committor_device",
    "net_flux_profile",
    "implied_timescales_from_flux",
    "pcca_sets",
    "chapman_kolmogorov_from_flux",
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


def equilibrium_tmatrix_from_flux(flux_matrix, ind_targets, ind_basis):
    """Equilibrium variant: drop basis/target states, then row-normalize.

    Reference ``get_eqTmatrix``, ``_analysis.py:81-95``.
    """
    fm = np.array(flux_matrix, dtype=np.float64)
    n = fm.shape[0]
    drop = np.append(np.asarray(ind_targets), np.asarray(ind_basis))
    keep = np.setdiff1d(np.arange(n), drop)
    return _row_stochastic(fm[np.ix_(keep, keep)])


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


@span("steady_state")
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


def committor(flux_matrix, ind_targets, ind_basis, n_bins, conv=1e-5,
              max_iters=100_000):
    """Forward committor by absorbing-boundary power iteration.

    Reference ``get_committor`` (``_analysis.py:527-606``), including its
    final-iteration convention: the stored committor is the matrix product of
    the last clamped iterate (no re-clamp after the loop).

    Unlike the reference's unbounded ``while`` (which hangs on matrices whose
    non-absorbing block mixes arbitrarily slowly), iteration stops after
    ``max_iters`` with a warning -- matching the jitted ``committor_jax``.
    """
    M = _row_stochastic(flux_matrix)

    for ii in np.asarray(ind_basis):
        M[ii, :] = 0.0
        M[ii, ii] = 1.0

    q = np.zeros((n_bins, 1))
    q[np.asarray(ind_targets), 0] = 1.0
    qp = np.ones_like(q)
    dconv = np.inf
    iters = 0
    while dconv > conv:
        if iters >= max_iters:
            log.warning(
                f"Committor iteration did not converge below {conv} within "
                f"{max_iters} iterations (residual {dconv:.3e}); returning the "
                "current iterate."
            )
            break
        q[np.asarray(ind_targets), 0] = 1.0
        q[np.asarray(ind_basis), 0] = 0.0
        q = M @ q
        dconv = np.abs(qp - q).sum()
        qp = q.copy()
        iters += 1
    return q.squeeze()


def backwards_committor(flux_matrix, ind_targets, ind_basis, n_bins, conv,
                        max_iters=100_000):
    """Backward committor via time reversal. Reference ``_analysis.py:609-637``,
    plus the same ``max_iters`` cap as :func:`committor`."""
    M = _row_stochastic(flux_matrix)
    for ii in np.asarray(ind_targets):
        M[ii, :] = 0.0
        M[ii, ii] = 1.0
    M = M.T
    q = np.zeros((n_bins, 1))
    q[np.asarray(ind_basis), 0] = 1.0
    qp = np.ones_like(q)
    dconv = np.inf
    iters = 0
    while dconv > conv:
        if iters >= max_iters:
            log.warning(
                f"Backward-committor iteration did not converge below {conv} "
                f"within {max_iters} iterations (residual {dconv:.3e}); "
                "returning the current iterate."
            )
            break
        q[np.asarray(ind_basis), 0] = 1.0
        q[np.asarray(ind_targets), 0] = 0.0
        q = M @ q
        dconv = np.abs(qp - q).sum()
        qp = q.copy()
        iters += 1
    return q.squeeze()


def net_flux_profile(flux_matrix, order):
    """Net flux through each cut of the state ordering, via 2-D cumulative sums.

    ``J[order[i]] = sum(F[>i, <=i]) - sum(F[<=i, >i])`` over the *ordered*
    matrix -- equal to P[n-1, i] - P[i, n-1] with P the 2-D inclusive cumsum.
    Replaces the reference's O(n^3) loops (``_analysis.py:409-422``). The last
    ordered state keeps J = 0, as in the reference (loop stops at n-1).
    """
    F = np.asarray(flux_matrix, dtype=np.float64)[np.ix_(order, order)]
    n = F.shape[0]
    P = F.cumsum(axis=0).cumsum(axis=1)
    J = np.zeros(n)
    idx = np.arange(n - 1)
    J[np.asarray(order)[idx]] = P[n - 1, idx] - P[idx, n - 1]
    return J


def _connected_tmatrix(flux_matrix):
    """Row-normalized transition matrix of the largest strongly connected
    component. Returns ``(T, keep)`` or ``(None, None)`` when no usable
    component (fewer than 2 states) exists."""
    fm = np.asarray(flux_matrix, dtype=np.float64)
    components = find_connected_sets(fm, directed=True)
    if not len(components) or len(components[0]) < 2:
        return None, None
    keep = components[0]
    return _row_stochastic(fm[np.ix_(keep, keep)]), keep


def implied_timescales_from_flux(flux_matrices, lag_times, n_timescales=3):
    """Implied relaxation timescales from lagged flux/count matrices.

    For each matrix: restrict to the largest strongly connected set
    (relaxation timescales are undefined across disconnected components),
    row-normalize, and convert the leading non-stationary eigenvalue
    magnitudes to timescales ``t_i = -lag / ln |lambda_{i+1}|``. For a
    process that is Markovian in the state space, the curves are
    lag-independent -- the standard MSM lag-validation test. Returns a
    ``(len(flux_matrices), n_timescales)`` array, NaN-padded when a matrix
    has fewer usable eigenvalues; |lambda| >= 1 maps to +inf.

    This extends the reference, whose lag machinery is gated off
    (``msm_we.py:353-359``); built on the lag>0 transition support.
    """
    out = np.full((len(flux_matrices), n_timescales), np.nan)
    for i, (fm, lag) in enumerate(zip(flux_matrices, lag_times)):
        T, _keep = _connected_tmatrix(fm)
        if T is None:
            continue
        mags = np.sort(np.abs(np.linalg.eigvals(T)))[::-1]
        lams = mags[1 : 1 + n_timescales]  # drop the stationary lambda = 1
        with np.errstate(divide="ignore", invalid="ignore"):
            ts = np.where(lams >= 1.0, np.inf, -float(lag) / np.log(lams))
        out[i, : len(ts)] = ts
    return out


def pcca_sets(flux_matrix, n_sets):
    """Metastable coarse sets by the PCCA+ inner-simplex algorithm.

    Restricts to the largest strongly connected component, takes the
    ``n_sets`` dominant right eigenvectors of the row-normalized matrix,
    picks ``n_sets`` rows spanning the eigenvector simplex (Deuflhard &
    Weber 2005's initial-guess construction), and assigns every state to
    its maximum-membership vertex. Returns a list of arrays of ORIGINAL
    state indices (every component state appears in exactly one set).

    A coarse-graining utility the reference lacks entirely; also usable as
    the set definition for :func:`chapman_kolmogorov_from_flux` via
    ``modelWE.get_ck_test(sets=n)``.
    """
    T, keep = _connected_tmatrix(flux_matrix)
    if T is None:
        raise ValueError("No connected component of size >= 2 to coarse-grain")
    m = int(min(n_sets, len(keep)))
    if m < 2:
        raise ValueError("n_sets must be >= 2")

    # Real basis of the dominant invariant subspace. WE flux matrices are
    # non-reversible (recycling edges), so complex-conjugate eigenvalue
    # pairs near the top of the spectrum are routine; taking np.real of
    # both pair members would duplicate a column and degenerate the
    # simplex. Each pair instead contributes Re(v) and Im(v) once.
    evals, evecs = np.linalg.eig(T)
    order = np.argsort(-np.real(evals))
    cols = []
    consumed = set()
    for j in order:
        if len(cols) >= m:
            break
        if j in consumed:
            continue
        lam, v = evals[j], evecs[:, j]
        if abs(lam.imag) > 1e-12:
            cols.append(np.real(v))
            if len(cols) < m:
                cols.append(np.imag(v))
            for jj in order:  # retire the conjugate partner
                if jj != j and jj not in consumed and np.isclose(
                    evals[jj], np.conj(lam)
                ):
                    consumed.add(jj)
                    break
        else:
            cols.append(np.real(v))
    X = np.stack(cols, axis=1)

    # Inner simplex: first vertex = row farthest from the centroid; each
    # next vertex = row with the largest residual after removing the span
    # of the already-chosen vertex directions
    idx = np.zeros(m, dtype=int)
    centered = X - X.mean(axis=0)
    idx[0] = int(np.argmax(np.linalg.norm(centered, axis=1)))
    ortho = X - X[idx[0]]
    for j in range(1, m):
        norms = np.linalg.norm(ortho, axis=1)
        idx[j] = int(np.argmax(norms))
        v = ortho[idx[j]] / max(norms[idx[j]], 1e-300)
        ortho = ortho - np.outer(ortho @ v, v)

    # chi solves  chi @ X[idx] = X  (memberships in the vertex basis)
    memberships = X @ np.linalg.pinv(X[idx])
    assignment = np.argmax(memberships, axis=1)
    sets = [keep[assignment == j] for j in range(m) if (assignment == j).any()]
    if len(sets) < n_sets:
        log.warning(
            f"PCCA+ produced {len(sets)} sets, fewer than the {n_sets} "
            "requested (component too small or a degenerate vertex "
            "attracted no states)."
        )
    return sets


def chapman_kolmogorov_from_flux(flux_matrices, factors, sets=None):
    """Chapman-Kolmogorov test: compare set-residence probabilities of the
    directly estimated lagged models against the base model propagated.

    ``flux_matrices[0]`` is the base-lag estimate; ``flux_matrices[i]`` is
    estimated at ``factors[i]`` times the base lag (``factors[0]`` must
    be 1). For each coarse set ``S``:
    ``predicted[i] = pi_S @ T_base^factors[i] @ 1_S`` and
    ``estimated[i] = pi_S @ T_i @ 1_S``, with ``pi_S`` the base model's
    stationary distribution restricted to ``S``. For Markovian dynamics the
    two curves coincide. All matrices are restricted to the base model's
    largest strongly connected component (set indices refer to the
    original state numbering; states outside the component are ignored).

    ``sets=None`` splits the component in two by the sign structure of the
    slowest left-propagated mode (the standard 2-metastable partition).
    Returns ``(sets, predicted, estimated)`` with probability arrays of
    shape ``(n_sets, len(factors))``.
    """
    factors = [int(f) for f in factors]
    assert factors[0] == 1, "the first matrix must be the base-lag estimate"
    T0, keep = _connected_tmatrix(flux_matrices[0])
    if T0 is None:
        raise ValueError("Base flux matrix has no connected component of size >= 2")

    evals, evecs = np.linalg.eig(T0.T)
    order = np.argsort(-np.real(evals))
    pi = np.real(evecs[:, order[0]])
    pi = np.abs(pi) / np.abs(pi).sum()

    if sets is None:
        slow = np.real(evecs[:, order[1]])
        sets = [keep[slow >= 0], keep[slow < 0]]
        sets = [s for s in sets if len(s)]
    sets = [np.asarray(s) for s in sets]

    # Per-factor quantities hoisted out of the per-set loop: the SCC
    # decomposition/normalization of each lagged matrix and the base-matrix
    # powers depend only on the factor (O(n^3) each), not on the sets
    pos_of = {state: i for i, state in enumerate(keep)}
    lagged = [_connected_tmatrix(flux_matrices[fi]) for fi in range(len(factors))]
    pos_of_k = [
        {state: i for i, state in enumerate(keep_k)} if keep_k is not None else None
        for _Tk, keep_k in lagged
    ]
    T0_pow = {}
    power = np.eye(len(keep))
    previous = 0
    for k in sorted(set(factors)):
        power = power @ np.linalg.matrix_power(T0, k - previous)
        T0_pow[k] = power
        previous = k

    predicted = np.full((len(sets), len(factors)), np.nan)
    estimated = np.full((len(sets), len(factors)), np.nan)
    for si, S in enumerate(sets):
        rows = np.array([pos_of[s] for s in S if s in pos_of], dtype=int)
        if not len(rows):
            continue
        pi_S = np.zeros(len(keep))
        pi_S[rows] = pi[rows]
        if pi_S.sum() <= 0:
            continue
        pi_S /= pi_S.sum()
        member = np.zeros(len(keep))
        member[rows] = 1.0
        for fi, k in enumerate(factors):
            predicted[si, fi] = pi_S @ T0_pow[k] @ member
            Tk, keep_k = lagged[fi]
            if Tk is None:
                continue
            pos_k = pos_of_k[fi]
            rows_k = np.array([pos_k[s] for s in S if s in pos_k], dtype=int)
            pi_Sk = np.zeros(len(keep_k))
            # Weight by the base stationary distribution on shared states
            for s in S:
                if s in pos_k and s in pos_of:
                    pi_Sk[pos_k[s]] = pi[pos_of[s]]
            if pi_Sk.sum() <= 0 or not len(rows_k):
                continue
            pi_Sk /= pi_Sk.sum()
            member_k = np.zeros(len(keep_k))
            member_k[rows_k] = 1.0
            estimated[si, fi] = pi_Sk @ Tk @ member_k
    return sets, predicted, estimated


# -------------------------------------------------------------------- device


def steady_state_power(T, guess, n_iters=200):
    """Power iteration for the stationary distribution on ``T``'s device
    (``steady_state_power_jax``): ``n_iters`` steps of ``p <- T^T p``
    normalized by ``max(sum p, 1e-30)``, with no host sync."""
    p = guess
    for _ in range(int(n_iters)):
        p = T.T @ p
        p = p / torch.clamp(p.sum(), min=1e-30)
    return p


COMMITTOR_BLOCK = 64  # guarded iterations between two host reads


def committor_device(M, target_mask, basis_mask, conv=1e-5, max_iters=10000):
    """Forward committor iteration on ``M``'s device (``committor_jax``).

    ``M`` is row-normalized; the absorbing basis rows are applied here, so
    ``q[basis] == 0`` on return. Each step clamps ``q`` (1 on the target, 0
    on the basis) and multiplies by ``M``; the result is the first iterate
    whose L1 change from the previous one is ``<= conv``, or the
    ``max_iters``-th. The convergence test stays on the device: a 0-dim
    ``done`` flag freezes ``q`` after the converging step, and the host
    reads the flag once every ``COMMITTOR_BLOCK`` steps.
    """
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    M = torch.where(basis_mask[:, None], eye, M)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    q = torch.where(target_mask, one, zero)
    done = torch.zeros((), dtype=torch.bool, device=M.device)
    conv = f64_threshold(conv, M.dtype)
    left = int(max_iters)
    while left > 0:
        for _ in range(min(COMMITTOR_BLOCK, left)):
            qn = M @ torch.where(target_mask, one, torch.where(basis_mask, zero, q))
            change = (q - qn).abs().sum()
            q = torch.where(done, q, qn)
            done = done | (change <= conv)
        left -= COMMITTOR_BLOCK
        if bool(done):
            break
    return q
