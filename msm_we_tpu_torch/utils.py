"""Host numerics the slice calls (copies from ``msm_we_tpu/utils.py``):
basis/target membership, strongly connected sets, reachability and one
step of inverse iteration. float64 numpy/scipy on the host; these are
control logic and tiny solves, not device work.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.csgraph as csgraph
import scipy.sparse.linalg  # noqa: F401  (spsolve)
from scipy.sparse import csr_matrix

from ._logging import log

__all__ = [
    "pcoord_in_bounds",
    "find_connected_sets",
    "is_connected",
    "inverse_iteration",
]


def pcoord_in_bounds(pcoords, bounds):
    """Open-interval membership of pcoords in per-dimension [lower, upper]
    (the reference's strict inequalities). NaN pcoords are never inside."""
    pcoords = np.atleast_2d(np.asarray(pcoords, dtype=float))
    bounds = np.asarray(bounds, dtype=float)
    inside = np.ones(len(pcoords), dtype=bool)
    for d in range(bounds.shape[0]):
        inside &= (pcoords[:, d] > bounds[d, 0]) & (pcoords[:, d] < bounds[d, 1])
    return inside


def find_connected_sets(C, directed=True):
    """Strongly (or weakly) connected components of the graph with edge
    weights C, largest first; states ascending within each."""
    C = csr_matrix(np.asarray(C)) if not sparse.issparse(C) else C.tocsr()
    n_components, labels = csgraph.connected_components(
        C, directed=directed, connection="strong"
    )
    components = [np.sort(np.flatnonzero(labels == i)) for i in range(n_components)]
    components.sort(key=lambda c: -len(c))
    return components


def is_connected(matrix, source_states, target_states, directed=True):
    """True if every source state can reach EVERY target state."""
    dists = csgraph.shortest_path(matrix, directed=directed, indices=source_states)
    return bool(np.isfinite(dists[:, target_states]).all(axis=None))


def inverse_iteration(guess, matrix, mu=1):
    """One step of inverse iteration toward the eigenvector of eigenvalue 1:
    solve ``(M^T - mu I) x = guess`` and normalize; retried with
    ``mu=0.999`` when the shifted matrix is exactly singular."""
    n = guess.shape[0]
    try:
        shifted = matrix.T - mu * sparse.eye(n)
        if n <= 4096:
            result = np.linalg.solve(
                shifted.toarray() if sparse.issparse(shifted) else np.asarray(shifted),
                guess,
            )
        else:
            result = sparse.linalg.spsolve(shifted.tocsc(), guess)
            if not np.all(np.isfinite(result)):
                raise np.linalg.LinAlgError(
                    "spsolve returned non-finite result (singular factor)"
                )
    except (RuntimeError, np.linalg.LinAlgError):
        if mu == 1:
            log.error("Inverse iteration failed with mu=1; retrying with mu=0.999.")
            return inverse_iteration(guess, matrix, mu=0.999)
        raise
    result = np.asarray(result).squeeze()
    return result / result.sum()
