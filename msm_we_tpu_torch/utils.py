"""Host numerics the port calls (copies from ``msm_we_tpu/utils.py``):
basis/target membership, strongly connected sets, reachability, one step
of inverse iteration, and the trajectory and transition-matrix helpers of
``msm`` (``Interval``, ``weighted_choice``, ``map_to_integers``,
``check_tmatrix``, ``clean_tmatrix``, ``pops_from_tmatrix``,
``pops_from_nm_tmatrix``, ``pseudo_nm_tmatrix``, ...). float64 numpy/scipy on the host; these are control
logic and tiny solves, not device work.
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
    "Interval",
    "reverse_sort_lists",
    "weighted_choice",
    "get_shape",
    "num_of_nonzero_elements",
    "normalize",
    "normalize_markov_matrix",
    "random_markov_matrix",
    "check_tmatrix",
    "clean_tmatrix",
    "pops_from_tmatrix",
    "pops_from_nm_tmatrix",
    "map_to_integers",
    "pseudo_nm_tmatrix",
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


class Interval:
    """Half-open interval membership test, supporting unions and N dimensions.

    Accepts the same four shapes of interval specification as the reference
    (``msm_we/utils.py:164-221``):

    * ``[a, b]`` -- a single 1-D interval
    * ``[[a, b], [c, d], ...]`` with ``n_variables == 1`` -- union of 1-D intervals
    * ``[[a, b], [c, d], ...]`` with ``n_variables > 1`` -- one N-D box
    * ``[[[...]], [[...]]]`` -- union of N-D boxes
    """

    def __init__(self, interval_set, n_variables):
        self.interval_set = interval_set
        self.n_variables = n_variables

    def __contains__(self, item):
        shape = np.shape(np.asarray(self.interval_set, dtype=object))
        ndim_spec = len(np.array(self.interval_set).shape)

        if self.n_variables == 1 and ndim_spec == 1:
            lo, hi = self.interval_set
            return lo <= item < hi
        if self.n_variables == 1 and ndim_spec == 2:
            return any(item in Interval(sub, 1) for sub in self.interval_set)
        if self.n_variables > 1 and ndim_spec == 2:
            return all(
                item[i] in Interval(self.interval_set[i], 1)
                for i in range(len(self.interval_set))
            )
        if ndim_spec == 3:
            return any(
                item in Interval(sub, self.n_variables) for sub in self.interval_set
            )
        raise ValueError(f"Interval specification has unexpected shape {shape}")


def reverse_sort_lists(list_1, list_2):
    """Sort both lists descending by the values of the first."""
    pairs = sorted(zip(list_1, list_2), key=lambda p: p[0], reverse=True)
    a, b = zip(*pairs)
    return a, b


def weighted_choice(list_, weights=None):
    """Pick one element of ``list_`` with probability proportional to ``weights``.

    Uses ``np.random.random()`` once, walking the CDF -- same consumption of the
    global numpy RNG stream as the reference (``msm_we/utils.py:232-253``), which
    matters for seeded-test parity.
    """
    size = len(list_)
    if weights is None:
        probs = np.full(size, 1.0 / size)
    else:
        assert size == len(weights)
        probs = np.asarray(weights, dtype=float) / sum(weights)

    rand = np.random.random()
    acc = 0.0
    choice = size - 1
    for i in range(size):
        if acc <= rand < acc + probs[i]:
            choice = i
            break
        acc += probs[i]
    return list_[choice]


def get_shape(trajectory):
    """(n_snapshots, n_variables) of a 1-D or 2-D trajectory array."""
    shape = np.asarray(trajectory).shape
    if len(shape) == 1:
        return shape[0], 1
    if len(shape) == 2:
        return shape[0], shape[1]
    raise ValueError(f"Trajectory shape {shape} is not 1-D or 2-D")


def num_of_nonzero_elements(vector):
    return int(np.count_nonzero(vector))


def normalize(my_vector):
    """Normalize a vector by its sum (no-op if the sum is zero)."""
    my_vector = np.array(my_vector)
    total = my_vector.sum()
    if total != 0.0:
        my_vector = my_vector / total
    return my_vector


def normalize_markov_matrix(transition_matrix, reversible=False):
    """Row-normalize a nonnegative matrix into a stochastic matrix.

    With ``reversible=True`` the matrix is symmetrized as ``T + T^T`` first.
    Rows that sum to zero are left as zero rows (reference
    ``msm_we/utils.py:293-313``).
    """
    t_matrix = np.array(transition_matrix, dtype=np.float64)
    if reversible:
        t_matrix = t_matrix.T + t_matrix
    n = t_matrix.shape[0]
    assert n == t_matrix.shape[1], "matrix must be square"
    if (t_matrix < 0).any():
        raise ValueError("All elements in the input matrix must be non-negative")
    row_sums = t_matrix.sum(axis=1)
    nonzero = row_sums != 0.0
    t_matrix[nonzero] = t_matrix[nonzero] / row_sums[nonzero, None]
    return t_matrix


def random_markov_matrix(n_states=5, seed=None):
    """Random row-stochastic matrix from the global numpy RNG (seedable)."""
    if seed is not None:
        np.random.seed(seed)
    return normalize_markov_matrix(np.random.random((n_states, n_states)))


def check_tmatrix(t_matrix, accept_null_rows=True):
    """Validate that ``t_matrix`` is square, nonnegative, rows sum to 1 (or 0)."""
    t = np.asarray(t_matrix, dtype=float)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        raise ValueError("The object given is not a transition matrix")
    if (t < 0).any():
        raise ValueError("The object given is not a transition matrix")
    sums = t.sum(axis=1)
    ok = np.isclose(sums, 1.0, atol=1e-6)
    if accept_null_rows:
        ok |= sums == 0.0
    if not ok.all():
        raise ValueError("The object given is not a transition matrix")
    return False


def clean_tmatrix(transition_matrix, rm_absorbing=True):
    """Remove unvisited (all-zero row) and absorbing (self-loop 1.0) states.

    Returns ``(cleaned_matrix, removed_states)`` where removed_states are the
    original indices, in the removal order of the reference
    (``msm_we/utils.py:372-404``: scanning from the last index down).
    """
    t_matrix = np.array(transition_matrix, dtype=float)
    n_states = len(t_matrix)
    removed_states = []
    for index in range(n_states - 1, -1, -1):
        row = t_matrix[index]
        if not row.any():
            t_matrix = np.delete(np.delete(t_matrix, index, axis=1), index, axis=0)
            removed_states.append(index)
        elif t_matrix[index, index] == 1.0:
            off_diag = np.delete(row, index)
            if off_diag.any():
                raise ValueError(
                    "The sum of the elements in a row of the transition matrix must be one"
                )
            t_matrix = np.delete(np.delete(t_matrix, index, axis=1), index, axis=0)
            removed_states.append(index)
    return normalize_markov_matrix(t_matrix), removed_states


def pops_from_tmatrix(transition_matrix):
    """Stationary distribution: solve ``K^T p = p`` by dense eigendecomposition.

    Follows the reference's eigenvector selection rules exactly
    (``msm_we/utils.py:407-460``): among real eigenvectors with eigenvalue close
    to 1 and uniform sign, pick the one with the most nonzero entries; removed
    (unvisited/absorbing) states are re-inserted with probability 0.
    """
    check_tmatrix(transition_matrix)
    n_states = len(transition_matrix)
    cleaned_matrix, removed_states = clean_tmatrix(transition_matrix)

    eig_vals, eig_vecs = np.linalg.eig(cleaned_matrix.T)
    eig_vecs = eig_vecs.T  # rows are eigenvectors

    close_to_one = np.isclose(eig_vals, 1.0, atol=1e-6)
    new_n_states = n_states - len(removed_states)
    ss_solution = np.zeros(new_n_states)
    for is_close, eigv in zip(close_to_one, eig_vecs):
        if (
            is_close
            and not np.iscomplex(eigv).any()
            and num_of_nonzero_elements(eigv) > num_of_nonzero_elements(ss_solution)
            and ((eigv <= 0).all() or (eigv >= 0).all())
        ):
            ss_solution = eigv

    if (ss_solution == 0.0).all():
        raise RuntimeError(
            "No steady-state solution found for the given transition matrix"
        )

    ss_solution = normalize(ss_solution).real
    for index in sorted(removed_states):
        ss_solution = np.insert(ss_solution, index, 0.0)
    return ss_solution


def pops_from_nm_tmatrix(transition_matrix):
    """Physical-state populations from a colored (2n x 2n) transition matrix.

    Sums the A-labeled (even) and B-labeled (odd) populations of each physical
    state (reference ``msm_we/utils.py:463-487``).
    """
    check_tmatrix(transition_matrix, accept_null_rows=True)
    size = len(transition_matrix)
    if size % 2 != 0:
        raise ValueError(
            "The non-Markovian transition matrix has to have an even number of columns/rows"
        )
    pops_nm = pops_from_tmatrix(transition_matrix)
    return pops_nm[0::2] + pops_nm[1::2]


def map_to_integers(sequence, mapping_dict=None):
    """Map a sequence of hashables to consecutive integers, first-seen order."""
    if mapping_dict is None:
        mapping_dict = {}
    new_sequence = np.zeros(len(sequence), dtype="int64")
    for i, element in enumerate(sequence):
        if element not in mapping_dict:
            mapping_dict[element] = len(mapping_dict)
        new_sequence[i] = mapping_dict[element]
    return new_sequence, mapping_dict


def pseudo_nm_tmatrix(markovian_tmatrix, stateA, stateB):
    """Expand a Markov matrix into the colored (2n x 2n) pseudo-non-Markov form.

    Element layout matches the reference (``msm_we/utils.py:510-538``): even
    indices carry the A label, odd indices the B label, with label-switching
    only permitted on entry into the opposite macrostate. Vectorized with
    boolean index masks instead of the reference's quadruple loop.
    """
    check_tmatrix(markovian_tmatrix)
    markovian_tmatrix = np.asarray(markovian_tmatrix, dtype=float)
    n_states = len(markovian_tmatrix)

    # Start from the full Kronecker expansion: every labeled element carries the
    # underlying Markov transition probability.
    p_nm = np.kron(markovian_tmatrix, np.ones((2, 2)))

    in_A = np.zeros(n_states, dtype=bool)
    in_A[np.asarray(list(stateA), dtype=int)] = True
    in_B = np.zeros(n_states, dtype=bool)
    in_B[np.asarray(list(stateB), dtype=int)] = True

    i_idx = np.repeat(np.arange(n_states), n_states)
    j_idx = np.tile(np.arange(n_states), n_states)

    # A-labeled -> A-labeled forbidden when either endpoint is in B
    mask = in_B[i_idx] | in_B[j_idx]
    p_nm[2 * i_idx[mask], 2 * j_idx[mask]] = 0.0
    # B-labeled -> B-labeled forbidden when either endpoint is in A
    mask = in_A[i_idx] | in_A[j_idx]
    p_nm[2 * i_idx[mask] + 1, 2 * j_idx[mask] + 1] = 0.0
    # B-labeled -> A-labeled allowed only on entry into A (j in A, i not in A)
    mask = (~in_A[j_idx]) | in_A[i_idx]
    p_nm[2 * i_idx[mask] + 1, 2 * j_idx[mask]] = 0.0
    # A-labeled -> B-labeled allowed only on entry into B (j in B, i not in B)
    mask = (~in_B[j_idx]) | in_B[i_idx]
    p_nm[2 * i_idx[mask], 2 * j_idx[mask] + 1] = 0.0

    check_tmatrix(p_nm)
    return p_nm
