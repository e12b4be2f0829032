"""Trajectory-ensemble containers and path analysis.

Capability parity with the reference ``msm_we/ensembles.py`` (Ensemble :18,
PathEnsemble :208, DiscreteEnsemble :304, DiscretePathEnsemble :380). The
per-frame counting/classification loops are vectorized (forward-filled colors,
bincount pair counting); path *generation* from a transition matrix stays a
sequential host loop because it consumes the global numpy RNG one draw per
step, a semantic the seeded reference tests pin down. Counterpart of
``msm_we_tpu/msm/ensembles.py``; the shortest paths of the fundamental
sequences come from :func:`dijkstra_path` here instead of networkx.
"""
from __future__ import annotations

import heapq
from copy import deepcopy
from itertools import count
from math import log as _mathlog

import numpy as np

from ..utils import Interval, get_shape, reverse_sort_lists, weighted_choice
from .fpt import DirectFPT, NonMarkovFPT, _forward_fill, _membership

__all__ = [
    "Ensemble", "PathEnsemble", "DiscreteEnsemble", "DiscretePathEnsemble",
    "dijkstra_path",
]


def dijkstra_path(adjacency, source, target):
    """Shortest path from ``source`` to ``target`` in a weighted digraph.

    ``adjacency`` maps each node to a dict ``{successor: distance}`` whose
    order is the order the edges were added. Among paths of equal length
    the result is the one ``networkx.dijkstra_path`` returns: the fringe is
    a heap of ``(distance, insertion counter, node)``, a node's
    predecessor changes only on a strictly shorter distance, and the
    search stops when ``target`` is popped.
    """
    if source not in adjacency:
        raise KeyError(f"source node {source} is not in the graph")
    if source == target:
        return [source]
    dist = {}  # final distances
    seen = {source: 0}
    pred = {source: None}
    tie = count()
    fringe = [(0, next(tie), source)]
    while fringe:
        d, _, v = heapq.heappop(fringe)
        if v in dist:
            continue  # already settled
        dist[v] = d
        if v == target:
            break
        for u, cost in adjacency[v].items():
            vu_dist = d + cost
            if u in dist:
                if vu_dist < dist[u]:
                    raise ValueError("Contradictory paths found: negative weights?")
            elif u not in seen or vu_dist < seen[u]:
                seen[u] = vu_dist
                heapq.heappush(fringe, (vu_dist, next(tie), u))
                pred[u] = v
    if target not in dist:
        raise ValueError(f"no path from {source} to {target}")
    path = [target]
    while pred[path[-1]] is not None:
        path.append(pred[path[-1]])
    return path[::-1]


class Ensemble:
    """A list of space-continuous trajectories.

    Each trajectory is an array whose rows are snapshots and whose columns are
    variables. Reference: ``ensembles.py:18-205``.
    """

    def __init__(
        self,
        trajectories=None,
        verbose=False,
        dtype="float32",
        discrete=False,
        lag_time=1,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.dtype = dtype
        self.discrete = discrete
        self.verbose = verbose
        self._lag_time = lag_time

        if trajectories is None or len(trajectories) == 0:
            self.trajectories = []
            self.n_variables = 0
            if verbose:
                print("\nEmpty ensemble generated")
            return

        _n_snapshots, _n_variables = get_shape(trajectories[0])
        traj_length = 0.0
        for element in trajectories:
            traj_length += len(element)
            _, n_variables = get_shape(element)
            if n_variables != _n_variables:
                raise ValueError(
                    "Error: All the trajectories must have the same number of variables"
                )

        self.n_variables = _n_variables
        self.trajectories = trajectories
        if verbose:
            print(
                "Read {} ({}-dimensional) trajectories of average length {}.".format(
                    len(trajectories), _n_variables, traj_length / len(trajectories)
                )
            )

    def add_trajectory(self, trajectory):
        """Append one trajectory, enforcing a consistent number of variables."""
        if not isinstance(trajectory, np.ndarray):
            trajectory = np.array(trajectory, dtype=self.dtype)

        _, _n_variables = get_shape(trajectory)
        if self.n_variables == 0:
            self.trajectories = [trajectory]
            self.n_variables = _n_variables
        else:
            if self.n_variables != _n_variables:
                raise ValueError(
                    "All the trajectories in the same ensemble must have the "
                    "same number of variables"
                )
            self.trajectories.append(trajectory)
        if self.verbose:
            print(self)

    def __len__(self):
        return len(self.trajectories)

    def __str__(self):
        feature = "Discrete, " if self.discrete else "Continuous, "
        return (
            "\n"
            + feature
            + "{} with {} ({}-dimensional) trajectories".format(
                self.__class__.__name__, len(self), self.n_variables
            )
            + "\nTotal number of snapshots: {}".format(
                sum(len(traj) for traj in self)
            )
        )

    def __add__(self, other):
        ensemble_sum = deepcopy(self)
        for traj in other.trajectories:
            ensemble_sum.add_trajectory(traj)
        return ensemble_sum

    def __iadd__(self, other):
        # In place: delegating to __add__ would deep-copy the whole
        # accumulated ensemble on every +=, O(total^2) over a loop.
        # Snapshot the source list so `ens += ens` terminates instead of
        # iterating a list we are appending to.
        for traj in list(other.trajectories):
            self.add_trajectory(traj)
        return self

    def __iter__(self):
        return iter(self.trajectories)

    def __getitem__(self, arg):
        return self.trajectories[arg]

    def empirical_mfpts(self, stateA, stateB):
        return DirectFPT.mean_fpts(
            self.trajectories,
            stateA,
            stateB,
            discrete=self.discrete,
            n_variables=self.n_variables,
            lag_time=self._lag_time,
        )

    def _count_matrix(self, n_states=None, map_function=None):
        """Count matrix of consecutive-snapshot transitions under ``map_function``.

        The mapping callable is applied per snapshot (arbitrary user code); the
        pair counting itself is a vectorized bincount. Reference
        ``ensembles.py:147-165``.
        """
        if map_function is None or n_states is None:
            raise ValueError(
                "The number of states and a map function have to be given as argument"
            )
        count_matrix = np.zeros(n_states * n_states)
        for traj in self.trajectories:
            mapped = np.fromiter(
                (map_function(snapshot) for snapshot in traj), dtype=np.int64
            )
            if len(mapped) < 2:
                continue
            count_matrix += np.bincount(
                mapped[:-1] * n_states + mapped[1:], minlength=n_states * n_states
            ).astype(np.float64)
        return count_matrix.reshape(n_states, n_states)

    def _mle_transition_matrix(self, n_states, map_function):
        count_matrix = self._count_matrix(n_states, map_function)
        row_sums = count_matrix.sum(axis=1)
        nonzero = row_sums != 0.0
        transition_matrix = count_matrix.copy()
        transition_matrix[nonzero] /= row_sums[nonzero, None]
        return transition_matrix

    def empirical_corr_function(self, stateA, stateB, times, symmetric=True):
        """Empirical cross-correlation of macrostate indicators at the given delays.

        Vectorized over frames (reference loop at ``ensembles.py:180-205``).
        """
        n_dim = self.n_variables
        stateA = Interval(stateA, n_dim) if not self.discrete else stateA
        stateB = Interval(stateB, n_dim) if not self.discrete else stateB

        corr_values = []
        for delay in times:
            assert isinstance(delay, (int, np.integer)) and delay >= 1
            sum_ = 0.0
            counts = 0
            for traj in self.trajectories:
                in_A = _membership(np.asarray(traj), stateA, self.discrete)
                in_B = _membership(np.asarray(traj), stateB, self.discrete)
                n = len(traj) - delay
                if n <= 0:
                    continue
                sum_ += np.sum(in_A[:n] & in_B[delay:])
                counts += n
                if symmetric:
                    sum_ += np.sum(in_B[:n] & in_A[delay:])
                    counts += n
            # No trajectory long enough for this delay -> NaN, not a crash
            corr_values.append(sum_ / counts if counts else np.nan)
        return corr_values


class PathEnsemble(Ensemble):
    """Ensemble of reactive A->B path segments."""

    def __init__(
        self,
        trajectories=None,
        verbose=False,
        dtype="float32",
        discrete=False,
        lag_time=1,
        stateA=None,
        stateB=None,
        **kwargs,
    ):
        super().__init__(trajectories, verbose, dtype, discrete, lag_time, **kwargs)
        if stateA is None or stateB is None:
            raise ValueError(
                "The initial state (stateA) and final state (stateB) have to be specified"
            )
        self.stateA = stateA
        self.stateB = stateB

    @classmethod
    def from_ensemble(
        cls,
        ensemble,
        stateA=None,
        stateB=None,
        map_function=None,
        discrete=False,
        dtype="float32",
    ):
        """Extract every reactive A->B path from an ensemble.

        A path consists of all frames colored A since the previous A->B
        event, plus the event frame itself (reference semantics,
        ``ensembles.py:232-298``), computed here from a vectorized
        forward-filled color array.
        """
        if stateA is None or stateB is None:
            raise ValueError(
                "The initial state (stateA) and final state (stateB) have to be specified"
            )

        n_variables = np.size(ensemble[0][0]) if np.size(ensemble[0][0]) else 1
        list_of_pathsAB = []

        if not discrete:
            intervalA = Interval(stateA, n_variables)
            intervalB = Interval(stateB, n_variables)

        for traj in ensemble.trajectories:
            traj = np.asarray(traj)
            if map_function is not None:
                snapshots = np.array([map_function(s) for s in traj])
            else:
                snapshots = traj

            if discrete:
                # Column-vector (n, 1) discrete trajectories must flatten:
                # 2-D membership labels would silently yield zero paths
                labels = np.asarray(snapshots)
                if labels.ndim > 1:
                    labels = labels[:, 0]
                in_A = np.isin(labels, stateA)
                in_B = np.isin(labels, stateB)
            else:
                in_A = _membership(snapshots, intervalA, False)
                in_B = _membership(snapshots, intervalB, False)

            lab = np.where(in_A, 0, np.where(in_B, 1, -1))
            color = _forward_fill(lab)

            events = (
                np.flatnonzero(
                    (color[1:] == 1) & (color[:-1] == 0)
                )
                + 1
            )
            prev_event = -1
            for e in events:
                segment = np.arange(prev_event + 1, e)
                frames = segment[color[segment] == 0]
                path = np.concatenate([snapshots[frames], snapshots[[e]]])
                list_of_pathsAB.append(np.array(path, dtype=dtype))
                prev_event = e

        return cls(
            list_of_pathsAB, stateA=stateA, stateB=stateB, dtype=dtype, discrete=discrete
        )

    def cluster(self, distance_metric, n_cluster=10, method="K-means"):
        raise NotImplementedError("Not implemented yet")


class DiscreteEnsemble(Ensemble):
    """Ensemble of 1-D integer (discrete-state) trajectories."""

    def __init__(
        self,
        trajectories=None,
        verbose=False,
        dtype="int32",
        discrete=True,
        lag_time=1,
        **kwargs,
    ):
        super().__init__(trajectories, verbose, dtype, discrete, lag_time, **kwargs)
        if self.n_variables not in (0, 1):
            raise ValueError(
                "A discrete trajectory must have a one-dimensional index/variable "
                "unless it is empty"
            )
        self.n_variables = 1

    @classmethod
    def from_ensemble(cls, ens, map_function=None, dtype="int32"):
        """Discretize an ensemble (or raw trajectory list) with ``map_function``."""
        if map_function is None:
            raise ValueError("A map function has to be given as argument")

        if isinstance(ens, Ensemble):
            discrete_trajs_list = [
                np.array([map_function(snapshot) for snapshot in traj], dtype=dtype)
                for traj in ens.trajectories
            ]
            return cls(discrete_trajs_list)
        d_traj = np.array([map_function(snapshot) for snapshot in ens], dtype=dtype)
        return cls([d_traj])

    @classmethod
    def from_transition_matrix(cls, transition_matrix, sim_length=None, initial_state=0):
        """Sample one discrete trajectory from a transition matrix.

        Sequential by nature; consumes the global numpy RNG one draw per step
        (reference ``ensembles.py:353-377``).
        """
        if sim_length is None:
            raise ValueError("The simulation length must be given")
        transition_matrix = np.asarray(transition_matrix)
        n_states = len(transition_matrix)
        assert n_states == transition_matrix.shape[1]

        current_state = initial_state
        discrete_traj = [initial_state]
        for _ in range(sim_length):
            next_state = weighted_choice(
                list(range(n_states)), transition_matrix[current_state, :]
            )
            discrete_traj.append(next_state)
            current_state = next_state
        return cls([np.array(discrete_traj)])


class DiscretePathEnsemble(PathEnsemble, DiscreteEnsemble):
    """Discrete reactive-path ensemble with fundamental-sequence analysis."""

    def __init__(
        self,
        trajectories=None,
        verbose=False,
        dtype="int32",
        discrete=True,
        lag_time=1,
        stateA=None,
        stateB=None,
        **kwargs,
    ):
        super().__init__(
            trajectories, verbose, dtype, discrete, lag_time, stateA, stateB, **kwargs
        )

    @classmethod
    def from_transition_matrix(
        cls,
        transition_matrix,
        stateA=None,
        stateB=None,
        n_paths=1000,
        ini_pops=None,
        max_iters=1000000000,
    ):
        """Sample ``n_paths`` A->B paths from a transition matrix.

        RNG consumption matches the reference exactly (one ``weighted_choice``
        for the initial state, one per step; ``ensembles.py:399-463``), so
        seeded tests reproduce.
        """
        if ini_pops is None:
            ini_pops = [1 / float(len(stateA))] * len(stateA)
        elif isinstance(ini_pops, str) and ini_pops == "ss":
            # Start-state distribution = the stationary distribution
            # restricted to A (the reference declares but never implements
            # this option, ``ensembles.py:434-435``)
            from ..utils import pops_from_tmatrix

            pops = pops_from_tmatrix(np.asarray(transition_matrix))
            sub = np.asarray([pops[s] for s in stateA], dtype=float)
            total = sub.sum()
            ini_pops = (
                list(sub / total)
                if total > 0
                else [1 / float(len(stateA))] * len(stateA)
            )

        transition_matrix = np.asarray(transition_matrix)
        n_states = len(transition_matrix)
        assert n_states == transition_matrix.shape[1]

        d_trajectories = []
        for _ in range(n_paths):
            current_state = weighted_choice(stateA, ini_pops)
            path = [current_state]
            for j in range(max_iters):
                next_state = weighted_choice(
                    list(range(n_states)), transition_matrix[current_state, :]
                )
                path.append(next_state)
                current_state = next_state
                if j + 1 == max_iters:
                    print(
                        "\nWARNING: max iteration reached when generating "
                        "the path ensemble, consider to increase max_iters"
                    )
                if current_state in stateB:
                    break
            d_trajectories.append(np.array(path))

        return cls(d_trajectories, stateA=stateA, stateB=stateB)

    @classmethod
    def from_ensemble(cls, ensemble, stateA, stateB, map_function=None):
        ens = PathEnsemble.from_ensemble(
            ensemble, stateA, stateB, map_function, discrete=True, dtype="int32"
        )
        return cls(ens.trajectories, stateA=stateA, stateB=stateB)

    def nm_mfpt(self, ini_probs=None, n_states=None, map_function=None):
        """MFPT from the MLE transition matrix of the path ensemble.

        ``map_function`` defaults to identity -- the trajectories here are
        already discrete. (The reference's version is uncallable: it passes
        no map_function to a function that requires one,
        ``ensembles.py:473-475``.)
        """
        if map_function is None:
            map_function = lambda x: x  # noqa: E731 - identity for discrete states
        t_matrix = self._mle_transition_matrix(n_states, map_function)
        return NonMarkovFPT.directional_mfpt(
            t_matrix, list(self.stateA), sorted(self.stateB), ini_probs
        )

    def _fundamental_sequences(self, transition_matrix, symmetric=True):
        """Classify each path into its fundamental sequence.

        Dijkstra shortest path on the -log(T_ij) graph restricted to the
        transitions observed in the path (reference ``ensembles.py:483-501``).
        """
        fundamental_seqs = []
        matrix = (
            transition_matrix * transition_matrix.T
            if symmetric
            else transition_matrix
        )
        for path in self.trajectories:
            cmatrix = self._connectivity_matrix(path, matrix)
            path_graph = self._graph_from_matrix(cmatrix)
            shortest_path = dijkstra_path(path_graph, int(path[0]), int(path[-1]))
            fundamental_seqs.append(shortest_path)
        return fundamental_seqs

    def weighted_fundamental_sequences(self, transition_matrix=None, symmetric=True):
        """Fundamental sequences with empirical weights, sorted heaviest first."""
        fs_list = self._fundamental_sequences(transition_matrix, symmetric)
        element_count = {}
        tot_count = 0
        for element in fs_list:
            key = tuple(element)
            tot_count += 1
            element_count[key] = element_count.get(key, 0) + 1

        weights = [v / float(tot_count) for v in element_count.values()]
        new_fs_list = list(element_count.keys())
        sorted_weights, sorted_fs = reverse_sort_lists(weights, new_fs_list)
        return sorted_fs, sorted_weights, tot_count

    @staticmethod
    def _graph_from_matrix(matrix):
        """Directed graph with edge distance -log(T_ij) for nonzero
        off-diagonals, as an adjacency dict ``{node: {successor: distance}}``
        for :func:`dijkstra_path` (edges in row-major order)."""
        matrix = np.asarray(matrix)
        size = len(matrix)
        assert size == matrix.shape[1]

        G = {i: {} for i in range(size)}
        ii, jj = np.nonzero(matrix)
        for i, j in zip(ii, jj):
            if i != j:
                G[int(i)][int(j)] = -_mathlog(matrix[i, j])
        return G

    @staticmethod
    def _connectivity_matrix(path, matrix):
        """Keep only the matrix entries for transitions observed in ``path``."""
        matrix = np.asarray(matrix)
        path = np.asarray(path, dtype="int32")
        n_states = len(matrix)
        assert n_states == matrix.shape[1]

        c_matrix = np.zeros((n_states, n_states))
        c_matrix[path[:-1], path[1:]] = matrix[path[:-1], path[1:]]
        return c_matrix
