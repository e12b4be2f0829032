"""Non-Markovian (history-labeled / colored) trajectory models.

Capability parity with the reference ``msm_we/nmm.py`` (NonMarkovModel :16,
MarkovPlusColorModel :442). The per-frame Python counting loops
(``nmm.py:132-158`` and ``nmm.py:494-565``) are replaced by vectorized
label forward-fills and bincount scatter-accumulation -- O(N) array ops with
no Python-level frame loop. Counterpart of ``msm_we_tpu/msm/nmm.py``; host
numpy, over the port's ``msm/fpt.py`` engines.
"""
from __future__ import annotations

import numpy as np

from ..utils import (
    map_to_integers,
    normalize_markov_matrix,
    pops_from_nm_tmatrix,
    pops_from_tmatrix,
    pseudo_nm_tmatrix,
    weighted_choice,
)
from .ensembles import DiscreteEnsemble, DiscretePathEnsemble
from .._logging import log
from .fpt import DirectFPT, MarkovFPT, NonMarkovFPT, _forward_fill, _labels

__all__ = ["NonMarkovModel", "MarkovPlusColorModel"]


class NonMarkovModel(DiscreteEnsemble):
    """History-labeled (colored) MSM from discrete trajectories.

    Builds a ``(2 n_states, 2 n_states)`` colored count/transition matrix where
    even indices carry the "last in A" label and odd indices "last in B"
    (reference ``nmm.py:16-167``). Counting is vectorized: each lag-strided
    chain's colors are a forward-fill of the A/B membership labels, and counts
    are accumulated by ``bincount`` over encoded (row, col) indices.

    Parameters match the reference: ``lag_time``, ``sliding_window``,
    ``stateA``/``stateB`` (index lists), ``clean_traj`` (skip integer
    remapping), ``coarse_macrostates``.
    """

    def __init__(
        self,
        trajectories,
        stateA,
        stateB,
        lag_time=1,
        clean_traj=False,
        sliding_window=True,
        reversible=True,
        markovian=False,
        coarse_macrostates=False,
        **kwargs,
    ):
        if coarse_macrostates:
            new_trajs = []
            for traj in trajectories:
                traj = np.asarray(traj).copy()
                traj[np.isin(traj, stateA)] = stateA[0]
                traj[np.isin(traj, stateB)] = stateB[0]
                new_trajs.append(traj)
            trajectories = new_trajs
            stateA = [stateA[0]]
            stateB = [stateB[0]]

        self._lag_time = lag_time
        self.trajectories = trajectories
        self.stateA = stateA
        self.stateB = stateB
        self.sliding_window = sliding_window
        self.reversible = reversible
        self.markovian = markovian

        self.n_variables = 1  # by construction
        self.discrete = True  # by construction

        # (The reference's check at nmm.py:91 compares int(lag) with itself,
        # which never fires for non-integer lags; this is the intended check.)
        if (self._lag_time < 1) or (int(self._lag_time) != self._lag_time):
            raise ValueError("The lag time should be an integer greater than 1")

        if clean_traj:
            self.n_states = max(int(np.max(traj)) for traj in self.trajectories) + 1
        else:
            self._map_trajectories_to_integers()

        self.fit()

    def _map_trajectories_to_integers(self):
        seq_map = {}
        new_trajs = []
        for seq in self.trajectories:
            newseq, seq_map = map_to_integers(seq, seq_map)
            new_trajs.append(newseq)
        self.stateA = [seq_map[i] for i in self.stateA]
        self.stateB = [seq_map[i] for i in self.stateB]
        self.n_states = len(seq_map)
        self.trajectories = new_trajs
        self.seq_map = seq_map

    def fit(self):
        """Fit colored and Markov count matrices from the trajectory list.

        Semantics identical to the reference loop (``nmm.py:117-167``): with a
        sliding window, every frame pair ``(i - lag, i)`` is counted once, with
        colors propagated along its lag-strided chain; without, only the single
        chain starting at ``lag`` is counted.

        Two conventions inherited from the reference are worth calling out:

        - The first pair of every chain is counted in ``markov_cmatrix`` but
          never in ``nm_cmatrix``: the chain anchor ``traj[start - lag]`` gets
          no color (the reference starts each chain with ``prev_color = None``,
          ``nmm.py:134-147``), so a trajectory whose only A/B visits lie in its
          first ``lag`` frames contributes zero colored counts.
          :class:`MarkovPlusColorModel` uses a different convention (the
          anchor's own label seeds the history window).
        - ``markov_tmatrix`` honors ``self.reversible``. The reference stores
          the flag but hardcodes ``reversible=True`` at ``nmm.py:161``; with
          the default ``reversible=True`` the results are identical.
        """
        n = self.n_states
        lag = self._lag_time
        step = 1 if self.sliding_window else lag

        nm_counts = np.zeros(4 * n * n, dtype=np.float64)
        markov_counts = np.zeros(n * n, dtype=np.float64)

        for traj in self.trajectories:
            traj = np.asarray(traj)
            L = len(traj)
            for start in range(lag, 2 * lag, step):
                idx = np.arange(start, L, lag)
                if len(idx) == 0:
                    continue
                states = traj[idx]
                prev_states = traj[idx - lag]

                # Markov counts: every chain position, including the first
                markov_counts += np.bincount(
                    prev_states * n + states, minlength=n * n
                ).astype(np.float64)

                # Colored counts: chain positions k >= 1 whose previous color is known
                lab = _labels(states, self.stateA, self.stateB)
                color = _forward_fill(lab)
                if len(idx) < 2:
                    continue
                prev_color = color[:-1]
                cur_color = color[1:]
                valid = prev_color >= 0  # cur_color >= 0 follows by fill
                rows = 2 * states[:-1][valid] + (prev_color[valid] == 1)
                cols = 2 * states[1:][valid] + (cur_color[valid] == 1)
                nm_counts += np.bincount(
                    rows * 2 * n + cols, minlength=4 * n * n
                ).astype(np.float64)

        nm_cmatrix = nm_counts.reshape(2 * n, 2 * n)
        markov_cmatrix = markov_counts.reshape(n, n)

        self.nm_cmatrix = nm_cmatrix
        self.markov_cmatrix = markov_cmatrix
        self.nm_tmatrix = normalize_markov_matrix(nm_cmatrix)
        self.markov_tmatrix = normalize_markov_matrix(
            markov_cmatrix, reversible=self.reversible
        )

    @classmethod
    def from_nm_tmatrix(
        cls, transition_matrix, stateA, stateB, sim_length=None, initial_state=0
    ):
        """Generate a discrete trajectory from a colored transition matrix.

        Reference: ``nmm.py:169-193``. Consumes the global numpy RNG through
        :func:`msm_we_tpu_torch.utils.weighted_choice` one draw per step.
        """
        if sim_length is None:
            raise ValueError("The simulation length must be given")
        transition_matrix = np.asarray(transition_matrix)
        n_states = len(transition_matrix)
        assert n_states == transition_matrix.shape[1]

        current_state = initial_state
        discrete_traj = [initial_state // 2]
        for _ in range(sim_length):
            next_state = weighted_choice(
                list(range(n_states)), transition_matrix[current_state, :]
            )
            discrete_traj.append(next_state // 2)
            current_state = next_state
        return cls([np.array(discrete_traj)], stateA, stateB, clean_traj=True)

    @property
    def lag_time(self):
        return self._lag_time

    @lag_time.setter
    def lag_time(self, lag_time):
        self._lag_time = lag_time
        self.fit()

    def mfpts(self):
        if self.markovian:
            return MarkovFPT.mean_fpts(
                self.markov_tmatrix, self.stateA, self.stateB, lag_time=self._lag_time
            )
        return NonMarkovFPT.mean_fpts(
            self.nm_tmatrix, self.stateA, self.stateB, lag_time=self._lag_time
        )

    def empirical_mfpts(self):
        return DirectFPT.mean_fpts(
            self.trajectories, self.stateA, self.stateB, lag_time=self._lag_time
        )

    def empirical_fpts(self):
        return DirectFPT.fpts(
            self.trajectories, self.stateA, self.stateB, lag_time=self._lag_time
        )

    def populations(self):
        if self.markovian:
            return pops_from_tmatrix(self.markov_tmatrix)
        return pops_from_nm_tmatrix(self.nm_tmatrix)

    @property
    def popA(self):
        pops = self.populations()
        return float(sum(p for i, p in enumerate(pops) if i in self.stateA))

    @property
    def popB(self):
        pops = self.populations()
        return float(sum(p for i, p in enumerate(pops) if i in self.stateB))

    def _directional_tmatrix(self, keep_state, label_parity):
        """Shared A->B / B->A directional matrix construction.

        ``label_parity`` 0 extracts the A-labeled (even) block for tmatrixAB
        with ``keep_state = stateB`` absorbing; parity 1 extracts the B-labeled
        block for tmatrixBA with ``stateA`` absorbing. Reference
        ``nmm.py:249-291``.
        """
        n = self.n_states
        idx = 2 * np.arange(n) + label_parity
        block = self.nm_tmatrix[np.ix_(idx, idx)]
        # Transitions into the absorbing macrostate come from the
        # opposite-label column (the label switch on entry)
        other = idx + (1 if label_parity == 0 else -1)
        cross = self.nm_tmatrix[np.ix_(idx, other)]
        in_state = np.isin(np.arange(n), keep_state)

        row_in = in_state[:, None]
        col_in = in_state[None, :]
        # Non-absorbing rows keep the same-label block, except columns into
        # the absorbing set, which take the opposite-label (entry) column;
        # absorbing rows are identity
        out = np.where(col_in, cross, block)
        return np.where(row_in, np.where(col_in, np.eye(n), 0.0), out)

    def tmatrixAB(self):
        if self.markovian:
            return self.markov_tmatrix
        return self._directional_tmatrix(self.stateB, 0)

    def tmatrixBA(self):
        if self.markovian:
            return self.markov_tmatrix
        return self._directional_tmatrix(self.stateA, 1)

    def fluxAB_distribution_on_B(self):
        """Distribution of the A->B flux over the target states B."""
        t_matrix = (
            pseudo_nm_tmatrix(self.markov_tmatrix, self.stateA, self.stateB)
            if self.markovian
            else self.nm_tmatrix
        )
        labeled_pops = pops_from_tmatrix(t_matrix)
        distrib_on_B = np.zeros(len(self.stateB))
        for bi, b in enumerate(self.stateB):
            cols = [2 * b, 2 * b + 1]
            distrib_on_B[bi] = labeled_pops[0::2] @ t_matrix[0::2][:, cols].sum(axis=1)
        return distrib_on_B

    def fluxBA_distribution_on_A(self):
        """Distribution of the B->A flux over the source states A."""
        t_matrix = (
            pseudo_nm_tmatrix(self.markov_tmatrix, self.stateA, self.stateB)
            if self.markovian
            else self.nm_tmatrix
        )
        labeled_pops = pops_from_tmatrix(t_matrix)
        distrib_on_A = np.zeros(len(self.stateA))
        for ai, a in enumerate(self.stateA):
            cols = [2 * a, 2 * a + 1]
            distrib_on_A[ai] = labeled_pops[1::2] @ t_matrix[1::2][:, cols].sum(axis=1)
        return distrib_on_A

    def fpt_distrib_AB(self, max_x=1000, dt=1):
        return MarkovFPT.fpt_distribution(
            self.tmatrixAB(),
            self.stateA,
            self.stateB,
            self.fluxBA_distribution_on_A(),
            max_n_lags=max_x,
            lag_time=self._lag_time,
            dt=dt,
        )

    def fpt_distrib_BA(self, max_x=1000, dt=1):
        return MarkovFPT.fpt_distribution(
            self.tmatrixBA(),
            self.stateB,
            self.stateA,
            self.fluxAB_distribution_on_B(),
            max_n_lags=max_x,
            lag_time=self._lag_time,
            dt=dt,
        )

    def corr_function(self, times):
        """Time correlation functions p_AA, p_AB, p_BA, p_BB at the given times.

        Reference: ``nmm.py:347-414``.
        """
        pAA, pAB, pBA, pBB = [], [], [], []
        t_matrix = self.markov_tmatrix if self.markovian else self.nm_tmatrix
        tot = self.n_states if self.markovian else 2 * self.n_states
        # Loop-invariant: one eigendecomposition, not one per time point
        pops_eq = self.populations()

        for dt in times:
            if dt % self.lag_time != 0:
                raise ValueError("The times given should be multiple of the lag time")
            n = int(dt / self.lag_time)
            t_n = np.linalg.matrix_power(t_matrix.T, n)

            popsA = np.zeros(tot)
            popsB = np.zeros(tot)
            if self.markovian:
                popsA[self.stateA] = pops_eq[self.stateA]
                popsB[self.stateB] = pops_eq[self.stateB]
                from_A = t_n @ popsA
                from_B = t_n @ popsB
                pAA.append(from_A[self.stateA].sum())
                pBB.append(from_B[self.stateB].sum())
                pAB.append(from_B[self.stateA].sum())
                pBA.append(from_A[self.stateB].sum())
            else:
                popsA[2 * np.asarray(self.stateA)] = pops_eq[self.stateA]
                popsB[2 * np.asarray(self.stateB) + 1] = pops_eq[self.stateB]
                from_A = t_n @ popsA
                from_B = t_n @ popsB
                pAA.append(from_A[2 * np.asarray(self.stateA)].sum())
                pBB.append(from_B[2 * np.asarray(self.stateB) + 1].sum())
                pAB.append(from_B[2 * np.asarray(self.stateA)].sum())
                pBA.append(from_A[2 * np.asarray(self.stateB) + 1].sum())
        return pAA, pAB, pBA, pBB

    def empirical_weighted_FS(self, tmatrix_for_classification=None, symmetric=True):
        if tmatrix_for_classification is None:
            tmatrix_for_classification = self.markov_tmatrix
        ens = DiscretePathEnsemble.from_ensemble(self, self.stateA, self.stateB)
        return ens.weighted_fundamental_sequences(tmatrix_for_classification, symmetric)

    def weighted_FS(self, tmatrix_for_classification=None, n_paths=1000, symmetric=True):
        if tmatrix_for_classification is None:
            tmatrix_for_classification = self.markov_tmatrix
        tmatrix_to_generate = (
            self.markov_tmatrix if self.markovian else self.tmatrixAB()
        )
        ens = DiscretePathEnsemble.from_transition_matrix(
            tmatrix_to_generate, self.stateA, self.stateB, n_paths
        )
        return ens.weighted_fundamental_sequences(tmatrix_for_classification, symmetric)


class MarkovPlusColorModel(NonMarkovModel):
    """Markov-plus-color model with finite history length.

    Frames whose history window contains no A/B visit get the "unknown" color
    U; their counts are flux-split across the colored cells in proportion to
    the pseudo-Markov flux matrix (reference ``nmm.py:442-571``). The split is
    computed blockwise over the (n, n) pair-count matrices rather than frame by
    frame.
    """

    def __init__(
        self,
        trajectories,
        stateA,
        stateB,
        lag_time=1,
        clean_traj=False,
        sliding_window=True,
        hist_length=0,
        **kwargs,
    ):
        self.hist_length = hist_length
        super().__init__(
            trajectories, stateA, stateB, lag_time, clean_traj, sliding_window, **kwargs
        )

    def fit(self):
        n = self.n_states
        lag = self._lag_time
        hlength = self.hist_length
        step = 1 if self.sliding_window else lag

        # --- Markov transition matrix first (symmetrized)
        markov_counts = np.zeros(n * n, dtype=np.float64)
        for traj in self.trajectories:
            traj = np.asarray(traj)
            idx = np.arange(lag, len(traj), step)
            if len(idx) == 0:
                continue
            markov_counts += np.bincount(
                traj[idx - lag] * n + traj[idx], minlength=n * n
            ).astype(np.float64)
        markov_tmatrix = markov_counts.reshape(n, n)
        markov_tmatrix = markov_tmatrix + markov_tmatrix.T
        markov_tmatrix = normalize_markov_matrix(markov_tmatrix)

        # Pseudo-Markov flux matrix: rows of the colored expansion scaled by
        # the labeled populations
        p_nm_tmatrix = pseudo_nm_tmatrix(markov_tmatrix, self.stateA, self.stateB)
        pops = pops_from_tmatrix(p_nm_tmatrix)
        fmatrix = p_nm_tmatrix * pops[:, None]

        # --- Colored counting with history-limited color lookup
        nm_tmatrix = np.zeros((2 * n, 2 * n), dtype=np.float64)

        # Pair-count matrices for the U-colored categories, accumulated over
        # all trajectories, split blockwise afterwards
        counts_UA = np.zeros(n * n, dtype=np.float64)
        counts_UB = np.zeros(n * n, dtype=np.float64)
        counts_UU = np.zeros(n * n, dtype=np.float64)
        nm_counts_known = np.zeros(4 * n * n, dtype=np.float64)

        for traj in self.trajectories:
            traj = np.asarray(traj)
            L = len(traj)
            idx = np.arange(lag, L, step)
            if len(idx) == 0:
                continue

            lab = _labels(traj, self.stateA, self.stateB)
            last_labeled = np.maximum.accumulate(np.where(lab >= 0, np.arange(L), -1))

            # Previous color: most recent labeled frame at or before i - lag,
            # but not older than max(i - lag - hlength, 0)
            anchor = idx - lag
            cand = last_labeled[anchor]
            window_start = np.maximum(anchor - hlength, 0)
            has_prev = cand >= window_start
            prev_color = np.where(has_prev, lab[np.maximum(cand, 0)], -1)

            # Current color: own label, else inherited
            cur_lab = lab[idx]
            cur_color = np.where(cur_lab >= 0, cur_lab, prev_color)

            a = traj[anchor]
            b = traj[idx]

            known = prev_color >= 0
            if known.any():
                rows = 2 * a[known] + (prev_color[known] == 1)
                cols = 2 * b[known] + (cur_color[known] == 1)
                nm_counts_known += np.bincount(
                    rows * 2 * n + cols, minlength=4 * n * n
                ).astype(np.float64)

            u_mask = ~known
            if u_mask.any():
                keys = a[u_mask] * n + b[u_mask]
                cu = cur_color[u_mask]
                counts_UA += np.bincount(keys[cu == 0], minlength=n * n).astype(float)
                counts_UB += np.bincount(keys[cu == 1], minlength=n * n).astype(float)
                counts_UU += np.bincount(keys[cu == -1], minlength=n * n).astype(float)

        nm_tmatrix += nm_counts_known.reshape(2 * n, 2 * n)

        # Blockwise flux splits. Block views of the colored matrix:
        #   [2a, 2b] = AA-cell, [2a, 2b+1] = AB-cell, etc.
        f_ee = fmatrix[0::2, 0::2]  # A-labeled -> A-labeled
        f_eo = fmatrix[0::2, 1::2]  # A-labeled -> B-labeled
        f_oe = fmatrix[1::2, 0::2]
        f_oo = fmatrix[1::2, 1::2]

        C_UB = counts_UB.reshape(n, n)
        C_UA = counts_UA.reshape(n, n)
        C_UU = counts_UU.reshape(n, n)

        with np.errstate(invalid="ignore", divide="ignore"):
            # U -> B: split between the two source labels, into the B-labeled column
            s = f_eo + f_oo
            nm_tmatrix[0::2, 1::2] += np.where(C_UB > 0, C_UB * f_eo / s, 0.0)
            nm_tmatrix[1::2, 1::2] += np.where(C_UB > 0, C_UB * f_oo / s, 0.0)
            # U -> A: into the A-labeled column
            s = f_ee + f_oe
            nm_tmatrix[0::2, 0::2] += np.where(C_UA > 0, C_UA * f_ee / s, 0.0)
            nm_tmatrix[1::2, 0::2] += np.where(C_UA > 0, C_UA * f_oe / s, 0.0)
            # U -> U: across all four cells
            s = f_ee + f_eo + f_oe + f_oo
            nm_tmatrix[0::2, 1::2] += np.where(C_UU > 0, C_UU * f_eo / s, 0.0)
            nm_tmatrix[1::2, 1::2] += np.where(C_UU > 0, C_UU * f_oo / s, 0.0)
            nm_tmatrix[0::2, 0::2] += np.where(C_UU > 0, C_UU * f_ee / s, 0.0)
            nm_tmatrix[1::2, 0::2] += np.where(C_UU > 0, C_UU * f_oe / s, 0.0)

        if np.isnan(nm_tmatrix).any():
            # 0/0 in a flux split: a U-colored pair was observed between
            # states whose pseudo-Markov stationary flux is zero (e.g. a
            # disconnected component). The reference produces the same NaNs
            # (``nmm.py:526-571`` divides by the bare ``temp_sum``); we keep
            # the numerics but don't let it pass silently.
            log.warning(
                "Flux-splitting produced NaN rows: U-colored transitions were "
                "observed between states with zero pseudo-Markov stationary "
                "flux (disconnected components?). Downstream MFPTs from "
                "these rows will be NaN."
            )

        self.nm_cmatrix = nm_tmatrix.copy()  # un-normalized, like a count matrix
        self.nm_tmatrix = normalize_markov_matrix(nm_tmatrix)
        self.markov_tmatrix = markov_tmatrix

    def populations(self):
        # The reference (msm_we/nmm.py:574) *returns* the exception object
        # instead of raising it — a known upstream bug.  We raise.
        raise NotImplementedError(
            "You should use a regular Markov model or a non-Markovian model "
            "for estimating populations"
        )
