"""First-passage-time (FPT) engines: empirical tracing and matrix methods.

Counterpart of ``msm_we_tpu/msm/fpt.py`` (reference ``msm_we/fpt.py``:
DirectFPT :15, MatrixFPT :219, MarkovFPT :805, NonMarkovFPT :863). The
host engines are float64 numpy, copied. The two device engines
(``engine="device"`` with an explicit ``device=``) are torch in float64:

* :func:`_device_fpt_pdfs`, the F-matrix recursion of
  :meth:`MatrixFPT.fpt_distribution`: the bit basis ``S[j] = T^(2^j)`` is
  squared out once, and each lag step multiplies only the basis entries of
  its step's set bits;
* :class:`_DeviceVectorPowers`, the lazily extended bit basis of
  :meth:`MatrixFPT.adaptive_fpt_distribution`: each probe folds the
  initial vector through the step's set bits.

The JAX package runs these in f32 because a TPU emulates f64; an H100
runs f64 GEMMs on its tensor cores, so here they keep the host engines'
precision (and the adaptive schedule of the host engine). Products are
``torch.matmul``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import utils
from .._device import as_device
from ..utils import Interval

__all__ = ["DirectFPT", "MatrixFPT", "MarkovFPT", "NonMarkovFPT"]


def _bits(step):
    """Indices of the set bits of a non-negative step, ascending."""
    return [j for j in range(int(step).bit_length()) if (int(step) >> j) & 1]


def _device_fpt_pdfs(tmatrix, lag_list, ini_state, target, device):
    """F-matrix recursion ``F(t) = T^step @ (F(t_prev) - diag(F(t_prev)))``
    (Suarez et al. 2016 Eq. 3; reference ``fpt.py:776-802``) in f64 on
    ``device``, starting from ``F = T``. Returns the ``(n_ini, n_lags)``
    readouts ``F[ini, target]`` (one download at the end)."""
    device = as_device(device)
    lag_list = np.asarray(lag_list, dtype=np.int64)
    steps = np.diff(np.concatenate([[0], lag_list]))
    T = torch.as_tensor(np.asarray(tmatrix, np.float64), device=device)
    n_bits = max(int(s).bit_length() for s in steps) if len(steps) else 0
    basis = [T]
    for _ in range(1, n_bits):
        basis.append(basis[-1] @ basis[-1])
    ini = torch.as_tensor(np.asarray(ini_state, dtype=np.int64), device=device)
    F = T
    out = []
    for step in steps:
        F = F - torch.diag(torch.diag(F))
        for j in _bits(step):
            F = basis[j] @ F
        out.append(F[ini, target])
    if not out:
        return np.zeros((len(ini_state), 0))
    return torch.stack(out, dim=1).cpu().numpy()


class _DeviceVectorPowers:
    """``v0 @ T^step`` in f64 on ``device`` through a lazily extended bit
    basis ``S[j] = T^(2^j)``: the basis is squared out only as far as the
    largest step probed yet (about log2(max step) GEMMs in all), and each
    probe multiplies the vector by the basis entries of the step's set
    bits (vector-matrix products). One host read per probe."""

    def __init__(self, tmatrix, v0, device):
        device = as_device(device)
        self._basis = [torch.as_tensor(np.asarray(tmatrix, np.float64), device=device)]
        self._v0 = torch.as_tensor(np.asarray(v0, np.float64), device=device)

    def __call__(self, step):
        step = int(step)
        if step <= 0:
            return self._v0.cpu().numpy()
        while len(self._basis) < step.bit_length():
            self._basis.append(self._basis[-1] @ self._basis[-1])
        u = self._v0
        for j in _bits(step):
            u = u @ self._basis[j]
        return u.cpu().numpy()

def _membership(points, state, discrete):
    """Vectorized membership of an array of snapshots in a macrostate.

    ``state`` is a list of integers for discrete trajectories, or an
    :class:`Interval` (or raw interval spec) for continuous ones. Common
    interval shapes are evaluated vectorized; anything exotic falls back to the
    per-row ``in`` operator.
    """
    points = np.asarray(points)
    if discrete:
        return np.isin(points, np.asarray(list(state)))

    interval = state if isinstance(state, Interval) else None
    if interval is None:
        raise TypeError("Continuous membership requires an Interval instance")

    spec = np.asarray(interval.interval_set, dtype=float)
    n_var = interval.n_variables

    if n_var == 1:
        pts = points.reshape(len(points), -1)[:, 0] if points.ndim > 1 else points
        if spec.ndim == 1:  # single 1-D interval
            return (spec[0] <= pts) & (pts < spec[1])
        if spec.ndim == 2:  # union of 1-D intervals
            return np.logical_or.reduce(
                [(lo <= pts) & (pts < hi) for lo, hi in spec]
            )
    else:
        pts = points.reshape(len(points), -1)
        if spec.ndim == 2:  # one N-D box
            return np.all((spec[:, 0] <= pts) & (pts < spec[:, 1]), axis=1)
        if spec.ndim == 3:  # union of N-D boxes
            return np.logical_or.reduce(
                [np.all((box[:, 0] <= pts) & (pts < box[:, 1]), axis=1) for box in spec]
            )

    # Fallback: generic membership row by row
    return np.fromiter((p in interval for p in points), dtype=bool, count=len(points))


def _labels(states, stateA, stateB):
    """Per-frame labels: 0 if in A, 1 if in B, -1 otherwise."""
    in_A = np.isin(states, stateA)
    in_B = np.isin(states, stateB)
    return np.where(in_A, 0, np.where(in_B, 1, -1))


def _forward_fill(lab):
    """Forward-fill labels along axis 0; -1 where nothing labeled yet.

    The single home of the color-inheritance convention shared by the msm
    package (colored counting in nmm.py, path extraction in ensembles.py,
    event tracing here).
    """
    lab = np.asarray(lab)
    n = len(lab)
    last = np.maximum.accumulate(np.where(lab >= 0, np.arange(n), -1))
    return np.where(last >= 0, lab[np.maximum(last, 0)], -1)


def _trace_events(observed_states):
    """Given per-frame labels (0=A, 1=B, -1=unknown), find color-flip events.

    Returns ``(event_indices, event_colors, first_colored_index, color)`` where
    ``color`` is the forward-filled label array. Events are frames where the
    inherited color flips A<->B.
    """
    state = np.asarray(observed_states)
    n = len(state)
    labeled = state >= 0
    if not labeled.any():
        return (
            np.empty(0, dtype=int),
            np.empty(0, dtype=int),
            -1,
            np.full(n, -1, dtype=int),
        )

    # Forward-fill: color[i] = state at the most recent labeled frame <= i
    color = _forward_fill(state)

    flips = (color[1:] != color[:-1]) & (color[:-1] >= 0) & (color[1:] >= 0)
    events = np.flatnonzero(flips) + 1
    first_colored = int(np.argmax(labeled))
    return events, color[events], first_colored, color


class DirectFPT:
    """Empirical FPTs by direct trajectory tracing (no model involved).

    Reference semantics: ``msm_we/fpt.py:15-216``.
    """

    @classmethod
    def mean_fpts(
        cls,
        trajectories,
        stateA=None,
        stateB=None,
        discrete=True,
        n_variables=None,
        lag_time=1,
    ):
        """Mean first-passage times in both directions, with standard errors.

        Values are already multiplied by ``lag_time``. Directions with no
        events report the string ``"NaN"`` (reference convention,
        ``fpt.py:75-89``).
        """
        passage_timesAB, passage_timesBA, _tb = cls.fpts(
            trajectories, stateA, stateB, discrete, n_variables, lag_time
        )
        n_AB = len(passage_timesAB)
        n_BA = len(passage_timesBA)

        if np.sum(passage_timesAB):
            mfptAB = float(np.sum(passage_timesAB)) / n_AB
            std_err_mfptAB = np.std(passage_timesAB) / np.sqrt(n_AB)
        else:
            print("WARNING: No A->B events observed")
            mfptAB = "NaN"
            std_err_mfptAB = "NaN"

        if np.sum(passage_timesBA):
            mfptBA = float(np.sum(passage_timesBA)) / n_BA
            std_err_mfptBA = np.std(passage_timesBA) / np.sqrt(n_BA)
        else:
            print("WARNING: No B->A events observed")
            mfptBA = "NaN"
            std_err_mfptBA = "NaN"

        print("Number of A->B/B->A  events: {}/{}".format(n_AB, n_BA))
        return {
            "mfptAB": mfptAB,
            "std_err_mfptAB": std_err_mfptAB,
            "mfptBA": mfptBA,
            "std_err_mfptBA": std_err_mfptBA,
        }

    @classmethod
    def fpts(
        cls,
        trajectories,
        stateA=None,
        stateB=None,
        discrete=True,
        n_variables=None,
        lag_time=1,
    ):
        """First passage times A->B and B->A for each trajectory.

        The passage time recorded at a color-flip event is the number of
        observed frames since the previous event (or since the first colored
        frame), times ``lag_time``. ``tb_values`` are the reference's event
        duration counters (``fpt.py:179-209``): ``2 * (frames outside both
        states since the last in-state frame) + 1``.
        """
        if stateA is None or stateB is None:
            raise ValueError(
                "The final and initial states have to be defined to compute the MFPT"
            )

        if not discrete:
            if n_variables is None:
                raise ValueError(
                    "In continuous trajectories the number of variables is needed"
                )
            stateA = Interval(stateA, n_variables)
            stateB = Interval(stateB, n_variables)

        passage_timesAB = []
        passage_timesBA = []
        tb_values = []

        for traj in trajectories:
            observed = np.asarray(traj)[::lag_time]
            in_A = _membership(observed, stateA, discrete)
            in_B = _membership(observed, stateB, discrete)
            state = np.where(in_A, 0, np.where(in_B, 1, -1))

            events, event_colors, first_colored, _color = _trace_events(state)
            if len(events) == 0:
                continue

            prev_marks = np.concatenate([[first_colored], events[:-1]])
            fpt_counts = events - prev_marks

            passage_timesAB.extend(fpt_counts[event_colors == 1])
            passage_timesBA.extend(fpt_counts[event_colors == 0])

            # Event durations: frames since the most recent *in-state* frame
            labeled_idx = np.maximum.accumulate(
                np.where(state >= 0, np.arange(len(state)), -1)
            )
            prev_labeled = labeled_idx[events - 1]
            tb_values.extend((2 * (events - prev_labeled - 1) + 1).tolist())

        passage_timesAB = np.array(passage_timesAB) * lag_time
        passage_timesBA = np.array(passage_timesBA) * lag_time
        return passage_timesAB, passage_timesBA, tb_values


class MatrixFPT:
    """FPT calculations from a transition matrix (dense float64 linear algebra).

    Reference semantics: ``msm_we/fpt.py:219-802``.
    """

    @classmethod
    def mean_fpts(cls, tmatrix, stateA, stateB, lag_time=1):
        """Overridden by the Markov / non-Markov subclasses."""
        raise NotImplementedError

    @classmethod
    def directional_mfpt(
        cls, transition_matrix, stateA, stateB, ini_probs=None, lag_time=1
    ):
        """MFPT A->B with B made absorbing, via ``m = (I - T_sub)^-1 1``.

        Reference: ``fpt.py:231-294``.
        """
        lenA = len(stateA)
        if ini_probs is None:
            ini_probs = [1.0 / lenA] * lenA
        assert lenA == len(ini_probs)

        t_matrix = np.array(transition_matrix, dtype=float)
        ini_state = list(stateA)
        f_state = sorted(stateB)

        keep = np.setdiff1d(np.arange(len(t_matrix)), f_state)
        sub = t_matrix[np.ix_(keep, keep)]
        # Remap initial-state indices into the reduced matrix
        remap = {orig: new for new, orig in enumerate(keep)}
        ini_reduced = [remap[s] for s in ini_state]

        m = np.linalg.solve(np.identity(len(sub)) - sub, np.ones(len(sub)))
        mfptAB = sum(p * m[k] for p, k in zip(ini_probs, ini_reduced)) / sum(ini_probs)
        return mfptAB * lag_time

    @classmethod
    def mfpts_to_target_microstate(cls, transition_matrix, target, lag_time=1):
        """MFPT from every microstate to a single target microstate.

        Returns an array where element i is mfpt(i -> target); the target entry
        itself is 0 (reference ``fpt.py:296-336``).
        """
        t_matrix = np.array(transition_matrix, dtype=float)
        keep = np.setdiff1d(np.arange(len(t_matrix)), [target])
        sub = t_matrix[np.ix_(keep, keep)]
        m = np.linalg.solve(np.identity(len(sub)) - sub, np.ones(len(sub)))
        return np.insert(m, target, 0.0) * lag_time

    @classmethod
    def mfpts_matrix(cls, transition_matrix, lag_time=1):
        """Matrix of MFPTs, element (i, j) = mfpt(i -> j). Reference ``fpt.py:338-364``."""
        size = len(transition_matrix)
        cols = [
            cls.mfpts_to_target_microstate(transition_matrix, i, lag_time)
            for i in range(size)
        ]
        return np.array(cols).T

    @staticmethod
    def _extreme_commute_time(matrix_of_mfpts, find_max):
        matrix_of_mfpts = np.asarray(matrix_of_mfpts)
        n_states = len(matrix_of_mfpts)
        assert n_states == matrix_of_mfpts.shape[1] and n_states >= 2

        commute_times = matrix_of_mfpts + matrix_of_mfpts.T
        # Only consider strictly-upper-triangle pairs (i < j), first hit in
        # row-major order -- matches the reference's scan order (fpt.py:397-403)
        masked = commute_times.astype(float).copy()
        tri_mask = ~np.triu(np.ones((n_states, n_states), dtype=bool), k=1)
        if find_max:
            masked[tri_mask] = -np.inf
            flat = np.argmax(masked)
        else:
            masked[tri_mask] = np.inf
            flat = np.argmin(masked)
        i, j = np.unravel_index(flat, masked.shape)
        return commute_times[i, j], int(i), int(j)

    @classmethod
    def min_commute_time(cls, matrix_of_mfpts):
        """Minimum round-trip time over all microstate pairs. Reference ``fpt.py:366-404``."""
        return cls._extreme_commute_time(matrix_of_mfpts, find_max=False)

    @classmethod
    def max_commute_time(cls, matrix_of_mfpts):
        """Maximum round-trip time over all microstate pairs. Reference ``fpt.py:406-444``."""
        return cls._extreme_commute_time(matrix_of_mfpts, find_max=True)

    @classmethod
    def fpt_distribution(
        cls,
        t_matrix,
        initial_state,
        final_state,
        initial_distrib,
        min_power=1,
        max_power=12,
        max_n_lags=100,
        lag_time=1,
        dt=1.0,
        clean_recycling=False,
        logscale=False,
        engine="host",
        device=None,
    ):
        """Distribution of first-passage times from a transition matrix.

        Uses the F-matrix recursion (Suarez et al., Protein Science 26, 67-78
        (2016), Eq. 3; reference ``fpt.py:776-802``):
        ``F(t) = T^(t - t_prev) @ (F(t_prev) - diag(F(t_prev)))``, read out at
        ``[initial, final]``. The recursion is independent of the initial
        state, so it is computed once and read out for every initial state
        (the reference recomputes it per initial state).

        ``engine="device"`` runs the recursion in f64 torch on ``device``
        (:func:`_device_fpt_pdfs`); it equals the host engine to f64
        rounding.

        Returns an array of ``[time, density]`` rows, density normalized to 1.
        """
        tmatrix = np.array(t_matrix, dtype=float)
        ini_state = list(initial_state)
        f_state = sorted(final_state)
        assert len(ini_state) == len(initial_distrib)

        # Merge all target columns into the first target state, then remove the
        # other target states (adjusting initial-state indices).
        tmatrix[:, f_state[0]] = tmatrix[:, f_state].sum(axis=1)
        for i in range(len(f_state) - 1, 0, -1):
            tmatrix = np.delete(np.delete(tmatrix, f_state[i], axis=1), f_state[i], axis=0)
            ini_state = [s - 1 if f_state[i] < s else s for s in ini_state]

        target = f_state[0]
        if clean_recycling:
            # Strip recycling so the result is a distribution, not a CDF.
            # The whole target row is zeroed -- including the diagonal, i.e.
            # the target is NOT made absorbing here (contrast
            # adaptive_fpt_distribution, which sets the diagonal to 1).
            tmatrix[target, :] = 0.0

        if logscale:
            lag_list = np.logspace(min_power, max_power, max_n_lags, dtype=int)
        else:
            lag_list = np.arange(0, max_n_lags, dtype=int)

        # F-matrix recursion, once for all initial states
        if engine == "device":
            list_of_pdfs = _device_fpt_pdfs(
                tmatrix, lag_list, ini_state, target, device
            )
        elif engine == "host":
            list_of_pdfs = np.empty(
                (len(ini_state), len(lag_list)), dtype=np.float64
            )
            prevF = tmatrix.copy()
            for time_index, time in enumerate(lag_list):
                step = time if time_index == 0 else time - lag_list[time_index - 1]
                t_step = np.linalg.matrix_power(tmatrix, step)
                F = t_step @ (prevF - np.diag(np.diag(prevF)))
                list_of_pdfs[:, time_index] = F[ini_state, target]
                prevF = F
        else:
            raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")

        initial_distrib = np.asarray(initial_distrib, dtype=float)
        density = (initial_distrib[:, None] * list_of_pdfs).sum(axis=0) / initial_distrib.sum()

        dt2 = lag_time * dt
        if logscale:
            # Variable time steps: fold the step width into the density
            rows = [[0.0, 0.0], [lag_list[0] * dt2, density[0] * lag_list[0] / dt2]]
            for i in range(1, len(lag_list)):
                rows.append(
                    [lag_list[i] * dt2, density[i] * (lag_list[i] - lag_list[i - 1]) / dt2]
                )
            density_vs_t = np.array(rows)
        else:
            density_vs_t = np.array(
                [[0.0, 0.0]]
                + [[(i + 1) * dt2, dens / dt2] for i, dens in zip(lag_list, density)]
            )
        density_vs_t[:, 1] /= density_vs_t[:, 1].sum()
        return density_vs_t

    @classmethod
    def calc_fmatrix(
        cls,
        Fmatrix,
        tmatrix,
        prevFmatrix,
        list_of_pdfs,
        lag_list,
        ini_state,
        istateIndex,
        f_state,
    ):
        """One initial state's F-matrix recursion (Suarez et al. 2016, Eq. 3).

        API-parity shim over the same recursion :meth:`fpt_distribution` runs
        once for all initial states (reference ``fpt.py:776-802`` recomputes it
        per state through this entry point). Fills
        ``list_of_pdfs[istateIndex, :]`` in place, one first-passage
        probability per lag in ``lag_list``, and returns the final F matrix.
        ``Fmatrix`` is accepted for signature parity; only ``prevFmatrix``
        seeds the recursion.
        """
        del Fmatrix
        tmatrix = np.asarray(tmatrix, dtype=float)
        prevF = np.asarray(prevFmatrix, dtype=float)
        previous_lag = 0
        for time_index, lag in enumerate(lag_list):
            t_step = np.linalg.matrix_power(tmatrix, lag - previous_lag)
            prevF = t_step @ (prevF - np.diag(np.diag(prevF)))
            list_of_pdfs[istateIndex, time_index] = prevF[
                ini_state[istateIndex], f_state
            ]
            previous_lag = lag
        return prevF

    @staticmethod
    def adaptive_fpt_distribution(
        Tmatrix,
        initial_states,
        initial_state_probs,
        target_states,
        tau=1,
        increment=5,
        fine_increment=1.2,
        relevant_thresh=1e-4,
        max_steps=int(1e6),
        max_time=np.inf,
        explicit_renormalization=False,
        verbose=False,
        engine="host",
        device=None,
    ):
        """Adaptive FPT distribution: coarse multiplicative time sweep, refined
        once probability starts arriving at the target.

        Reference semantics: ``msm_we/fpt.py:589-774``. Returns
        ``(fpt_distribution, all_probabilities, last_step_index, times)``.

        ``engine="device"`` (requires ``explicit_renormalization=False``)
        replaces the per-step ``matrix_power`` (O(log step) n^3 GEMMs per
        step on the host) with :class:`_DeviceVectorPowers` in f64 on
        ``device``: one lazily extended basis ``S[j] = T^(2^j)`` and one
        vector fold per probe. In f64 the data-dependent schedule is the
        host engine's.
        """
        Tmatrix = np.asarray(Tmatrix, dtype=float)
        n_states = len(Tmatrix)
        if engine not in ("host", "device"):
            raise ValueError(f"engine must be 'host' or 'device', got {engine!r}")
        if engine == "device" and explicit_renormalization:
            raise ValueError(
                "engine='device' folds the initial vector through matrix "
                "powers and cannot renormalize the matrix power itself; "
                "use the host engine for explicit_renormalization"
            )

        all_probabilities = np.full((max_steps + 1, n_states), np.nan)
        initial_probability = np.zeros(n_states)
        initial_probability[np.asarray(initial_states)] = initial_state_probs
        initial_probability /= initial_probability.sum()
        all_probabilities[0] = initial_probability

        # Make the targets absorbing
        non_recycling = Tmatrix.copy()
        non_recycling[np.asarray(target_states), :] = 0.0
        for t in target_states:
            non_recycling[t, t] = 1.0

        probs = np.zeros(max_steps)
        last_step = 1
        get_next_step = lambda x: x * increment  # noqa: E731
        in_relevant_region = False
        steps = [1]
        i = 0

        if engine == "device":
            prob_at = _DeviceVectorPowers(non_recycling, initial_probability, device)
        else:
            def prob_at(step):
                matrix_next = np.linalg.matrix_power(non_recycling, step)
                if explicit_renormalization:
                    matrix_next = matrix_next / matrix_next.sum(axis=1)
                p = initial_probability @ matrix_next
                if explicit_renormalization:
                    p /= p.sum()
                return p

        for i in range(max_steps - 1):
            this_step = int(get_next_step(last_step))
            if this_step <= last_step:
                this_step = int(last_step + 1)

            probability = prob_at(this_step)

            arrived = probability[np.asarray(target_states)].sum()

            if (
                i > 0
                and not in_relevant_region
                and (arrived - probs[: i + 1].sum()) > relevant_thresh
            ):
                if verbose:
                    print(
                        f"*** Entered relevant region at step {this_step}; "
                        f"switching to fine increments."
                    )
                in_relevant_region = True
                this_step /= increment
                steps.append(this_step)
                all_probabilities[i + 1] = all_probabilities[i]
                probs[i + 1] = probs[i]
                get_next_step = lambda x: x * fine_increment  # noqa: E731
                continue

            steps.append(this_step)
            all_probabilities[i + 1] = probability
            if i == 0:
                probs[i + 1] = arrived
            else:
                probs[i + 1] = arrived - probs[: i + 1].sum()

            if np.isclose(probs.sum(), 1):
                print(f"*** All probability reached the target at time {this_step}")
                break
            if this_step > max_time:
                print("*** Max steps reached, before all probability flowed into target.")
                break
            last_step = this_step

        times = np.array(steps, dtype=float) * float(tau)
        return probs[: i + 2], all_probabilities[: i + 2], i, times


class MarkovFPT(MatrixFPT):
    """FPTs from a Markovian transition matrix via the colored expansion."""

    @classmethod
    def mean_fpts(cls, markov_tmatrix, stateA, stateB, lag_time=1):
        """Both-direction MFPTs from a Markov matrix. Reference ``fpt.py:805-837``."""
        auxiliar_matrix = utils.pseudo_nm_tmatrix(markov_tmatrix, stateA, stateB)
        return NonMarkovFPT.mean_fpts(auxiliar_matrix, stateA, stateB, lag_time)

    @classmethod
    def markov_commute_time(cls, transition_matrix, stateA, stateB, lag_time=1):
        """Round-trip commute time A<->B. Reference ``fpt.py:839-860``."""
        mfpts = cls.mean_fpts(transition_matrix, stateA, stateB, lag_time)
        return mfpts["mfptAB"] + mfpts["mfptBA"]


class NonMarkovFPT(MatrixFPT):
    """FPTs from a colored (2n x 2n) non-Markovian transition matrix."""

    @classmethod
    def mean_fpts(cls, nm_transition_matrix, stateA, stateB, lag_time=1):
        """Labeled-population flux-ratio MFPTs. Reference ``fpt.py:863-929``.

        ``mfptAB = pop(A-labeled) / flux(A-labeled -> B)`` and symmetrically for
        B->A, with the flux sums vectorized over the labeled index grid.
        """
        utils.check_tmatrix(nm_transition_matrix)
        T = np.asarray(nm_transition_matrix, dtype=float)
        labeled_pops = utils.pops_from_tmatrix(T)
        n_states = len(labeled_pops) // 2

        stateA_arr = np.asarray(list(stateA))
        stateB_arr = np.asarray(list(stateB))
        # Columns belonging to each macrostate (both labels)
        colsB = np.isin(np.arange(2 * n_states) // 2, stateB_arr)
        colsA = np.isin(np.arange(2 * n_states) // 2, stateA_arr)

        pops_A_labeled = labeled_pops[0::2]
        pops_B_labeled = labeled_pops[1::2]

        fluxAB = float(pops_A_labeled @ T[0::2][:, colsB].sum(axis=1))
        fluxBA = float(pops_B_labeled @ T[1::2][:, colsA].sum(axis=1))

        pop_colorA = pops_A_labeled.sum()
        pop_colorB = pops_B_labeled.sum()

        mfptAB = float("inf") if fluxAB == 0 else pop_colorA / fluxAB
        mfptBA = float("inf") if fluxBA == 0 else pop_colorB / fluxBA
        return dict(mfptAB=mfptAB * lag_time, mfptBA=mfptBA * lag_time)
