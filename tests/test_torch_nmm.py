"""The port's trajectory models (``msm_we_tpu_torch.msm.nmm``:
``NonMarkovModel``, ``MarkovPlusColorModel``) against the JAX package's on
the same seeded numpy trajectories.

The counting is the same numpy in both (bitwise); the FPT engines run
through each package's own ``msm/fpt.py`` on the host, held to 1e-12.
"""
import numpy as np
import pytest

import msm_we_tpu
import msm_we_tpu_torch
from msm_we_tpu.msm import nmm as jax_nmm
from msm_we_tpu_torch.msm import nmm

RTOL = 1e-12


def _trajs(kind):
    rng = np.random.default_rng(192348)
    if kind == "uniform3":
        return [rng.integers(0, 3, 20000)], [0], [2]
    if kind == "walk6":
        # A lazy random walk on 0..5: long excursions between the end states
        steps = rng.choice([-1, 0, 1], size=(3, 6000))
        out = []
        for s in steps:
            x, t = 2, []
            for d in s:
                x = min(5, max(0, x + int(d)))
                t.append(x)
            out.append(np.array(t))
        return out, [0], [5]
    assert kind == "labels"
    names = np.array(["u", "f1", "f2", "m"])
    return [names[rng.integers(0, 4, 8000)], names[rng.integers(0, 4, 300)]], \
        ["u"], ["f1", "f2"]


def _pair(cls, kind, **kw):
    trajs, A, B = _trajs(kind)
    return (getattr(nmm, cls)([t.copy() for t in trajs], list(A), list(B), **kw),
            getattr(jax_nmm, cls)([t.copy() for t in trajs], list(A), list(B), **kw))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=RTOL, atol=1e-300)


def test_six_classes_are_exported_at_top_level():
    for name in ("Ensemble", "PathEnsemble", "DiscreteEnsemble",
                 "DiscretePathEnsemble", "NonMarkovModel", "MarkovPlusColorModel",
                 "DirectFPT", "MatrixFPT", "MarkovFPT", "NonMarkovFPT"):
        assert hasattr(msm_we_tpu, name)
        assert getattr(msm_we_tpu_torch, name) is getattr(msm_we_tpu_torch.msm, name)
    assert msm_we_tpu_torch.NonMarkovModel is nmm.NonMarkovModel


@pytest.mark.parametrize("kw", [
    dict(lag_time=1), dict(lag_time=5), dict(lag_time=4, sliding_window=False),
    dict(lag_time=2, markovian=True), dict(lag_time=1, reversible=False),
], ids=["lag1", "lag5", "lag4_no_window", "markovian", "irreversible"])
@pytest.mark.parametrize("kind", ["uniform3", "walk6", "labels"])
def test_non_markov_model_matches_jax(kind, kw):
    m, j = _pair("NonMarkovModel", kind, coarse_macrostates=(kind == "labels"), **kw)
    assert m.n_states == j.n_states and m.stateA == j.stateA and m.stateB == j.stateB
    np.testing.assert_array_equal(m.nm_cmatrix, j.nm_cmatrix)
    np.testing.assert_array_equal(m.markov_cmatrix, j.markov_cmatrix)
    np.testing.assert_array_equal(m.nm_tmatrix, j.nm_tmatrix)
    np.testing.assert_array_equal(m.markov_tmatrix, j.markov_tmatrix)
    assert m.nm_cmatrix.sum() > 0
    for t in zip(m.trajectories, j.trajectories):
        np.testing.assert_array_equal(*t)
    _close(m.mfpts(), j.mfpts())
    _close(m.empirical_mfpts(), j.empirical_mfpts())
    _close(m.populations(), j.populations())
    assert np.isclose(m.populations().sum(), 1.0)
    assert m.popA == pytest.approx(j.popA, rel=RTOL)
    assert m.popB == pytest.approx(j.popB, rel=RTOL)
    np.testing.assert_array_equal(m.tmatrixAB(), j.tmatrixAB())
    np.testing.assert_array_equal(m.tmatrixBA(), j.tmatrixBA())
    _close(m.fluxAB_distribution_on_B(), j.fluxAB_distribution_on_B())
    _close(m.fluxBA_distribution_on_A(), j.fluxBA_distribution_on_A())


@pytest.mark.parametrize("kind,lag", [("uniform3", 1), ("walk6", 2)])
def test_distributions_and_correlations_match_jax(kind, lag):
    m, j = _pair("NonMarkovModel", kind, lag_time=lag)
    for name in ("fpt_distrib_AB", "fpt_distrib_BA"):
        got, want = getattr(m, name)(max_x=60), getattr(j, name)(max_x=60)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-300)
        assert got.shape == want.shape and got[:, 1].sum() > 0.2
    times = [lag, 4 * lag, 10 * lag]
    for a, b in zip(m.corr_function(times), j.corr_function(times)):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    if lag > 1:
        with pytest.raises(ValueError, match="multiple of the lag time"):
            m.corr_function([lag + 1])
    for a, b in zip(m.empirical_fpts(), j.empirical_fpts()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    m.lag_time = 3  # the setter refits
    j.lag_time = 3
    np.testing.assert_array_equal(m.nm_cmatrix, j.nm_cmatrix)


def test_fundamental_sequences_match_jax():
    m, j = _pair("NonMarkovModel", "walk6", lag_time=1)
    got, want = m.empirical_weighted_FS(), j.empirical_weighted_FS()
    assert got[0] == want[0] and got[2] == want[2] > 0
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=0)
    for model in (m, j):
        np.random.seed(77)
        model._fs = model.weighted_FS(n_paths=60)
    assert m._fs[0] == j._fs[0] and m._fs[2] == j._fs[2] == 60
    np.testing.assert_allclose(m._fs[1], j._fs[1], rtol=RTOL, atol=0)


def test_from_nm_tmatrix_consumes_the_same_random_numbers():
    base, _ = _pair("NonMarkovModel", "uniform3", lag_time=1)
    out = []
    for mod in (nmm, jax_nmm):
        np.random.seed(31)
        out.append(mod.NonMarkovModel.from_nm_tmatrix(
            base.nm_tmatrix, [0], [2], sim_length=3000, initial_state=0))
    np.testing.assert_array_equal(out[0].trajectories[0], out[1].trajectories[0])
    np.testing.assert_array_equal(out[0].nm_cmatrix, out[1].nm_cmatrix)
    with pytest.raises(ValueError, match="simulation length"):
        nmm.NonMarkovModel.from_nm_tmatrix(base.nm_tmatrix, [0], [2])


@pytest.mark.parametrize("kw", [
    dict(lag_time=1, hist_length=0), dict(lag_time=1, hist_length=3),
    dict(lag_time=2, hist_length=10), dict(lag_time=3, hist_length=2,
                                           sliding_window=False),
], ids=["h0", "h3", "lag2_h10", "lag3_h2_no_window"])
@pytest.mark.parametrize("kind", ["uniform3", "walk6"])
def test_markov_plus_color_model_matches_jax(kind, kw):
    m, j = _pair("MarkovPlusColorModel", kind, **kw)
    np.testing.assert_array_equal(m.nm_cmatrix, j.nm_cmatrix)
    np.testing.assert_array_equal(m.nm_tmatrix, j.nm_tmatrix)
    np.testing.assert_array_equal(m.markov_tmatrix, j.markov_tmatrix)
    assert m.hist_length == j.hist_length == kw["hist_length"]
    _close(m.mfpts(), j.mfpts())
    _close(m.empirical_mfpts(), j.empirical_mfpts())
    for model in (m, j):
        with pytest.raises(NotImplementedError, match="regular Markov model"):
            model.populations()


@pytest.mark.parametrize("bad", [0, 2.5])
def test_bad_lag_times_are_rejected(bad):
    for mod in (nmm, jax_nmm):
        with pytest.raises(ValueError, match="lag time"):
            mod.NonMarkovModel([np.array([0, 1, 2, 0])], [0], [2], lag_time=bad)
