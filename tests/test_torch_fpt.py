"""The port's first-passage-time library (``msm_we_tpu_torch.msm.fpt``)
against the JAX package's ``msm_we_tpu.msm.fpt`` on the same inputs.

The host engines are float64 numpy in both packages (held to 1e-12). The
port's device engines are float64 torch; on CPU tensors they are held to
JAX's host engines to 1e-10 of the distribution's peak, and to JAX's f32
device engine at the tolerance the JAX suite holds that engine to its own
host engine (``tests/test_fpt.py``: rtol 5e-4, atol 1e-7; the f32 engine
itself is 2.3e-5 of the peak off the host engine on the logscale case).
"""
import numpy as np
import pytest
import torch

from msm_we_tpu.msm import fpt as jfpt
from msm_we_tpu_torch.msm import fpt as tfpt
from msm_we_tpu_torch import utils as tutils
from msm_we_tpu import utils as jutils

torch.set_num_threads(1)

N = 40
INI, FIN, W = [0, 1, 2], [N - 2, N - 1], [0.5, 0.3, 0.2]


def random_metastable(n, seed=0):
    """The test matrix of ``scripts/fpt_perf.py``: strong diagonal, weak
    uniform coupling."""
    rng = np.random.default_rng(seed)
    T = rng.random((n, n)) * 0.02 + np.diag(rng.random(n) * 20 + 1)
    return T / T.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def T():
    return random_metastable(N, seed=1)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def _trajs(seed, n_traj=3, length=400, n_states=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, n_states, length) for _ in range(n_traj)]


@pytest.mark.parametrize("lag_time", [1, 3])
def test_direct_fpt_discrete_matches_jax(lag_time, capsys):
    trajs = _trajs(4)
    a = tfpt.DirectFPT.fpts(trajs, [0], [4], lag_time=lag_time)
    b = jfpt.DirectFPT.fpts(trajs, [0], [4], lag_time=lag_time)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (tfpt.DirectFPT.mean_fpts(trajs, [0], [4], lag_time=lag_time)
            == jfpt.DirectFPT.mean_fpts(trajs, [0], [4], lag_time=lag_time))


def test_direct_fpt_continuous_matches_jax(capsys):
    rng = np.random.default_rng(8)
    trajs = [np.cumsum(rng.normal(size=(500, 1)), axis=0) for _ in range(2)]
    kw = dict(stateA=[-2.0, -1.0], stateB=[1.0, 2.0], discrete=False, n_variables=1)
    a = tfpt.DirectFPT.fpts(trajs, **kw)
    b = jfpt.DirectFPT.fpts(trajs, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_matrix_fpt_mfpts_match_jax(T):
    got = tfpt.MatrixFPT.directional_mfpt(T, INI, FIN, ini_probs=W, lag_time=2)
    want = jfpt.MatrixFPT.directional_mfpt(T, INI, FIN, ini_probs=W, lag_time=2)
    assert got == pytest.approx(want, rel=1e-12)
    np.testing.assert_allclose(
        tfpt.MatrixFPT.mfpts_to_target_microstate(T, 5, lag_time=2),
        jfpt.MatrixFPT.mfpts_to_target_microstate(T, 5, lag_time=2), rtol=1e-12)
    small = T[:8, :8] / T[:8, :8].sum(axis=1, keepdims=True)
    mm_t = tfpt.MatrixFPT.mfpts_matrix(small)
    mm_j = jfpt.MatrixFPT.mfpts_matrix(small)
    np.testing.assert_allclose(mm_t, mm_j, rtol=1e-12)
    for fn in ("min_commute_time", "max_commute_time"):
        a, b = getattr(tfpt.MatrixFPT, fn)(mm_t), getattr(jfpt.MatrixFPT, fn)(mm_j)
        assert a[1:] == b[1:] and a[0] == pytest.approx(b[0], rel=1e-12)


def test_markov_and_nonmarkov_fpt_match_jax(T):
    small = T[:10, :10] / T[:10, :10].sum(axis=1, keepdims=True)
    a = tfpt.MarkovFPT.mean_fpts(small, [0, 1], [8, 9], lag_time=2)
    b = jfpt.MarkovFPT.mean_fpts(small, [0, 1], [8, 9], lag_time=2)
    for k in ("mfptAB", "mfptBA"):
        assert a[k] == pytest.approx(b[k], rel=1e-12)
    assert tfpt.MarkovFPT.markov_commute_time(small, [0], [9]) == pytest.approx(
        jfpt.MarkovFPT.markov_commute_time(small, [0], [9]), rel=1e-12)
    nm = tutils.pseudo_nm_tmatrix(small, [0, 1], [8, 9])
    np.testing.assert_array_equal(nm, jutils.pseudo_nm_tmatrix(small, [0, 1], [8, 9]))
    np.testing.assert_allclose(tutils.pops_from_tmatrix(nm),
                               jutils.pops_from_tmatrix(nm), rtol=1e-12)
    a = tfpt.NonMarkovFPT.mean_fpts(nm, [0, 1], [8, 9])
    b = jfpt.NonMarkovFPT.mean_fpts(nm, [0, 1], [8, 9])
    for k in ("mfptAB", "mfptBA"):
        assert a[k] == pytest.approx(b[k], rel=1e-12)


FPT_KW = [
    dict(max_n_lags=30),
    dict(max_n_lags=30, logscale=True, min_power=1, max_power=4),
    dict(max_n_lags=20, clean_recycling=True, lag_time=2, dt=0.5),
]


@pytest.mark.parametrize("kw", FPT_KW, ids=["linear", "logscale", "clean"])
def test_fpt_distribution_host_matches_jax(T, kw):
    got = tfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, **kw)
    want = jfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("kw", FPT_KW, ids=["linear", "logscale", "clean"])
def test_fpt_distribution_device_engine_matches_jax(T, kw):
    """The port's f64 device engine (CPU tensors) against JAX's host f64
    engine and JAX's f32 device engine."""
    got = tfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, engine="device",
                                          device="cpu", **kw)
    host = jfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, **kw)
    dev32 = jfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, engine="device", **kw)
    np.testing.assert_array_equal(got[:, 0], host[:, 0])
    assert _rel(got[:, 1], host[:, 1]) <= 1e-10
    np.testing.assert_allclose(got, dev32, rtol=5e-4, atol=1e-7)


def test_calc_fmatrix_matches_jax(T):
    lags = [1, 2, 4, 7]
    a = np.zeros((len(INI), len(lags)))
    b = np.zeros((len(INI), len(lags)))
    Fa = tfpt.MatrixFPT.calc_fmatrix(None, T, T, a, lags, INI, 1, N - 1)
    Fb = jfpt.MatrixFPT.calc_fmatrix(None, T, T, b, lags, INI, 1, N - 1)
    np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(Fa, Fb, rtol=1e-12)


@pytest.mark.parametrize("renorm", [False, True])
def test_adaptive_fpt_host_matches_jax(T, renorm, capsys):
    kw = dict(max_steps=200, max_time=1e6, explicit_renormalization=renorm)
    a = tfpt.MatrixFPT.adaptive_fpt_distribution(T, INI, W, FIN, **kw)
    b = jfpt.MatrixFPT.adaptive_fpt_distribution(T, INI, W, FIN, **kw)
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-12, atol=1e-300)


def test_adaptive_fpt_device_engine_keeps_the_host_schedule(T, capsys):
    """In f64 the device engine's data-dependent schedule is the host
    engine's, and its probabilities agree to 1e-8."""
    kw = dict(max_steps=200, max_time=1e6)
    got = tfpt.MatrixFPT.adaptive_fpt_distribution(T, INI, W, FIN, engine="device",
                                                   device="cpu", **kw)
    host = jfpt.MatrixFPT.adaptive_fpt_distribution(T, INI, W, FIN, **kw)
    assert got[2] == host[2]
    np.testing.assert_array_equal(got[3], host[3])
    np.testing.assert_allclose(got[0], host[0], rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got[1], host[1], rtol=1e-8, atol=1e-14)


def test_device_engines_need_a_device_and_no_renormalization(T):
    with pytest.raises(ValueError, match="explicit device"):
        tfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, engine="device")
    with pytest.raises(ValueError, match="explicit_renormalization"):
        tfpt.MatrixFPT.adaptive_fpt_distribution(
            T, INI, W, FIN, engine="device", device="cpu",
            explicit_renormalization=True)
    with pytest.raises(ValueError, match="engine"):
        tfpt.MatrixFPT.fpt_distribution(T, INI, FIN, W, engine="tpu")
