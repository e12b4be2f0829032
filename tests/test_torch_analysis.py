"""The port's default haMSM build and the analysis run on a built model,
against the JAX package on the same synthetic WE run.

The JAX build reads the west.h5 that ``msm_we_tpu.data.generate_west_h5``
writes; the port builds from an ``ArrayWEDataset`` of the same arrays
(12 iterations x 32 segments, seed 17, 12 rectilinear WE bins, basis
[9, 10], target [0, 1], PCA, 3 clusters per bin) with the defaults of
``build_analyze_model``: block cross-validation (2 groups, 4 blocks) and
the predict discretization route (``device_pipeline=False``), clustering
with host updates. Both packages then run the same host float64 analysis,
so results are held to 1e-10 (the lagged flux to 1e-12).
"""
import copy

import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu.ops import linalg as jlinalg
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.ops import linalg as tlinalg

torch.set_num_threads(1)

N_ITER, N_SEG, N_CLUSTERS, SEED = 12, 32, 3, 17
EDGES = np.linspace(0, 10, 13)
COMMON = dict(
    ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
    modelName="analysis",
    basis_pcoord_bounds=[[9.0, 10.0]],
    target_pcoord_bounds=[[0.0, 1.0]],
    dimreduce_method="pca",
    tau=1.0,
    n_clusters=N_CLUSTERS,
    show_live_display=False,
)
TOL = dict(rtol=1e-10, atol=1e-14)


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_analysis") / "west.h5"
    generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)


def _port_build(data, scan=False, **kw):
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        step_kwargs={"clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES]),
                                    "scan_small_batches": scan}},
        **{**COMMON, **kw},
    )
    return m


@pytest.fixture(scope="module")
def built(west_h5, arrays):
    """(jax, port) default builds; tests that change a model copy it."""
    j = JaxModelWE()
    j.build_analyze_model(
        file_paths=[west_h5],
        step_kwargs={"clustering": {"user_bin_mapper": JaxMapper([EDGES])}},
        **COMMON,
    )
    return j, _port_build(arrays)


def test_default_build_matches_jax(built):
    j, m = built
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    assert m.validation_iterations == j.validation_iterations
    assert len(m.validation_models) == len(j.validation_models) == 2
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8)
    for vm, vj in zip(m.validation_models, j.validation_models):
        assert vm.JtargetSS == pytest.approx(vj.JtargetSS, rel=1e-8)
        np.testing.assert_array_equal(np.concatenate(vm.dtrajs),
                                      np.concatenate(vj.dtrajs))
    names = [s[0] for s in m.stage_timings.stages]
    assert names == [s[0] for s in j.stage_timings.stages]
    assert names[-1] == "Cross-validation"
    assert m.post_cluster_model is not None and m.post_cluster_model.fluxMatrix is None


@pytest.mark.parametrize("scan", [False, True], ids=["host_updates", "scan"])
def test_predict_route_equals_pair_route(arrays, scan):
    predict = _port_build(arrays, scan, cross_validation_groups=0)
    pair = _port_build(arrays, scan, cross_validation_groups=0, device_pipeline=True)
    assert not predict.device_pipeline and pair.device_pipeline
    np.testing.assert_array_equal(np.concatenate(predict.dtrajs),
                                  np.concatenate(pair.dtrajs))
    assert predict.JtargetSS == pair.JtargetSS


@pytest.mark.parametrize("device_pipeline", [False, True], ids=["predict", "pair"])
def test_incremental_cleaning_equals_full_rediscretization(arrays, device_pipeline):
    """Cleaning re-scores only the rows it must, in the scoring family the
    discretization recorded; a full re-discretization of the cleaned bank
    gives the same dtrajs."""
    m = _port_build(arrays, cross_validation_groups=0, device_pipeline=device_pipeline)
    assert m._scored_on_host is (not device_pipeline)
    assert m.fluxMatrix.shape[0] < m.fluxMatrixRaw.shape[0]  # cleaning removed states
    full = copy.deepcopy(m)
    full.launch_discretization()
    np.testing.assert_array_equal(np.concatenate(full.dtrajs), np.concatenate(m.dtrajs))


def test_block_validation_failure_is_allowed_on_request(arrays):
    """Blocks too short to hold a recycling event fail validation: the build
    raises ``BlockValidationError`` unless ``allow_validation_failure``, and
    then keeps no validation model (the JAX package's empty default)."""
    with pytest.raises(modelWE.BlockValidationError):
        _port_build(arrays, cross_validation_groups=5, cross_validation_blocks=11)
    m = _port_build(arrays, cross_validation_groups=5, cross_validation_blocks=11,
                    allow_validation_failure=True)
    assert m.JtargetSS > 0 and m.validation_models == []


@pytest.mark.parametrize("n_lag", [1, 2, 3])
def test_lagged_flux_matches_jax(built, n_lag):
    j, m = (copy.deepcopy(x) for x in built)
    j.get_fluxMatrix(n_lag)
    m.get_fluxMatrix(n_lag)
    assert m.n_lag == j.n_lag == n_lag
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12, atol=0)
    assert m.fluxMatrixRaw.sum() > 0


def test_lagged_flux_needs_history(built):
    m = copy.deepcopy(built[1])
    with pytest.raises(ValueError, match="enough history"):
        m.get_fluxMatrix(N_ITER)


def test_iter_flux_and_transition_data_match_jax(built):
    j, m = (copy.deepcopy(x) for x in built)
    for it in (2, 7):
        np.testing.assert_allclose(m.get_iter_fluxMatrix(it), j.get_iter_fluxMatrix(it),
                                   rtol=1e-12, atol=0)
    basis = {"coords": np.full((4, 3), 9.5, np.float32)}
    j.set_basis(basis)
    m.set_basis(basis)
    for lag in (0, 2):
        for model in (j, m):
            model.load_iter_data(9)
            model.get_transition_data(lag)
        assert m.n_lag == j.n_lag == lag
        for attr in ("coordPairList", "transitionWeights", "departureWeights"):
            np.testing.assert_array_equal(getattr(m, attr), getattr(j, attr))


def test_implied_timescales_match_jax(built):
    j, m = built
    lt_j, ts_j = j.get_implied_timescales(lags=(0, 1, 2))
    lt_m, ts_m = m.get_implied_timescales(lags=(0, 1, 2))
    np.testing.assert_array_equal(lt_m, lt_j)
    assert ts_m.shape == (3, 3)
    np.testing.assert_allclose(ts_m, ts_j, **TOL)
    assert m.n_lag == 0  # the flux state is restored


@pytest.mark.parametrize("sets", [None, 2], ids=["slowest_mode", "pcca2"])
def test_ck_test_matches_jax(built, sets):
    j, m = built
    lt_j, sets_j, pred_j, est_j = j.get_ck_test(lags=(0, 1, 2, 3), sets=sets)
    lt_m, sets_m, pred_m, est_m = m.get_ck_test(lags=(0, 1, 2, 3), sets=sets)
    np.testing.assert_array_equal(lt_m, lt_j)
    assert len(sets_m) == len(sets_j)
    for a, b in zip(sets_m, sets_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pred_m, pred_j, **TOL)
    np.testing.assert_allclose(est_m, est_j, **TOL)


def test_pcca_sets_match_jax(built):
    fm = built[1].fluxMatrix
    for n in (2, 3):
        got, want = tlinalg.pcca_sets(fm, n), jlinalg.pcca_sets(fm, n)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_committors_match_jax(built):
    j, m = (copy.deepcopy(x) for x in built)
    for model in (j, m):
        model.get_committor()
    np.testing.assert_allclose(m.q, j.q, **TOL)
    for model in (j, m):
        model.get_backwards_committor(conv=1e-8)
    np.testing.assert_allclose(m.qm, j.qm, **TOL)
    np.testing.assert_allclose(m.q, j.q, **TOL)


def test_flux_profiles_match_jax(built):
    j, m = (copy.deepcopy(x) for x in built)
    for model in (j, m):
        model.get_flux()
        model.get_committor()
        model.get_flux_committor()
    np.testing.assert_allclose(m.J, j.J, **TOL)
    np.testing.assert_allclose(m.Jq, j.Jq, **TOL)
    for k in ("slope", "intercept", "r_value"):
        assert m.fit_parameters[k] == pytest.approx(j.fit_parameters[k], rel=1e-10)
    assert m.slope_overcorrected == j.slope_overcorrected


def test_steady_state_variants_and_evolve_target_flux_match_jax(built):
    j, m = (copy.deepcopy(x) for x in built)
    for model in (j, m):
        model.get_steady_state_matrixpowers(conv=1e-12)
    np.testing.assert_allclose(m.pSS, j.pSS, **TOL)
    np.testing.assert_allclose(m.get_steady_state_algebraic(set=False),
                               j.get_steady_state_algebraic(set=False), **TOL)
    p0 = np.full(m.nBins, 1.0 / m.nBins)
    for model in (j, m):
        model.probTransient = np.stack(
            [p0 @ np.linalg.matrix_power(model.Tmatrix, k) for k in range(4)]
        )
        model.nStore = 2
        model.evolve_target_flux()
    np.testing.assert_allclose(m.Jtarget, j.Jtarget, **TOL)
    np.testing.assert_array_equal(m.JtargetTimes, j.JtargetTimes)
    for model in (j, m):
        model.get_eqTmatrix()
    np.testing.assert_allclose(m.Tmatrix, j.Tmatrix, **TOL)


def test_bootstrap_matches_jax(built):
    j, m = built
    kw = dict(n_boot=25, seed=3, observables=("flux", "pss", "committor"))
    rj, rm = j.bootstrap_target_flux(**kw), m.bootstrap_target_flux(**kw)
    np.testing.assert_allclose(rm["fluxes"], rj["fluxes"], equal_nan=True, **TOL)
    np.testing.assert_allclose(rm["ci"], rj["ci"], **TOL)
    assert rm["n_failed"] == rj["n_failed"]
    for name in ("pss", "committor"):
        for suffix in ("", "_mean", "_ci"):
            np.testing.assert_allclose(rm[name + suffix], rj[name + suffix], **TOL)
    assert m.flux_bootstrap is rm


def test_steady_state_power_matches_jax():
    """At the JAX suite's tolerance (``test_coverage_round2.py``: atol 5e-5)."""
    import jax.numpy as jnp

    from msm_we_tpu.utils import random_markov_matrix

    T = random_markov_matrix(12, seed=42)
    exact = jlinalg.steady_state_algebraic(T)
    ref = np.asarray(jlinalg.steady_state_power_jax(
        jnp.asarray(T, jnp.float32), jnp.ones(12, jnp.float32) / 12, n_iters=600))
    got = tlinalg.steady_state_power(
        torch.tensor(T, dtype=torch.float32), torch.ones(12) / 12, n_iters=600
    ).numpy()
    np.testing.assert_allclose(got, exact, atol=5e-5)
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_committor_device_matches_jax():
    """At the JAX suite's tolerance (``test_review_regressions.py``: atol
    1e-4); and it returns the iterate a convergence check after every
    step stops at."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    F = rng.random((8, 8))
    q_host = jlinalg.committor(F, [7], [0], 8, conv=1e-12)
    M = F / F.sum(axis=1, keepdims=True)
    basis, target = np.arange(8) == 0, np.arange(8) == 7
    ref = np.asarray(jlinalg.committor_jax(
        jnp.asarray(M, jnp.float32), jnp.asarray(target), jnp.asarray(basis),
        conv=1e-10, max_iters=100000))
    got = tlinalg.committor_device(
        torch.tensor(M, dtype=torch.float32), torch.tensor(target),
        torch.tensor(basis), conv=1e-10, max_iters=100000,
    ).numpy()
    assert got[0] == 0.0
    np.testing.assert_allclose(got, q_host, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4)

    Mt, tm, bm = torch.tensor(M), torch.tensor(target), torch.tensor(basis)
    Mb = torch.where(bm[:, None], torch.eye(8, dtype=Mt.dtype), Mt)
    q = tm.to(Mt.dtype)
    for step in range(1, 10_000):  # check after every step
        qn = Mb @ torch.where(tm, 1.0, torch.where(bm, 0.0, q)).to(Mt.dtype)
        converged = float((q - qn).abs().sum()) <= 1e-6
        q = qn
        if converged:
            break
    assert 1 < step < 10_000 - 1  # stopped by the check, not by max_iters
    assert torch.equal(
        tlinalg.committor_device(Mt, tm, bm, conv=1e-6), q)


def test_save_load_round_trip(built, tmp_path):
    m = built[1]
    path = tmp_path / "model.pkl"
    m.save(path)
    loaded = modelWE.load(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded.JtargetSS == m.JtargetSS
    np.testing.assert_array_equal(loaded.fluxMatrix, m.fluxMatrix)
    assert [v.JtargetSS for v in loaded.validation_models] == [
        v.JtargetSS for v in m.validation_models]
    loaded.get_fluxMatrix(0, first_iter=1, last_iter=loaded.maxIter)
    loaded.organize_fluxMatrix()
    np.testing.assert_array_equal(loaded.fluxMatrix, m.fluxMatrix)
    assert loaded.clusters.strat is loaded._strat


def test_deepcopy_keeps_device_and_shares_the_data(built):
    m = built[1]
    c = copy.deepcopy(m)
    assert c.device == m.device and c._strat.device == m._strat.device
    assert c._dataset is m._dataset and c._strat is not m._strat
    assert c.clusters.model is c and c.clusters.strat is c._strat
    assert c._dev_feats_cache is None
