"""Aggregated (non-stratified) clustering in the port against the JAX
package on the same synthetic WE run (12 iterations x 32 segments, seed
17, PCA, basis [9, 10], target [0, 1]).

JAX's ``kmeans_fit`` draws from its own PRNG, so its fitted centers are
carried across with ``convert.aggregated_state_from_arrays``; from there
the port discretizes (one-bin H4 scoring, so ids may differ only at
near-ties), builds the f64 flux (1e-12; 0.0 with dyadic weights), cleans
and solves as JAX does.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu_torch import ArrayWEDataset, modelWE
from msm_we_tpu_torch.convert import aggregated_state_from_arrays
from msm_we_tpu_torch.data import generate_we_arrays

from _torch_parity import assert_ids_match

torch.set_num_threads(1)

N_ITER, N_SEG, K, SEED = 12, 32, 24, 17
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
BOUNDS = dict(basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]])


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_aggregated") / "west.h5"
    generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)


def _prepare(model, source):
    model.initialize(source, REF, "aggregated", dim_reduce_method="pca", tau=1.0,
                     **BOUNDS)
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    return model


@pytest.fixture(scope="module")
def clustered(west_h5, arrays):
    """(jax, port) models discretized against JAX's aggregated bank, before
    the flux matrix."""
    j = _prepare(JaxModelWE(), [west_h5])
    j.cluster_coordinates(n_clusters=K, stratified=False)
    m = _prepare(modelWE(device="cpu"), ArrayWEDataset(arrays))
    aggregated_state_from_arrays(m, centers=j.clusters.cluster_centers_)
    m.launch_discretization()
    return j, m


def _assert_dtrajs_match(j, m):
    feats = m._featurize_all()
    C = j.clusters.cluster_centers_
    one_bin = (C, np.zeros(len(C), np.int32), np.ones(len(C), bool))
    zeros = np.zeros(len(feats["child"]), np.int32)
    flips = assert_ids_match(m._child_idx, j._child_idx, feats["child"], zeros, *one_bin)
    flips += assert_ids_match(m._parent_idx, j._parent_idx, feats["parent"], zeros,
                              *one_bin)
    return flips


def test_aggregated_dtrajs_from_jax_centers_match_jax(clustered):
    j, m = clustered
    assert m.clustering_method == j.clustering_method == "aggregated"
    assert m._strat is None and m.n_clusters == j.n_clusters == K
    np.testing.assert_array_equal(m._features["child"], j._features["child"])
    assert _assert_dtrajs_match(j, m) == 0


def test_aggregated_flux_matches_jax(clustered):
    """The f64 lag-0 flux to 1e-12, and bitwise with dyadic weights."""
    j, m = (copy.deepcopy(x) for x in clustered)
    for model in (j, m):
        model.get_fluxMatrix(0, first_iter=1, last_iter=model.maxIter)
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12, atol=0)
    dyadic = np.random.default_rng(0).integers(1, 64, len(m._features["weights"])) / 64.0
    for model in (j, m):
        model._features["weights"][:] = dyadic
        model.get_fluxMatrix(0, first_iter=1, last_iter=model.maxIter)
    np.testing.assert_array_equal(m.fluxMatrixRaw, j.fluxMatrixRaw)


def test_aggregated_cleaning_and_jtarget_match_jax(clustered):
    j, m = (copy.deepcopy(x) for x in clustered)
    for model in (j, m):
        model.get_fluxMatrix(0, first_iter=1, last_iter=model.maxIter)
        model.organize_fluxMatrix()
    assert m.fluxMatrix.shape == j.fluxMatrix.shape
    assert m.fluxMatrix.shape[0] < m.fluxMatrixRaw.shape[0]  # states were cleaned
    np.testing.assert_allclose(m.fluxMatrix, j.fluxMatrix, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    np.testing.assert_array_equal(m.clusters.cluster_centers_, j.clusters.cluster_centers_)
    for model in (j, m):
        model.get_Tmatrix()
        model.get_steady_state()
        model.get_steady_state_target_flux()
    np.testing.assert_allclose(m.Tmatrix, j.Tmatrix, rtol=1e-12)
    np.testing.assert_allclose(m.pSS, j.pSS, rtol=1e-8, atol=1e-15)
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8) and m.JtargetSS > 0


def test_organize_aggregated_incremental_equals_full(clustered):
    """Incremental cleaning (re-score only rows whose center was removed)
    equals a full re-discretization, in the port and in JAX."""
    results = []
    for base in clustered:
        per_mode = []
        for incremental in (True, False):
            model = copy.deepcopy(base)
            model.get_fluxMatrix(0, first_iter=1, last_iter=model.maxIter)
            model.organize_fluxMatrix(incremental=incremental)
            per_mode.append(model)
        inc, full = per_mode
        np.testing.assert_array_equal(np.concatenate(inc.dtrajs), np.concatenate(full.dtrajs))
        np.testing.assert_array_equal(inc.fluxMatrix, full.fluxMatrix)
        results.append(inc)
    np.testing.assert_array_equal(np.concatenate(results[0].dtrajs),
                                  np.concatenate(results[1].dtrajs))


def test_aggregated_flux_does_not_read_a_stratified_bank(clustered):
    """Regression: the lag-0 flux read ``model._strat`` whatever the
    clustering, and applied the stratified target-in-parent override to
    aggregated ids. With parents moved into the target region, the port's
    lag-0, lag-1 and per-iteration flux equal JAX's general chain, which
    applies that override only to stratified clustering."""
    j, m = (copy.deepcopy(x) for x in clustered)
    assert m._strat is None
    rows = np.arange(40, 200, 7)
    for model in (j, m):
        model._features["pcoord0"][rows] = 0.5  # inside the target bounds
        model._invalidate_pcoord_caches()
    assert m._pc_masks()["target_p"][rows].all()
    for lag in (0, 1):
        for model in (j, m):
            model.get_fluxMatrix(lag, first_iter=1, last_iter=model.maxIter)
        np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12, atol=0)
    # Those rows' flux leaves their own cluster, not the target state
    assert m.fluxMatrixRaw[K + 1].sum() == 0.0
    np.testing.assert_allclose(m.get_iter_fluxMatrix(5), j.get_iter_fluxMatrix(5),
                               rtol=1e-12, atol=0)


def test_aggregated_build_runs_with_validation(west_h5, arrays):
    """``build_analyze_model(stratified=False)`` with block validation: the
    same stages as the JAX build, aggregated validation models, finite
    positive JtargetSS; a pickle round trip keeps the bank."""
    common = dict(ref_struct=REF, modelName="agg", dimreduce_method="pca", tau=1.0,
                  n_clusters=K, stratified=False, show_live_display=False, **BOUNDS)
    j = JaxModelWE()
    j.build_analyze_model(file_paths=[west_h5], **common)
    m = modelWE(device="cpu")
    m.build_analyze_model(file_paths=ArrayWEDataset(arrays), **common)
    assert [s[0] for s in m.stage_timings.stages] == [s[0] for s in j.stage_timings.stages]
    assert m.clustering_method == "aggregated" and m._strat is None
    assert len(set(m.kmeans_init_index.tolist())) == K
    for model in (j, m):
        assert np.isfinite(model.JtargetSS) and model.JtargetSS > 0
        assert len(model.validation_models) == 2
    assert all(v.clustering_method == "aggregated" for v in m.validation_models)
    assert m.validation_iterations == j.validation_iterations
    clone = pickle.loads(pickle.dumps(m))
    assert clone.clusters.device == torch.device("cpu")
    np.testing.assert_array_equal(clone.clusters.predict(m._features["child"]),
                                  m._child_idx)
