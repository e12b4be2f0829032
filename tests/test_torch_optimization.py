"""``msm_we_tpu_torch.optimization`` against ``msm_we_tpu.optimization`` on
the same seeded numpy arrays.

Tolerances: ``solve_discrepancy`` 1e-12 (both are one f64 ``numpy`` solve);
the MFPT bin functions give equal integer assignments (with sklearn both call the
same seeded ``KMeans``); the mapper's ``assign`` equals the JAX mapper's on
a bank carried across with ``convert.optimized_mapper_from_arrays``. With
sklearn hidden the port runs its own k-means, whose draws are not JAX's, so
that branch is held to the properties of a 1-D k-means partition instead.
"""
import base64
import pickle
import sys

import numpy as np
import pytest
import torch

from msm_we_tpu import optimization as jopt
from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.model import StratifiedClustersShim as JaxShim
from msm_we_tpu.ops.stratified import StratifiedKmeans as JaxStrat
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch import optimization as opt
from msm_we_tpu_torch.convert import optimized_mapper_from_arrays
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.model import StratifiedClustersShim

torch.set_num_threads(1)

EDGES = np.linspace(0, 10, 5)
BOUNDS = dict(target_pcoord_bounds=[[0.0, 1.0]], basis_pcoord_bounds=[[9.0, 10.0]])


def _chain(n, seed):
    """A random row-stochastic matrix and its stationary distribution."""
    rng = np.random.default_rng(seed)
    T = rng.random((n, n))
    T /= T.sum(1, keepdims=True)
    evals, evecs = np.linalg.eig(T.T)
    pi = np.real(evecs[:, np.argmax(np.real(evals))])
    return T, np.abs(pi) / np.abs(pi).sum()


@pytest.fixture(scope="module", params=[(20, 3), (60, 5)], ids=["n20", "n60"])
def discrepancy(request):
    T, pi = _chain(*request.param)
    B = [len(T) - 1]
    return T, pi, jopt.solve_discrepancy(T, pi, B), opt.solve_discrepancy(T, pi, B)


def test_solve_discrepancy_matches_jax(discrepancy):
    T, pi, (jd, jv), (d, v) = discrepancy
    np.testing.assert_allclose(d, jd, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(v, jv, rtol=1e-12, atol=1e-15)
    assert np.isclose(d @ pi, 0) and (v >= 0).all()
    lhs = (np.eye(len(T)) - T + np.outer(pi, pi) / (pi @ pi)) @ d
    b = np.zeros(len(T))
    b[-1] = 1.0
    np.testing.assert_allclose(lhs, b - pi[-1], atol=1e-10)


@pytest.mark.parametrize("n_bins", [4, 6, 9])
def test_uniform_bins_match_jax(discrepancy, n_bins):
    _T, pi, (jd, jv), (d, v) = discrepancy
    got = opt.get_uniform_mfpt_bins(v, d, pi, n_bins)
    np.testing.assert_array_equal(got, jopt.get_uniform_mfpt_bins(jv, jd, pi, n_bins))
    assert got.dtype.kind == "i" and got.min() >= 0 and got.max() <= n_bins - 2


def _count_kmeans_fit(monkeypatch):
    """The devices the port's own ``kmeans_fit`` was called with."""
    import msm_we_tpu_torch.ops.kmeans as kmeans

    devices, real = [], kmeans.kmeans_fit

    def counted(*a, **k):
        devices.append(k["device"])
        return real(*a, **k)

    monkeypatch.setattr(kmeans, "kmeans_fit", counted)
    return devices


@pytest.mark.parametrize("n_bins", [5, 7])
def test_clustered_bins_match_jax_with_sklearn(discrepancy, n_bins, monkeypatch):
    pytest.importorskip("sklearn")
    _T, pi, (jd, jv), (d, v) = discrepancy
    own = _count_kmeans_fit(monkeypatch)
    got = opt.get_clustered_mfpt_bins(v, d, pi, n_bins, seed=1, device="cpu")
    assert not own  # sklearn's KMeans ran, as in the JAX package
    ref = jopt.get_clustered_mfpt_bins(jv, jd, pi, n_bins, seed=1)
    np.testing.assert_array_equal(got.astype(int), ref.astype(int))
    assert not np.isnan(got).any() and len(np.unique(got)) == n_bins - 2


def test_clustered_bins_own_kmeans_without_sklearn(discrepancy, monkeypatch):
    """sklearn hidden: the port's ``kmeans_fit`` runs on the given device.
    A 1-D k-means partition cuts the sorted cumulative pi*v into contiguous
    runs, so every WE bin holds a contiguous run of the discrepancy order."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    _T, pi, _j, (d, v) = discrepancy
    n_bins = 6
    own = _count_kmeans_fit(monkeypatch)
    got = opt.get_clustered_mfpt_bins(v, d, pi, n_bins, seed=1, device="cpu")
    assert own == [torch.device("cpu")]
    assert not np.isnan(got).any()
    assert got.min() >= 0 and got.max() <= n_bins - 3
    along = got[np.argsort(d)]
    changes = int((np.diff(along) != 0).sum())
    assert changes == len(np.unique(got)) - 1 and len(np.unique(got)) >= 2
    again = opt.get_clustered_mfpt_bins(v, d, pi, n_bins, seed=1, device="cpu")
    np.testing.assert_array_equal(got, again)


def test_clustered_bins_default_device_is_the_card(discrepancy, monkeypatch):
    """No device given and no sklearn: the k-means runs on the card, and
    without one it raises (no quiet fall to the CPU)."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    _T, pi, _j, (d, v) = discrepancy
    if torch.cuda.is_available():
        assert not np.isnan(opt.get_clustered_mfpt_bins(v, d, pi, 6, seed=1)).any()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            opt.get_clustered_mfpt_bins(v, d, pi, 6, seed=1)


def _fitted_banks(seed=0, k=2):
    """The same stratified bank fitted in both packages (host numpy
    family: identical centers)."""
    rng = np.random.default_rng(seed)
    base = JaxMapper([EDGES])
    X = rng.uniform(0.1, 9.9, 400)[:, None].astype(np.float32)
    j = JaxStrat(base.nbins, k, 1, seed=0)
    j.partial_fit(X, base.assign(X))
    j._sync_host()
    return base, j


def _mappers(microstate_mapper=None):
    base, j = _fitted_banks()
    mm = microstate_mapper or {i: i % 6 for i in range(j.n_total_clusters)}
    jm = jopt.OptimizedBinMapper(
        nbins=8, n_original_pcoord_dims=1, previous_binmapper=base,
        microstate_mapper=mm, stratified_clusterer=JaxShim(base, None, j), **BOUNDS)
    pm = optimized_mapper_from_arrays(
        centers=j.centers, counts=j.counts, center_bin=j.center_bin, valid=j.valid,
        initialized=j.initialized, we_remap=j.we_remap, bin_edges=[EDGES],
        microstate_mapper=mm, nbins=8, n_original_pcoord_dims=1, device="cpu",
        **BOUNDS)
    return jm, pm


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.uniform(0.05, 9.95, (n, 2)), [[0.5, 0.1]], [[9.5, 7.0]]]
    ).astype(np.float32)


@pytest.mark.parametrize("n", [30, 5000], ids=["host-family", "device-family"])
def test_mapper_assign_matches_jax(n):
    jm, pm = _mappers()
    assert pm.n_clusters == jm.n_clusters and pm.nbins == jm.nbins
    coords = _coords(n, 1)
    got, ref = pm.assign(coords), jm.assign(coords)
    np.testing.assert_array_equal(got, ref)
    assert got[-2] == 7 and got[-1] == 6  # target, basis
    # A (n, frames, dims) block is read at its last frame
    block = np.stack([coords[::-1], coords], axis=1)
    np.testing.assert_array_equal(pm.assign(block), ref)


def test_mapper_cluster_on_pcoord_and_array_table():
    base, j = _fitted_banks()
    table = np.arange(j.n_total_clusters + 2) % 5
    kw = dict(nbins=7, n_original_pcoord_dims=1, cluster_on_pcoord=True, **BOUNDS)
    jm = jopt.OptimizedBinMapper(previous_binmapper=base, microstate_mapper=table,
                                 stratified_clusterer=JaxShim(base, None, j), **kw)
    pm = optimized_mapper_from_arrays(
        centers=j.centers, counts=j.counts, center_bin=j.center_bin, valid=j.valid,
        initialized=j.initialized, we_remap=j.we_remap, bin_edges=[EDGES],
        microstate_mapper=table, device="cpu", **kw)
    coords = _coords(64, 3)
    np.testing.assert_array_equal(pm.assign(coords), jm.assign(coords))


def test_bytestring_round_trip_holds_cpu_state():
    _jm, pm = _mappers()
    coords = _coords(200, 2)
    ref = pm.assign(coords)
    blob = pm.pickle_and_encode()
    assert isinstance(blob, bytes)
    restored = opt.OptimizedBinMapper(bytestring=blob, device="cpu")
    np.testing.assert_array_equal(restored.assign(coords), ref)
    strat = restored.clusterer.strat
    assert strat.device.type == "cpu" and strat._dev_state is None
    # Nothing in the transport format names a CUDA tensor or storage
    assert b"cuda" not in base64.b64decode(blob)
    with pytest.raises(AssertionError, match="Invalid pickled object"):
        opt.OptimizedBinMapper(
            bytestring=base64.b64encode(pickle.dumps({"a": 1})), device="cpu")


def test_bytestring_constructor_runs_on_the_card_by_default():
    """Like the port's other entry points: the card unless the caller asks
    for the CPU, and no quiet CPU substitute where there is no card."""
    _jm, pm = _mappers()
    blob = pm.pickle_and_encode()
    if torch.cuda.is_available():
        for restored in (opt.OptimizedBinMapper(bytestring=blob),
                         opt.OptimizedBinMapper(bytestring=blob, device="cuda")):
            assert restored.clusterer.strat.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            opt.OptimizedBinMapper(bytestring=blob)
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            pm.unpickle(blob)
    assert pm.clusterer.strat.device.type == "cpu"


def test_bytestring_of_a_device_resident_bank_loads_on_the_cpu():
    """A bank whose fill loop left its centers as device tensors pickles
    them as host arrays."""
    _jm, pm = _mappers()
    strat = pm.clusterer.strat
    strat._device_state()  # centers and counts as tensors, as after a scan
    assert strat._dev_state is not None
    restored = opt.OptimizedBinMapper(bytestring=pm.pickle_and_encode(), device="cpu")
    assert restored.clusterer.strat._dev_state is None
    coords = _coords(100, 5)
    np.testing.assert_array_equal(restored.assign(coords), pm.assign(coords))


@pytest.mark.parametrize("args,kwargs", [((), {}), ((8,), {}), ((), {"nbins": 8})],
                         ids=["none", "one-positional", "one-keyword"])
def test_constructor_refuses_an_unusable_mapper(args, kwargs):
    with pytest.raises(TypeError, match="bytestring"):
        opt.OptimizedBinMapper(*args, **kwargs)
    with pytest.raises(TypeError):
        jopt.OptimizedBinMapper(*args, **kwargs)


def test_noncontiguous_dict_keys_and_output_buffers():
    mm = {i: i % 6 for i in range(8)}
    del mm[4]
    jm, pm = _mappers(mm)
    coords = _coords(50, 4)
    for m in (jm, pm):
        m.clusterer.model.pcoord1List = coords[:, :1]
    micro = np.asarray(pm.clusterer.predict(coords[:, 1:]))
    coords[micro == 4, 0] = 0.5  # the missing microstate only inside the target
    np.testing.assert_array_equal(pm.assign(coords), jm.assign(coords))
    with pytest.raises(IndexError):
        pm.mapper(coords, np.ones(len(coords), bool), np.empty(len(coords) + 2))
    short = pm.mapper(coords, np.ones(len(coords), bool), np.empty(7))
    np.testing.assert_array_equal(short, jm.assign(coords)[:7])
    # Outside the target the missing microstate trips the mapper's own check
    outside = _coords(50, 4)
    rows = np.flatnonzero((micro == 4) & (outside[:, 0] > 1.0) & (outside[:, 0] < 9.0))
    assert len(rows)
    with pytest.raises(AssertionError, match="remapped"):
        pm.assign(outside)


def test_mapper_from_a_built_model_equals_the_composition_by_hand():
    data = generate_we_arrays(n_iterations=20, n_segments=64, seed=17)
    m = modelWE(device="cpu")
    mapper12 = RectilinearBinMapper([np.linspace(0, 10, 13)])
    m.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3}, modelName="opt",
        dimreduce_method="pca", tau=1.0, n_clusters=3, cross_validation_groups=0,
        show_live_display=False, device_pipeline=True,
        step_kwargs={"clustering": {"user_bin_mapper": mapper12}}, **BOUNDS)
    pss = np.squeeze(np.asarray(m.pSS))
    disc, var = opt.solve_discrepancy(m.Tmatrix, pss, m.indTargets)
    bins = opt.get_uniform_mfpt_bins(var, disc, pss, 6)
    table = np.zeros(m.n_clusters + 2)
    table[np.asarray(m.pcoord_sort_indices)] = bins
    om = opt.OptimizedBinMapper(
        nbins=6, n_original_pcoord_dims=1, previous_binmapper=m._bin_mapper,
        microstate_mapper=table,
        stratified_clusterer=StratifiedClustersShim(m._bin_mapper, None, m._strat),
        **BOUNDS)
    assert om.n_clusters == m.n_clusters + 2
    feats = m._featurize_all()
    pc, X = feats["pcoord1"], feats["child"]
    got = om.assign(np.column_stack([pc, X]))
    basis, target = m.is_WE_basis(pc), m.is_WE_target(pc)
    ids = m._strat.predict(X, m._bin_mapper.assign(pc), is_basis=basis, is_target=target)
    np.testing.assert_array_equal(ids, m._child_idx)
    want = table[ids]
    want[target], want[basis] = 5, 4
    np.testing.assert_array_equal(got, want.astype(int))
    # The model's own shim is untouched: it still reads the model's pcoords
    assert m.clusters.model is m
