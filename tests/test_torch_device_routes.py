"""The port's device flux and stats route against its host route and the
JAX package's forced device-flux build.

Small synthetic WE runs (12-30 iterations x 32-200 segments, 2-5 clusters a
bin, PCA, 12 rectilinear WE bins, basis [9, 10], target [0, 1]) from
seeded numpy generators. On the CPU the H3 wrapper runs its plain version
(``index_add_`` in f64), so the device route here checks the routing, the
row cache, the id conversion and the statistics; the kernel itself is held
to the plain version in tests/test_torch_assign_flux.py and on the card.

Tolerances: flux matrices 1e-12 of the largest entry (bitwise with dyadic
weights), ``JtargetSS`` 1e-10 relative, dtrajs equal, device cluster
statistics: counts equal, f32 means 1e-5 relative, min/max equal after the
f32 cast.

The ``cuda`` test runs on the card only (the JAX package is imported inside
the tests that need it, so the file collects without it):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_device_routes.py
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch import fluxmatrix, structures
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.discretization import device_child_assign, pair_discretize
from msm_we_tpu_torch.step import cluster_stats

torch.set_num_threads(1)

EDGES = np.linspace(0, 10, 13)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
FLUX_ENV = fluxmatrix.DEVICE_FLUX_MIN_ROWS_ENV
STATS_ENV = structures.DEVICE_STATS_MIN_ROWS_ENV
F32_ENV = fluxmatrix.DEVICE_FLUX_F32_ENV


def _data(n_iter, n_seg, seed=17, dyadic=False, tiny=False):
    data = generate_we_arrays(n_iterations=n_iter, n_segments=n_seg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if dyadic:
        # j/16: every cell sum is exact in f64 in any order
        for d in data:
            d["weights"] = rng.integers(1, 17, len(d["weights"])) / 16.0
    if tiny:
        # Weights from 1e-300 to 1 inside every iteration
        for d in data:
            d["weights"] = d["weights"] * 10.0 ** rng.uniform(-300, 0, len(d["weights"]))
    return data


def _build(data, device="cpu", n_clusters=3, **kw):
    m = modelWE(device=device)
    kw.setdefault("step_kwargs", {"clustering": {
        "user_bin_mapper": RectilinearBinMapper([EDGES]),
        "scan_small_batches": False}})
    if not kw.get("stratified", True):
        kw["step_kwargs"] = {k: v for k, v in kw["step_kwargs"].items()
                             if k != "clustering"}
    m.build_analyze_model(**{**dict(
        file_paths=ArrayWEDataset(data), ref_struct=REF, modelName="routes",
        basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca", tau=1.0, n_clusters=n_clusters,
        cross_validation_groups=0, show_live_display=False,
        device_pipeline=True), **kw})
    return m


def _device_route(monkeypatch):
    monkeypatch.setenv(FLUX_ENV, "0")
    monkeypatch.setenv(STATS_ENV, "0")


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max())


def _dtrajs(m):
    m._ensure_discretized()
    return np.concatenate(m.dtrajs)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("shape,n_clusters,incremental", [
    ((12, 32), 3, True), ((20, 64), 2, True), ((30, 200), 5, True),
    ((30, 200), 5, False),
], ids=["12x32", "20x64", "30x200", "30x200-full-rediscretize"])
def test_device_route_matches_host_route(monkeypatch, shape, n_clusters, incremental):
    data = _data(*shape)
    kw = dict(n_clusters=n_clusters)
    if not incremental:
        kw["step_kwargs"] = {
            "clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES]),
                           "scan_small_batches": False},
            "organize": {"incremental": False}}
    host = _build(data, **kw)
    assert host._child_idx is not None
    _device_route(monkeypatch)
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    stats_calls = _count_calls(monkeypatch, structures, "_get_cluster_centers_device")
    dev = _build(data, **kw)
    # The flux stage and every cleaning pass took the device routes, and no
    # stage materialized host ids
    assert len(flux_calls) >= 2 and len(stats_calls) == len(flux_calls) - 1
    assert dev._child_idx is None and dev.dtrajs is None
    assert _rel(dev.fluxMatrixRaw, host.fluxMatrixRaw) <= 1e-12
    assert dev.fluxMatrix.shape == host.fluxMatrix.shape
    assert dev.n_clusters == host.n_clusters
    assert dev.JtargetSS == pytest.approx(host.JtargetSS, rel=1e-10)
    swapped = int((dev.pcoord_sort_indices != host.pcoord_sort_indices).sum())
    if swapped == 0:
        assert _rel(dev.fluxMatrix, host.fluxMatrix) <= 1e-12
        np.testing.assert_allclose(dev.targetRMSD_centers, host.targetRMSD_centers,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.sort(dev.pSS), np.sort(host.pSS), rtol=1e-9,
                               atol=1e-18)
    # Materialized afterwards, against the final bank: the eager build's ids
    np.testing.assert_array_equal(_dtrajs(dev), _dtrajs(host))


def test_dyadic_weights_give_bitwise_equal_flux(monkeypatch):
    data = _data(30, 200, dyadic=True)
    host = _build(data, n_clusters=5)
    _device_route(monkeypatch)
    dev = _build(data, n_clusters=5)
    assert dev._child_idx is None
    np.testing.assert_array_equal(dev.fluxMatrixRaw, host.fluxMatrixRaw)
    np.testing.assert_array_equal(dev.fluxMatrix, host.fluxMatrix)
    assert dev.JtargetSS == host.JtargetSS


def test_tiny_weights_survive_the_device_flux(monkeypatch):
    """Weights from 1e-300 to 1 in one window: every nonzero entry of the
    device f64 flux equals the host bincount's to 1e-12 (none flushed)."""
    data = _data(20, 64, tiny=True)
    m = _clustered(data)
    m.get_fluxMatrix(0)
    host = m.fluxMatrixRaw.copy()
    assert m._device_f64_weights_ok(m._featurize_all()["weights"]) is True
    monkeypatch.setattr(modelWE, "_force_device_flux", True)
    m.get_fluxMatrix(0)
    dev = m.fluxMatrixRaw
    nz = host > 0
    assert np.array_equal(dev > 0, nz) and (host[nz] < 1e-200).any()
    np.testing.assert_allclose(dev[nz], host[nz], rtol=1e-12)


def _clustered(data, n_clusters=3, defer=False, bounds=None, device="cpu"):
    """A model clustered (stratified) but not yet through the flux stage."""
    bounds = bounds or ([[9.0, 10.0]], [[0.0, 1.0]])
    m = modelWE(device=device)
    m.initialize(ArrayWEDataset(data), REF, "stage", basis_pcoord_bounds=bounds[0],
                 target_pcoord_bounds=bounds[1], dim_reduce_method="pca", tau=1.0)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    m.dimReduce()
    m.cluster_coordinates(n_clusters=n_clusters, stratified=True,
                          user_bin_mapper=RectilinearBinMapper([EDGES]),
                          defer_discretization=defer)
    return m


@pytest.mark.parametrize("bounds", [
    ([[9.0, 10.0]], [[0.0, 1.0]]),
    ([[1.5, 3.0]], [[0.0, 2.0]]),  # overlapping: rows inside both regions
], ids=["disjoint", "overlapping"])
def test_h3_ids_become_the_dtrajs_of_pair_discretize(monkeypatch, bounds):
    """With deferred ids and the big-N knob unset, the forced device flux
    mints the dtrajs from H3's flux-order ids: bitwise the predict-order ids
    of ``pair_discretize``, and the flux equals the host bincount."""
    data = _data(20, 64)
    m = _clustered(data, defer=True, bounds=bounds)
    assert m._parent_idx is None and m.dtrajs is None
    if bounds[0][0][0] < bounds[1][0][1]:
        assert m._pc_masks()["overlap_c"] is not None
    monkeypatch.setattr(modelWE, "_force_device_flux", True)
    m.get_fluxMatrix(0)
    assert m._parent_idx is not None and m._scored_on_host is False
    dev_flux = m.fluxMatrixRaw.copy()
    pid, cid = pair_discretize(m, m._strat, *m._raw_we_bins())
    np.testing.assert_array_equal(m._parent_idx, pid)
    np.testing.assert_array_equal(m._child_idx, cid)
    assert m._parent_idx.dtype == pid.dtype == np.int32
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), cid)
    monkeypatch.setattr(modelWE, "_force_device_flux", False)
    m.get_fluxMatrix(0)
    assert _rel(dev_flux, m.fluxMatrixRaw) <= 1e-12


def test_big_n_knob_keeps_ids_on_the_device(monkeypatch):
    m = _clustered(_data(12, 32), defer=True)
    _device_route(monkeypatch)
    m.get_fluxMatrix(0)
    assert m._parent_idx is None and m.dtrajs is None


def test_default_route_is_unchanged_with_the_knobs_unset(monkeypatch):
    """Knobs unset: the build defers its discretization to the flux stage,
    materializes the ids there once, and sums on the host."""
    for env in (FLUX_ENV, STATS_ENV, F32_ENV):
        monkeypatch.delenv(env, raising=False)
    assert modelWE._force_device_flux is False
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    stats_calls = _count_calls(monkeypatch, structures, "_get_cluster_centers_device")
    import msm_we_tpu_torch.discretization as disc

    launches = _count_calls(monkeypatch, disc, "launch_discretization")
    data = _data(12, 32)
    m = _build(data)
    assert not flux_calls and not stats_calls and len(launches) == 1
    assert m._child_idx is not None and m.dtrajs is not None
    eager = _build(data, step_kwargs={"clustering": {
        "user_bin_mapper": RectilinearBinMapper([EDGES]),
        "scan_small_batches": False, "defer_discretization": False}})
    np.testing.assert_array_equal(m.fluxMatrixRaw, eager.fluxMatrixRaw)
    np.testing.assert_array_equal(_dtrajs(m), _dtrajs(eager))
    assert m.JtargetSS == eager.JtargetSS
    # The predict route (device_pipeline=False) never defers
    p = _clustered(data)
    assert p._parent_idx is not None
    p.device_pipeline = False
    p.cluster_coordinates(n_clusters=3, stratified=True,
                          user_bin_mapper=RectilinearBinMapper([EDGES]),
                          defer_discretization=True)
    assert p._parent_idx is not None


def test_deferred_cleaning_keeps_dtrajs_deferred(monkeypatch):
    data = _data(30, 200)
    eager = _build(data, n_clusters=5)
    _device_route(monkeypatch)
    m = _clustered(data, n_clusters=5, defer=True)
    m.get_fluxMatrix(0)
    n_before = m.n_clusters
    m.organize_fluxMatrix()
    assert m.n_clusters < n_before  # the passes removed states
    assert m._parent_idx is None and m.dtrajs is None and m.pair_dtrajs is None
    assert getattr(m, "_flux_prefer_host") is False
    np.testing.assert_array_equal(_dtrajs(m), _dtrajs(eager))
    np.testing.assert_array_equal(m._parent_idx, eager._parent_idx)


def test_row_cache_is_reused_and_dropped(monkeypatch):
    data = _data(20, 64)
    m = _clustered(data, defer=True)
    iters = list(range(2, m.maxIter))
    fm1 = fluxmatrix.device_flux_lag0(m, iters)
    cache = m._device_flux_row_cache
    assert cache is not None and cache[2]["w"].dtype == torch.float64
    assert cache[2]["raw_p"].dtype == torch.int32
    # A changed remap (what cleaning does) reuses the cached raw bins
    m._strat.set_remap(0, int(m._strat.we_remap[1]))
    fluxmatrix.device_flux_lag0(m, iters)
    assert m._device_flux_row_cache is cache
    fluxmatrix.device_flux_lag0(m, iters[:-1])
    assert m._device_flux_row_cache is not cache  # another window
    # The f32 tier accumulates in f32 and has its own cache entry
    monkeypatch.setenv(F32_ENV, "1")
    m._strat.we_remap[0] = 0
    fm32 = fluxmatrix.device_flux_lag0(m, iters)
    assert m._device_flux_row_cache[2]["w"].dtype == torch.float32
    assert fm32.dtype == np.float64
    np.testing.assert_allclose(fm32, fm1, rtol=2e-5, atol=1e-12)
    monkeypatch.delenv(F32_ENV)
    np.testing.assert_array_equal(fluxmatrix.device_flux_lag0(m, iters), fm1)
    structures._device_p1(m)
    assert m._device_p1_cache is not None
    for other in (copy.deepcopy(m), pickle.loads(pickle.dumps(m))):
        assert other._device_flux_row_cache is None
        assert other._device_p1_cache is None
        np.testing.assert_array_equal(fluxmatrix.device_flux_lag0(other, iters), fm1)
    assert m._device_flux_row_cache is not None
    m.to("cpu")
    assert m._device_flux_row_cache is None and m._device_p1_cache is None
    fluxmatrix.device_flux_lag0(m, iters)
    structures._device_p1(m)
    m.basis_pcoord_bounds = [[9.5, 10.0]]  # new masks: both caches go
    assert m._device_flux_row_cache is None and m._device_p1_cache is None


def test_cleaning_passes_share_one_row_upload(monkeypatch):
    _device_route(monkeypatch)
    uploads = _count_calls(monkeypatch, np, "isin")
    m = _clustered(_data(30, 200), n_clusters=5, defer=True)
    del uploads[:]
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    m.get_fluxMatrix(0)
    m.organize_fluxMatrix()
    assert len(flux_calls) >= 2 and len(uploads) == 1


@pytest.mark.parametrize("forced", [False, True], ids=["host", "forced-device"])
def test_aggregated_build_routes(monkeypatch, forced):
    data = _data(20, 64)
    host = _build(data, n_clusters=24, stratified=False)
    monkeypatch.setattr(modelWE, "_force_device_flux", forced)
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    m = _build(data, n_clusters=24, stratified=False)
    # The flux stage takes the one-bin H3 route when forced; cleaning has
    # the ids in hand and recomputes on the host
    assert len(flux_calls) == (1 if forced else 0)
    assert _rel(m.fluxMatrixRaw, host.fluxMatrixRaw) <= 1e-12
    assert m.JtargetSS == pytest.approx(host.JtargetSS, rel=1e-10)
    np.testing.assert_array_equal(_dtrajs(m), _dtrajs(host))


# ------------------------------------------------------------ against JAX


def _jax_forced_build(tmp_path, monkeypatch, n_iter, n_seg, n_clusters, **kw):
    from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
    from msm_we_tpu.data import generate_west_h5
    from msm_we_tpu.model import modelWE as JaxModelWE

    path = str(tmp_path / "west.h5")
    generate_west_h5(path, n_iterations=n_iter, n_segments=n_seg, seed=17)
    monkeypatch.setattr(JaxModelWE, "_force_device_flux", True)
    j = JaxModelWE()
    step_kwargs = {} if not kw.get("stratified", True) else {"clustering": {
        "user_bin_mapper": JaxMapper([EDGES]), "scan_small_batches": False}}
    j.build_analyze_model(
        file_paths=[path], ref_struct=REF, modelName="jax",
        basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca", tau=1.0, n_clusters=n_clusters,
        cross_validation_groups=0, show_live_display=False,
        device_pipeline=True, step_kwargs=step_kwargs, **kw)
    assert j._mesh is not None
    return j


@pytest.mark.parametrize("shape,n_clusters", [((12, 32), 3), ((30, 200), 5)],
                         ids=["12x32", "30x200"])
def test_forced_device_flux_build_matches_jax(tmp_path, monkeypatch, shape, n_clusters):
    """The JAX package's build on a mesh with ``_force_device_flux`` (the
    fused program that also mints the dtrajs) against the port's, both
    clustering with host numpy updates (identical banks)."""
    j = _jax_forced_build(tmp_path, monkeypatch, *shape, n_clusters)
    monkeypatch.setattr(modelWE, "_force_device_flux", True)
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    m = _build(_data(*shape), n_clusters=n_clusters)
    assert flux_calls
    np.testing.assert_array_equal(_dtrajs(m), np.concatenate(j.dtrajs))
    assert _rel(m.fluxMatrixRaw, j.fluxMatrixRaw) <= 1e-12
    assert m.fluxMatrix.shape == j.fluxMatrix.shape
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-10)


def test_deferred_device_build_matches_jax(tmp_path, monkeypatch):
    """Both packages with the routing knobs at 0: flux and cleaning never
    materialize host ids, and the results agree."""
    _device_route(monkeypatch)
    j = _jax_forced_build(tmp_path, monkeypatch, 30, 200, 5)
    m = _build(_data(30, 200), n_clusters=5)
    assert j._child_idx is None and m._child_idx is None
    assert m.fluxMatrix.shape == j.fluxMatrix.shape
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-10)
    np.testing.assert_allclose(m.targetRMSD_centers, j.targetRMSD_centers,
                               rtol=1e-5, atol=1e-6)
    j._ensure_discretized()
    np.testing.assert_array_equal(_dtrajs(m), np.concatenate(j.dtrajs))


def test_aggregated_forced_device_flux_matches_jax(tmp_path, monkeypatch):
    """JAX's aggregated bank (its k-means draws cannot be reproduced) is
    carried across; the one-bin device flux of both packages agrees."""
    from msm_we_tpu_torch.convert import aggregated_state_from_arrays

    j = _jax_forced_build(tmp_path, monkeypatch, 20, 64, 24, stratified=False)
    m = modelWE(device="cpu")
    m.initialize(ArrayWEDataset(_data(20, 64)), REF, "agg",
                 basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="pca", tau=1.0)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    m.dimReduce()
    # JAX's cleaned bank in both packages, then the forced device flux on it
    aggregated_state_from_arrays(m, centers=j.clusters.cluster_centers_)
    m.launch_discretization()
    monkeypatch.setattr(modelWE, "_force_device_flux", True)
    flux_calls = _count_calls(monkeypatch, fluxmatrix, "device_flux_lag0")
    m.get_fluxMatrix(0)
    j.get_fluxMatrix(0)
    assert flux_calls and m.n_clusters == j.n_clusters
    if np.array_equal(_dtrajs(m), np.concatenate(j.dtrajs)):
        assert _rel(m.fluxMatrixRaw, j.fluxMatrixRaw) <= 1e-12
    else:  # one-bin scoring: ids may differ at near-ties only
        assert (_dtrajs(m) != np.concatenate(j.dtrajs)).mean() <= 0.01


@pytest.mark.parametrize("ndim,nan_rows,N", [(1, 0, 4000), (2, 7, 4000), (2, 40, 30000)],
                         ids=["1d", "2d-nan", "2d-nan-30000-rows"])
def test_cluster_stats_matches_jax_one_device_mesh(ndim, nan_rows, N):
    import jax

    from msm_we_tpu.parallel import make_mesh
    from msm_we_tpu.parallel.sharded import build_sharded_cluster_stats

    rng = np.random.default_rng(3)
    k_max, n_live = 24, 19
    cid = rng.integers(-1, k_max + 2, N).astype(np.int32)
    p1 = rng.uniform(0, 10, (N, ndim)).astype(np.float32)
    for r in rng.choice(N, nan_rows, replace=False):
        p1[r, rng.integers(0, ndim)] = np.nan
    ref = build_sharded_cluster_stats(make_mesh(jax.devices()[:1]), k_max, ndim)(
        cid, p1, np.int32(n_live))
    got = cluster_stats(torch.as_tensor(cid), torch.as_tensor(p1), n_live, k_max)
    counts, sums, vmin, vmax = (t.numpy() for t in got)
    r_counts, r_sums, r_min, r_max = (np.asarray(a) for a in ref)
    assert counts.dtype == np.int32 and sums.dtype == np.float64
    np.testing.assert_array_equal(counts, r_counts)
    np.testing.assert_allclose(sums, r_sums, rtol=1e-5)
    np.testing.assert_array_equal(vmin, r_min)
    np.testing.assert_array_equal(vmax, r_max)
    # Ids outside [0, n_live) land in the trash row and count nowhere
    assert counts[n_live:].sum() == 0 and counts[:n_live].sum() > 0


def test_device_stats_match_host_stats(monkeypatch):
    """``_get_cluster_centers_device`` against the host f64 statistics of
    the same bank, with NaN pcoords in one dimension of a few rows."""
    data = _data(20, 64)
    m = _clustered(data, defer=True)
    feats = m._featurize_all()
    feats["pcoord1"][5::97, 0] = np.nan
    m._invalidate_pcoord_caches()
    order_d = structures._get_cluster_centers_device(m)
    centers_d, minmax_d = m.targetRMSD_centers.copy(), m.targetRMSD_minmax.copy()
    assert m._child_idx is None
    cid = device_child_assign(m, m._strat)
    k_max = m._strat.n_bins * m._strat.k
    counts = cluster_stats(cid, structures._device_p1(m), m.n_clusters, k_max)[0]
    m._ensure_discretized()
    order_h = m.get_cluster_centers()
    assert int((order_d != order_h).sum()) == 0
    np.testing.assert_allclose(centers_d, m.targetRMSD_centers, rtol=1e-5,
                               equal_nan=True)
    np.testing.assert_array_equal(
        minmax_d, m.targetRMSD_minmax.astype(np.float32).astype(np.float64))
    good = ~np.isnan(feats["pcoord1"][:, 0]) & (m._child_idx < m.n_clusters)
    np.testing.assert_array_equal(
        counts[:m.n_clusters, 0].numpy(),
        np.bincount(m._child_idx[good], minlength=m.n_clusters))


def test_device_stats_failure_surfaces(monkeypatch):
    """No retry on the host: an error on the device stats route raises."""
    _device_route(monkeypatch)
    m = _clustered(_data(12, 32), defer=True)
    m.get_fluxMatrix(0)

    def boom(*a, **k):
        raise ValueError("device stats broke")

    import msm_we_tpu_torch.step as step

    monkeypatch.setattr(step, "cluster_stats", boom)
    with pytest.raises(ValueError, match="device stats broke"):
        m.get_cluster_centers()


# --------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", ["route-parity-30x200", "weights-1e-300", "h3-mints-dtrajs-30x200"])
def test_device_route_on_the_card(monkeypatch, cuda_device, case):
    from msm_we_tpu_torch.ops import stratified_assign as sa

    if case == "route-parity-30x200":
        data = _data(30, 200, dyadic=True)
        host = _build(data, device="cuda", n_clusters=5)
        cpu = _build(data, device="cpu", n_clusters=5)
        _device_route(monkeypatch)
        sa.reset_launch_counts()
        dev = _build(data, device="cuda", n_clusters=5)
        assert sa.launch_counts()["assign_flux"] >= 2 and dev._child_idx is None
        np.testing.assert_array_equal(dev.fluxMatrixRaw, host.fluxMatrixRaw)
        np.testing.assert_array_equal(dev.fluxMatrixRaw, cpu.fluxMatrixRaw)
        assert dev.JtargetSS == pytest.approx(host.JtargetSS, rel=1e-10)
        np.testing.assert_array_equal(_dtrajs(dev), _dtrajs(host))
    elif case == "h3-mints-dtrajs-30x200":
        # Knobs unset, ids deferred, overlapping regions: the forced launch
        # turns H3's ids into the dtrajs, bitwise pair_discretize's (H4)
        m = _clustered(_data(30, 200), n_clusters=5, defer=True, device="cuda",
                       bounds=([[1.5, 3.0]], [[0.0, 2.0]]))
        monkeypatch.setattr(modelWE, "_force_device_flux", True)
        sa.reset_launch_counts()
        m.get_fluxMatrix(0)
        assert sa.launch_counts()["assign_flux"] == 1 and m._parent_idx is not None
        pid, cid = pair_discretize(m, m._strat, *m._raw_we_bins())
        np.testing.assert_array_equal(m._parent_idx, pid)
        np.testing.assert_array_equal(m._child_idx, cid)
        dev_flux = m.fluxMatrixRaw.copy()
        monkeypatch.setattr(modelWE, "_force_device_flux", False)
        m.get_fluxMatrix(0)
        assert _rel(dev_flux, m.fluxMatrixRaw) <= 1e-12
    else:
        m = _clustered(_data(20, 64, tiny=True), device="cuda")
        m.get_fluxMatrix(0)
        host = m.fluxMatrixRaw.copy()
        monkeypatch.setattr(modelWE, "_force_device_flux", True)
        sa.reset_launch_counts()
        m.get_fluxMatrix(0)
        assert sa.launch_counts()["assign_flux"] == 1
        nz = host > 0
        assert np.array_equal(m.fluxMatrixRaw > 0, nz) and (host[nz] < 1e-200).any()
        np.testing.assert_allclose(m.fluxMatrixRaw[nz], host[nz], rtol=1e-12)
