"""``msm_we_tpu_torch.extended.ExtendedModelWE`` against the JAX package's
``ExtendedModelWE`` on the same west.h5 file, on the CPU.

The JAX model is built as ``tests/test_extended.py`` builds it (40
iterations x 24 segments, seed 17, no reduction, 2 clusters a bin over 10
WE bins); the port's model gets the same fitted bank and bin grid through
``convert.fitted_state_from_arrays`` and runs its own stages from the
discretization on. Everything after the ids is host float64 in both
packages, so the flux, T, pSS and every extended method agree to 1e-12.
The ``adaptive`` kh bins run each package's own k-means, whose k-means++
draws differ by design; they are held to JAX's ``lloyd`` run from the
port's k-means++ rows within 1e-5, and the allocation at the port's centers
to JAX's at the same centers to 1e-12.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.extended import ExtendedModelWE as JaxExtended
from msm_we_tpu.ops import kmeans as jkm
from msm_we_tpu_torch import ExtendedModelWE
from msm_we_tpu_torch.convert import fitted_state_from_arrays

from _torch_parity import assert_ids_match

torch.set_num_threads(1)

EDGES = np.linspace(0, 10, 11)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
INIT = dict(basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
            dim_reduce_method="none", tau=1.0)
TOL = dict(rtol=1e-12, atol=1e-15)


def _solve(model):
    model.get_fluxMatrix(0)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    return model


def _pair(path, port_path=None):
    """The JAX fixture of ``tests/test_extended.py`` on ``path`` and the
    port's model on ``port_path`` (default the same file) carrying its
    fitted bank, both solved."""
    j = JaxExtended()
    j.initialize([path], REF, "ext", **INIT)
    j.get_iterations()
    j.get_coordSet(j.maxIter)
    j.dimReduce()
    j.cluster_coordinates(n_clusters=2, stratified=True,
                          user_bin_mapper=JaxMapper([EDGES]))
    strat = j._strat
    strat._sync_host()
    m = ExtendedModelWE(device="cpu")
    m.initialize([port_path or path], REF, "ext", **INIT)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    fitted_state_from_arrays(
        m, centers=strat.centers, counts=strat.counts, center_bin=strat.center_bin,
        valid=strat.valid, initialized=strat.initialized, we_remap=strat.we_remap,
        bin_edges=[EDGES])
    return _solve(j), _solve(m)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_ext") / "west.h5")
    generate_west_h5(path, n_iterations=40, n_segments=24, seed=17)
    j, m = _pair(path)
    for model in (j, m):
        model.get_hflux(conv=1e-3, max_iters=500)
        model.get_model_aristoffian()
    return j, m


def test_carried_build_matches_jax(models):
    j, m = models
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, **TOL)
    np.testing.assert_allclose(m.fluxMatrix, j.fluxMatrix, **TOL)
    np.testing.assert_allclose(m.Tmatrix, j.Tmatrix, **TOL)
    np.testing.assert_allclose(m.pSS, j.pSS, **TOL)
    np.testing.assert_allclose(m.JtargetSS, j.JtargetSS, **TOL)
    np.testing.assert_array_equal(m.pcoord_sort_indices, j.pcoord_sort_indices)


def test_pcoord1d_fluxmatrix_matches_jax(models):
    j, m = models
    binbounds = np.linspace(0, 10, 11)
    fm = m.get_pcoord1D_fluxMatrix(0, 1, m.maxIter - 1, binbounds)
    np.testing.assert_allclose(fm, j.get_pcoord1D_fluxMatrix(0, 1, j.maxIter - 1, binbounds),
                               **TOL)
    assert fm.shape == (10, 10) and (fm >= 0).all()
    assert np.isclose(fm.sum(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="last_iter > first_iter"):
        m.get_pcoord1D_fluxMatrix(0, 5, 5, binbounds)


def test_hflux_and_aristoffian_match_jax(models):
    j, m = models
    np.testing.assert_allclose(m.h, j.h, **TOL)
    np.testing.assert_allclose(m.kh, j.kh, **TOL)
    np.testing.assert_allclose(m.varh, j.varh, **TOL)
    assert m.h.shape == (m.nBins, 1) and (m.varh >= -1e-8).all()


ALLOCATION = ("alloc", "walkers_per_bin", "binObjective", "khbins_binCenters",
              "khbins_binEdges", "bin_kh_var", "bin_mutV", "bin_selV",
              "nOccupancySS", "nOccupied", "nAdapt", "rhomutation", "value")


def _assert_allocation_matches(m, j):
    for name in ALLOCATION:
        np.testing.assert_allclose(np.asarray(getattr(m, name), float),
                                   np.asarray(getattr(j, name), float),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("bin_method", ["uniform", "log_uniform", "adaptive"])
def test_aristoffian_allocation_matches_jax(models, bin_method):
    j, m = models
    for model in (j, m):
        model.binMethod, model.allocationMethod = bin_method, "adaptive"
        model.nB, model.nW = 5, 50
    m.get_model_steady_state_aristoffian()
    assert np.isclose(m.alloc.sum(), 1.0) and m.walkers_per_bin.sum() >= 5
    assert m.binObjective >= 0
    assert len(m.khbins_binEdges) == len(m.khbins_binCenters) + 1
    if bin_method == "adaptive":
        # The port's k-means++ rows through JAX's Lloyd sweeps give the
        # port's centers
        kh = np.asarray(m.kh).reshape(-1)
        X = kh[:, None].astype(np.float32)
        from msm_we_tpu_torch.ops.kmeans import kmeans_fit

        centers, _ids, init = kmeans_fit(X, None, 5, seed=0, device="cpu",
                                          return_init=True)
        ref = np.asarray(jkm.lloyd(jnp.asarray(X), jnp.ones(len(X), jnp.float32),
                                   jnp.asarray(X[init]), n_iter=50))
        np.testing.assert_allclose(np.sort(centers[:, 0]), np.sort(ref[:, 0]),
                                   rtol=1e-5, atol=1e-5 * np.abs(kh).max())
        np.testing.assert_array_equal(np.sort(m.khbins_binCenters),
                                      np.unique(centers[:, 0]))
        # The allocation at the port's centers equals JAX's at the same ones
        for model in (j, m):
            model.binMethod = "optimized"
            model.khbins_binCenters = np.unique(centers[:, 0])
        m.get_model_steady_state_aristoffian()
    j.get_model_steady_state_aristoffian()
    _assert_allocation_matches(m, j)


def test_adaptive_kh_bins_run_kmeans_on_the_model_device(models, monkeypatch):
    import msm_we_tpu_torch.ops.kmeans as kmeans

    _j, m = models
    devices, real = [], kmeans.kmeans_fit

    def counted(*a, **k):
        devices.append(k["device"])
        return real(*a, **k)

    monkeypatch.setattr(kmeans, "kmeans_fit", counted)
    m.binMethod, m.nB = "adaptive", 4
    m._kh_bin_centers(4)
    assert devices == [m.device]


def test_equal_allocation_bins_and_kh_var_match_jax(models, tmp_path, monkeypatch):
    j, m = models
    monkeypatch.chdir(tmp_path)  # both write khbins_binCenters.dat
    for model in (j, m):
        model.binMethod, model.allocationMethod, model.nB, model.nW = "uniform", "adaptive", 5, 50
    m.get_initial_khbins_equalAlloc()
    port_file = np.loadtxt("khbins_binCenters.dat")
    j.get_initial_khbins_equalAlloc()
    np.testing.assert_allclose(m.khbins_binCenters, j.khbins_binCenters, **TOL)
    np.testing.assert_allclose(m.khbins_binEdges, j.khbins_binEdges, **TOL)
    np.testing.assert_allclose(port_file, np.loadtxt("khbins_binCenters.dat"), **TOL)
    m.get_initial_khbins()
    j.get_initial_khbins()
    np.testing.assert_allclose(m.khbins_binCenters, j.khbins_binCenters, **TOL)
    kh = np.asarray(m.kh).reshape(-1)
    centers = np.linspace(kh.min(), kh.max(), 4)
    total = m.get_bin_kh_var(centers)
    np.testing.assert_allclose(total, j.get_bin_kh_var(centers), **TOL)
    np.testing.assert_allclose(m.bin_kh_var, j.bin_kh_var, **TOL)
    assert total >= 0


def test_bin_total_var_matches_jax(models):
    j, m = models
    kh = np.asarray(m.kh).reshape(-1)
    centers = np.linspace(kh.min(), kh.max(), 4)
    obj = m.get_bin_total_var(centers)
    np.testing.assert_allclose(obj, j.get_bin_total_var(centers), **TOL)
    assert np.isfinite(obj) and obj >= 0 and m.binMethod == "optimized"
    _assert_allocation_matches(m, j)


def test_direct_flux_and_warps_match_jax(models):
    j, m = models
    got = m.get_direct_target_flux(2, m.maxIter - 2, window=5)
    want = j.get_direct_target_flux(2, j.maxIter - 2, window=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert (got[0] >= 0).all() and len(got[0]) == len(got[1])
    for name in ("get_warps_from_parent", "get_warps_from_pcoord"):
        a, b = getattr(m, name)(2, 10), getattr(j, name)(2, 10)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_evolve_probability_matches_jax(models):
    j, m = models
    ref_pss = m.pSS.copy()
    for model in (j, m):
        model.evolve_probability(nEvolve=2000, nStore=100)
    np.testing.assert_allclose(m.probTransient, j.probTransient, **TOL)
    np.testing.assert_allclose(m.pEvolved, j.pEvolved, **TOL)
    assert np.allclose(m.probTransient.sum(axis=1), 1.0, atol=1e-8)
    assert np.allclose(m.pEvolved, ref_pss, atol=1e-3)
    np.testing.assert_array_equal(m.pSS, ref_pss)
    for model in (j, m):
        model.evolve_target_flux()
    np.testing.assert_allclose(m.Jtarget, j.Jtarget, **TOL)
    np.testing.assert_allclose(m.evolve_probability2(100, 50),
                               j.evolve_probability2(100, 50), **TOL)
    p0 = np.ones(m.nBins) / m.nBins
    np.testing.assert_allclose(m.evolve_probability_from_initial(p0, 100, 50),
                               j.evolve_probability_from_initial(p0, 100, 50), **TOL)
    np.testing.assert_array_equal(m.pSS, ref_pss)
    with pytest.raises(NotImplementedError, match="pyemma"):
        m.load_clusters("clusters.h5")


def test_model_cluster_assign_matches_jax(models):
    j, m = models
    for it in (3, 17, m.maxIter - 1):
        m.load_iter_data(it)
        j.load_iter_data(it)
        parent, child, _w = m._dataset.iter_coord_pairs(it)
        for coords, pcoords in ((parent, m.pcoord0List), (child, m.pcoord1List)):
            got = m._model_cluster_assign(coords, pcoords)
            want = j._model_cluster_assign(coords, pcoords)
            feats = m.reduceCoordinates(np.nan_to_num(coords)).astype(np.float32)
            bins = m._strat.we_remap[m._bin_mapper.assign(np.nan_to_num(pcoords))]
            inv_want = np.asarray(m.pcoord_sort_indices)[want]
            inv_got = np.asarray(m.pcoord_sort_indices)[got]
            assert_ids_match(inv_got, inv_want, feats, bins, *m._strat.compact_bank(),
                             n_regular=m._strat.n_total_clusters)


def test_iter_aristoffian_and_kh_pcoord_write_match_jax(tmp_path):
    """``get_iter_aristoffian`` and ``write_iter_kh_pcoord`` (the JAX test's
    30 x 16 file, seed 9), each package writing its own copy of the file:
    the kh lists and the written pcoord datasets are equal."""
    import h5py

    src = str(tmp_path / "west.h5")
    generate_west_h5(src, n_iterations=30, n_segments=16, seed=9)
    paths = []
    for name in ("jax", "port"):
        paths.append(str(tmp_path / f"{name}.h5"))
        shutil.copyfile(src, paths[-1])
    j, m = _pair(*paths)
    for model in (j, m):
        model.get_hflux(1e-3, max_iters=200)
        model.get_model_aristoffian()
    kh_list = m.get_iter_aristoffian(10)
    np.testing.assert_array_equal(kh_list, j.get_iter_aristoffian(10))
    assert kh_list.shape == (m.nSeg, 1) and np.isfinite(kh_list).all()
    for model in (j, m):
        model.load_iter_data(10)
    written = m.write_iter_kh_pcoord()
    np.testing.assert_array_equal(written, j.write_iter_kh_pcoord())
    pcs = []
    for path in paths:
        with h5py.File(path) as h5:
            pcs.append(h5["iterations/iter_00000010/pcoord"][:])
    np.testing.assert_array_equal(pcs[1], pcs[0])
    assert pcs[1].shape == (m.nSeg, 2, 2)
    np.testing.assert_array_equal(pcs[1][:, 1, 1], kh_list[:, 0])
    # The model reads the rewritten iteration afresh
    m.load_iter_data(10)
    np.testing.assert_array_equal(m.pcoord1List[:, 0], pcs[1][:, 1, 0])


def test_kh_pcoord_write_refuses_an_in_memory_dataset(models):
    from msm_we_tpu_torch import ArrayWEDataset
    from msm_we_tpu_torch.data import generate_we_arrays

    _j, m = models
    saved = m._dataset
    m._dataset = ArrayWEDataset(generate_we_arrays(4, 8, seed=1))
    try:
        with pytest.raises(ValueError, match="in-memory"):
            m.write_iter_kh_pcoord()
    finally:
        m._dataset = saved
