"""The port's build from west.h5 files: against the JAX package's build
from the same file, against the port's own ``ArrayWEDataset`` build of the
same arrays (bitwise), and the model's file-facing methods (the seven
data-access methods, ``close_files``, ``load(h5_paths=...)``, the bin
mapper read from the file).

One file written by the JAX package's ``generate_west_h5`` (12 iterations
x 32 segments, seed 17) feeds both packages; the configuration is
``tests/test_torch_build.py``'s (PCA, 12 rectilinear WE bins, basis
[9, 10], target [0, 1], 3 clusters a bin). Tolerances are that file's:
ids equal up to near-ties, flux to 1e-12 relative, pSS and JtargetSS to
1e-8 relative.
"""
import shutil
import threading

import h5py
import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5 as jax_generate_west_h5
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, WEDataset, modelWE
from msm_we_tpu_torch.convert import aggregated_state_from_arrays
from msm_we_tpu_torch.data import generate_we_arrays

from _torch_parity import assert_ids_match

torch.set_num_threads(1)

N_ITER, N_SEG, N_CLUSTERS, SEED = 12, 32, 3, 17
EDGES = np.linspace(0, 10, 13)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
BOUNDS = dict(basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]])
COMMON = dict(
    ref_struct=REF, modelName="file", dimreduce_method="pca", tau=1.0,
    n_clusters=N_CLUSTERS, cross_validation_groups=0, show_live_display=False,
    device_pipeline=True, **BOUNDS,
)


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_file_build") / "west.h5"
    jax_generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)


def _port_build(source, **kw):
    m = modelWE(device="cpu")
    step_kwargs = kw.pop("step_kwargs", {
        "clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES])}})
    m.build_analyze_model(file_paths=source, step_kwargs=step_kwargs,
                          **{**COMMON, **kw})
    return m


def _jax_build(path, **kw):
    m = JaxModelWE()
    m.build_analyze_model(
        file_paths=[path],
        step_kwargs={"clustering": {"user_bin_mapper": JaxMapper([EDGES])}},
        **{**COMMON, **kw},
    )
    return m


def _prepare(model, source):
    model.initialize(source, REF, "prepared", dim_reduce_method="pca", tau=1.0,
                     **BOUNDS)
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    return model


@pytest.fixture(scope="module")
def stratified_pair(west_h5):
    """(jax, port) stratified builds from the same file."""
    return _jax_build(west_h5), _port_build([west_h5])


@pytest.fixture(scope="module")
def aggregated_pair(west_h5):
    """(jax, port) aggregated models from the same file, the port
    discretized against the centers JAX's k-means fitted (its PRNG is JAX's
    own)."""
    j = _prepare(JaxModelWE(), [west_h5])
    j.cluster_coordinates(n_clusters=24, stratified=False)
    m = _prepare(modelWE(device="cpu"), [west_h5])
    aggregated_state_from_arrays(m, centers=j.clusters.cluster_centers_)
    m.launch_discretization()
    return j, m


def _assert_solution_matches(m, j):
    assert m.fluxMatrix.shape == j.fluxMatrix.shape
    np.testing.assert_allclose(m.fluxMatrix, j.fluxMatrix, rtol=1e-12)
    np.testing.assert_allclose(m.pSS, j.pSS, rtol=1e-8, atol=1e-15)
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8) and m.JtargetSS > 0


@pytest.mark.parametrize("n_lag", [0, 1])
def test_stratified_file_build_matches_jax(stratified_pair, n_lag):
    j, m = stratified_pair
    assert isinstance(m._dataset, WEDataset) and m.fileList == j.fileList
    np.testing.assert_array_equal(m._features["child"], j._features["child"])
    np.testing.assert_array_equal(m._features["parent"], j._features["parent"])
    # Host numpy updates in both packages: identical banks, identical ids
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    if n_lag == 0:
        np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12)
        _assert_solution_matches(m, j)
        assert [s[0] for s in m.stage_timings.stages] == [
            s[0] for s in j.stage_timings.stages]
    else:
        saved = [(x.fluxMatrixRaw, x._fluxMatrixParams) for x in (j, m)]
        for model in (j, m):
            model.get_fluxMatrix(n_lag)
        np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12)
        assert m.n_lag == j.n_lag == n_lag and m.fluxMatrixRaw.sum() > 0
        for model, (raw, params) in zip((j, m), saved):
            model.n_lag = 0
            model.fluxMatrixRaw, model._fluxMatrixParams = raw, params


@pytest.mark.parametrize("n_lag", [0, 1])
def test_aggregated_file_build_matches_jax(aggregated_pair, n_lag):
    import copy

    j, m = (copy.deepcopy(x) for x in aggregated_pair)
    feats = m._featurize_all()
    np.testing.assert_array_equal(feats["child"], j._features["child"])
    C = j.clusters.cluster_centers_
    one_bin = (C, np.zeros(len(C), np.int32), np.ones(len(C), bool))
    zeros = np.zeros(len(feats["child"]), np.int32)
    flips = assert_ids_match(m._child_idx, j._child_idx, feats["child"], zeros, *one_bin)
    flips += assert_ids_match(m._parent_idx, j._parent_idx, feats["parent"], zeros,
                              *one_bin)
    assert flips == 0
    for model in (j, m):
        model.get_fluxMatrix(n_lag)
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12, atol=0)
    if n_lag == 0:
        for model in (j, m):
            model.organize_fluxMatrix()
            model.get_Tmatrix()
            model.get_steady_state()
            model.get_steady_state_target_flux()
        _assert_solution_matches(m, j)


@pytest.mark.parametrize("config", [
    dict(),
    dict(device_pipeline=False, cross_validation_groups=2, cross_validation_blocks=2),
    dict(stratified=False, n_clusters=24),
    dict(dimreduce_method="tica"),
    dict(dedup_coordinates=False),
], ids=["bench", "default_cv", "aggregated", "tica", "no_dedup"])
def test_file_build_equals_array_build_bitwise(tmp_path, config):
    """Inside the port, the reader and the in-memory dataset feed the same
    build: dtrajs, flux and JtargetSS are bitwise equal."""
    n_iter = 30 if "cross_validation_groups" in config else N_ITER
    path = str(tmp_path / "west.h5")
    jax_generate_west_h5(path, n_iterations=n_iter, n_segments=N_SEG, seed=SEED)
    f = _port_build([path], **config)
    a = _port_build(ArrayWEDataset(generate_we_arrays(n_iter, N_SEG, seed=SEED)),
                    **config)
    for k in ("child", "parent", "pcoord0", "pcoord1", "weights", "iteration",
              "offsets"):
        np.testing.assert_array_equal(f._features[k], a._features[k])
    np.testing.assert_array_equal(np.concatenate(f.dtrajs), np.concatenate(a.dtrajs))
    np.testing.assert_array_equal(f.fluxMatrixRaw, a.fluxMatrixRaw)
    np.testing.assert_array_equal(f.fluxMatrix, a.fluxMatrix)
    np.testing.assert_array_equal(f.pSS, a.pSS)
    assert f.JtargetSS == a.JtargetSS and f.JtargetSS > 0
    if "cross_validation_groups" in config:
        assert [v.JtargetSS for v in f.validation_models] == [
            v.JtargetSS for v in a.validation_models]
        # Copies share no handle with the model, and none is left open
        assert all(v._dataset is not f._dataset for v in f.validation_models)
    assert f._dataset._open_handles == {} and f._dataset._block_cache is None
    assert not [t for t in threading.enumerate() if t.name == "westh5-prefetch"]


def test_two_file_build_matches_jax(tmp_path):
    paths = [str(tmp_path / "a.h5"), str(tmp_path / "b.h5")]
    jax_generate_west_h5(paths[0], n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    jax_generate_west_h5(paths[1], n_iterations=N_ITER, n_segments=16, seed=SEED + 1)
    j = JaxModelWE()
    j.build_analyze_model(
        file_paths=paths,
        step_kwargs={"clustering": {"user_bin_mapper": JaxMapper([EDGES])}}, **COMMON)
    m = _port_build(paths)
    assert m.n_data_files == j.n_data_files == 2
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12)
    _assert_solution_matches(m, j)


def test_initialize_takes_paths_string_and_dataset(west_h5, arrays, tmp_path):
    m = modelWE(device="cpu")
    m.initialize(west_h5 + " " + west_h5, REF, "string", pcoord_ndim=1, **BOUNDS)
    assert m.fileList == [west_h5, west_h5] and m.n_data_files == 2
    assert isinstance(m._dataset, WEDataset) and m.coordsExist is True
    assert m._dataset.iter_data(2)["n_segs"] == 2 * N_SEG
    assert m.pcoord_len == 2 and m.auxpath == "coord"
    m.close_files()
    m.initialize(ArrayWEDataset(arrays), REF, "memory", **BOUNDS)
    assert m.fileList == ["<in-memory>"] and m.coordsExist is True
    # A file whose coordinates are not written yet initializes, flagged so
    bare = str(tmp_path / "bare.h5")
    shutil.copy(west_h5, bare)
    with h5py.File(bare, "r+") as h5:
        for name in h5["iterations"]:
            del h5[f"iterations/{name}/auxdata"]
    for model in (modelWE(device="cpu"), JaxModelWE()):
        model.initialize([bare], REF, "bare", **BOUNDS)
        assert model.coordsExist is False
        model.close_files()
    with pytest.raises(FileNotFoundError):
        modelWE(device="cpu").initialize([str(tmp_path / "missing.h5")], REF, "x",
                                         **BOUNDS)


@pytest.mark.parametrize("source", ["file", "memory"])
def test_missing_bin_mapper_is_read_from_the_file_or_refused(west_h5, arrays, source):
    """Without ``user_bin_mapper`` the mapper comes from the west.h5; with
    no westpa installed (or in-memory data) that raises the JAX package's
    ``RuntimeError``, naming the port's binning module."""
    data = [west_h5] if source == "file" else ArrayWEDataset(arrays)
    with pytest.raises(RuntimeError, match="msm_we_tpu_torch.binning") as port:
        _port_build(data, step_kwargs={"clustering": {}})
    assert "user_bin_mapper" in str(port.value)
    if source == "file":
        with pytest.raises(RuntimeError, match="user_bin_mapper"):
            JaxModelWE().build_analyze_model(
                file_paths=[west_h5], step_kwargs={"clustering": {}}, **COMMON)


def test_failing_build_stops_the_prefetch_and_closes_the_files(west_h5, tmp_path):
    west_h5 = shutil.copy(west_h5, str(tmp_path / "own.h5"))  # no other reader

    def broken(coords):
        raise RuntimeError("featurizer failed")

    m = modelWE(device="cpu")
    with pytest.raises(RuntimeError, match="featurizer failed"):
        _ = m.build_analyze_model(
            file_paths=[west_h5],
            step_kwargs={"initialize": {"processCoordinates": broken},
                         "clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES])}},
            **COMMON)
    assert m._dataset._prefetch_thread is None and m._dataset._block_cache is None
    assert m._dataset._open_handles == {}
    assert not [t for t in threading.enumerate() if t.name == "westh5-prefetch"]
    with h5py.File(west_h5, "r+"):
        pass  # a writer can open the file again


# ------------------------------------------------------- data-access methods
@pytest.fixture(scope="module")
def initialized(tmp_path_factory):
    """(jax, port over the file, port over the arrays), initialized on a
    30-iteration run long enough to hold recycled lineages."""
    path = str(tmp_path_factory.mktemp("torch_file_access") / "west.h5")
    jax_generate_west_h5(path, n_iterations=30, n_segments=16, seed=11)
    models = []
    for model, source in (
        (JaxModelWE(), [path]),
        (modelWE(device="cpu"), [path]),
        (modelWE(device="cpu"),
         ArrayWEDataset(generate_we_arrays(30, 16, seed=11))),
    ):
        model.initialize(source, REF, "access", dim_reduce_method="none", tau=1.0,
                         **BOUNDS)
        model.get_iterations()
        models.append(model)
    return models


def _access(model, method):
    """The observable result of one data-access method."""
    if method == "get_iter_coordinates":
        out = model.get_iter_coordinates(7)
        return [out, model.n_iter, model.weightList, model.pcoord1List]
    if method == "load_iter_coordinates":
        model.load_iter_data(9)
        model.load_iter_coordinates()
        return [model.cur_iter_coords]
    if method == "load_iter_coordinates0":
        model.load_iter_data(9)
        model.load_iter_coordinates0()
        return [model.cur_iter_coords]
    if method == "get_iterations_iters":
        model.get_iterations_iters(3, 12)
        out = [model.numSegments, model.maxIter]
        model.get_iterations()
        return out
    if method == "get_coordinates":
        model.get_coordinates(4, 8)
        return [model.all_coords, model.first_iter, model.last_iter]
    if method == "get_seg_histories":
        model.load_iter_data(20)
        model.get_seg_histories(25)  # more than there is: clipped to n_iter
        return [model.seg_histories, model.weight_histories, model.n_hist]
    assert method == "get_traj_coordinates"
    trajs = model.get_traj_coordinates(20, 6)
    assert trajs is model.trajSet
    return [len(trajs)] + list(trajs)


@pytest.mark.parametrize("method", [
    "get_iter_coordinates", "load_iter_coordinates", "load_iter_coordinates0",
    "get_iterations_iters", "get_coordinates", "get_seg_histories",
    "get_traj_coordinates",
])
def test_data_access_methods_match_jax(initialized, method):
    j, f, a = initialized
    ref = _access(j, method)
    for model in (f, a):
        got = _access(model, method)
        assert len(got) == len(ref)
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype
    if method == "get_traj_coordinates":
        # Each step is the ancestor's final frame; recycled lineages are cut
        lengths = {len(t) for t in f.trajSet}
        assert max(lengths) == 6 and min(lengths) < 6
        final = f._dataset._iter_frame_block(20, -1)
        for s, t in enumerate(f.trajSet):
            np.testing.assert_array_equal(t[-1], final[s])


def test_close_files_and_load_with_new_paths(west_h5, tmp_path):
    west_h5 = shutil.copy(west_h5, str(tmp_path / "own.h5"))  # no other reader
    m = _port_build([west_h5])
    m.get_iter_coordinates(2)
    assert m._dataset._open_handles
    m.close_files()
    assert m._dataset._open_handles == {} and m._dataset._block_cache is None
    with h5py.File(west_h5, "r+"):
        pass  # a writer can open the file after close_files
    want = m.get_iter_coordinates(3)  # reads reopen lazily
    m.close_files()
    saved = str(tmp_path / "model.pkl")
    m.save(saved)

    moved = str(tmp_path / "moved.h5")
    shutil.copy(west_h5, moved)
    same = modelWE.load(saved, device="cpu")
    assert same.fileList == [west_h5] and same._dataset._open_handles == {}
    np.testing.assert_array_equal(same.get_iter_coordinates(3), want)
    same.close_files()

    loaded = modelWE.load(saved, h5_paths=[moved], device="cpu")
    assert loaded.fileList == [moved] and loaded.n_data_files == 1
    assert loaded._dataset.file_list == [moved] and loaded._features is None
    assert loaded.JtargetSS == m.JtargetSS
    np.testing.assert_array_equal(loaded.get_iter_coordinates(3), want)
    np.testing.assert_array_equal(loaded._featurize_all()["child"],
                                  m._features["child"])
    loaded.close_files()

    # The JAX package re-anchors the same way
    j = _jax_build(west_h5)
    j.save(str(tmp_path / "jax.pkl"))
    jl = JaxModelWE.load(str(tmp_path / "jax.pkl"), h5_paths=[moved])
    assert jl.fileList == loaded.fileList
    np.testing.assert_array_equal(jl.get_iter_coordinates(3), want)
    jl.close_files()
