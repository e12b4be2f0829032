"""The port's haMSM build (``msm_we_tpu_torch.model.modelWE``) against the
JAX package's ``build_analyze_model`` on the same synthetic WE run.

The JAX build reads the west.h5 that ``msm_we_tpu.data.generate_west_h5``
writes; the port builds from an ``ArrayWEDataset`` of the same arrays, in
the configuration of ``bench.py`` (PCA, stratified, streaming, device
pipeline, 12 rectilinear WE bins, basis [9, 10], target [0, 1]) cut to
12 iterations x 32 segments and 3 clusters per bin.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.data.synthetic import SynthWESettings as JaxSettings
from msm_we_tpu.data.synthetic import generate_trajectory_arrays as jax_generate
from msm_we_tpu.data.westh5 import WEDataset
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu.ops.stratified import StratifiedKmeans as JaxStrat
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.convert import fitted_state_from_arrays
from msm_we_tpu_torch.data import SynthWESettings, generate_trajectory_arrays, generate_we_arrays
from msm_we_tpu_torch.ops.stratified import HOST_BATCH_THRESHOLD, StratifiedKmeans

from _torch_parity import assert_ids_match

torch.set_num_threads(1)

N_ITER, N_SEG, N_CLUSTERS, SEED = 12, 32, 3, 17
EDGES = np.linspace(0, 10, 13)
COMMON = dict(
    ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
    modelName="parity",
    basis_pcoord_bounds=[[9.0, 10.0]],
    target_pcoord_bounds=[[0.0, 1.0]],
    dimreduce_method="pca",
    tau=1.0,
    n_clusters=N_CLUSTERS,
    cross_validation_groups=0,
    show_live_display=False,
    device_pipeline=True,
)


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_build") / "west.h5"
    generate_west_h5(str(path), n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)
    return str(path)


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=N_ITER, n_segments=N_SEG, seed=SEED)


def _jax_build(path, scan, **kw):
    m = JaxModelWE()
    m.build_analyze_model(
        file_paths=[path],
        step_kwargs={"clustering": {"user_bin_mapper": JaxMapper([EDGES]),
                                    "scan_small_batches": scan}},
        **{**COMMON, **kw},
    )
    return m


def _port_build(data, scan, **kw):
    m = modelWE(device="cpu")
    step_kwargs = kw.pop("step_kwargs", {
        "clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES]),
                       "scan_small_batches": scan}})
    m.build_analyze_model(file_paths=ArrayWEDataset(data), step_kwargs=step_kwargs,
                          **{**COMMON, **kw})
    return m


@pytest.mark.parametrize("settings", [
    dict(n_iterations=6, n_segments=16, seed=3, warmup=2),
    dict(n_iterations=5, n_segments=9, seed=1, pcoord_len=3, pcoord_ndim=2),
])
def test_generator_matches_jax(settings):
    ref = jax_generate(JaxSettings(**settings))
    got = generate_trajectory_arrays(SynthWESettings(**settings))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_array_dataset_matches_west_h5_reader(west_h5, arrays):
    h5 = WEDataset([west_h5])
    mem = ArrayWEDataset(arrays)
    assert mem.maxIter == h5.maxIter == N_ITER
    np.testing.assert_array_equal(mem.numSegments, h5.numSegments)
    assert mem.pcoord_len == h5.pcoord_len or h5.pcoord_len is None
    for it in range(1, N_ITER + 1):
        a, b = mem.iter_data(it), h5.iter_data(it)
        for k in ("weights", "parent_ids", "pcoord0", "pcoord1", "seg_idx",
                  "parent_ids_global"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["n_segs"] == b["n_segs"]
        for x, y in zip(mem.iter_coord_pairs(it), h5.iter_coord_pairs(it)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(mem.iter_child_coords(it),
                                      h5.iter_child_coords(it))
        rows = np.arange(0, a["n_segs"], 3)
        np.testing.assert_array_equal(mem.iter_frame_subset(it, rows, 0),
                                      h5.iter_frame_subset(it, rows, 0))
    for lag in (1, 3):
        for x, y in zip(mem.ancestor_ids(N_ITER, lag), h5.ancestor_ids(N_ITER, lag)):
            np.testing.assert_array_equal(x, y)
    assert mem.check_continuity() == h5.check_continuity() is True
    with pytest.raises(KeyError):
        mem.iter_data(N_ITER + 1)  # the incomplete last iteration


@pytest.mark.parametrize("scan", [False, True], ids=["host_updates", "scan"])
def test_build_matches_jax(west_h5, arrays, scan):
    j = _jax_build(west_h5, scan)
    m = _port_build(arrays, scan)
    np.testing.assert_array_equal(m._features["child"], j._features["child"])
    dj, dm = np.concatenate(j.dtrajs), np.concatenate(m.dtrajs)
    flips = int((dj != dm).sum())
    print(f"scan_small_batches={scan}: {flips} of {len(dj)} dtraj rows flip")
    if not scan:
        # Host numpy updates in both packages: identical banks
        np.testing.assert_array_equal(dm, dj)
    else:
        # f32 scan sums in another order: flips only at near-ties
        assert flips <= 0.01 * len(dj)
    if flips == 0:
        np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12)
        np.testing.assert_allclose(m.fluxMatrix, j.fluxMatrix, rtol=1e-12)
        assert m.fluxMatrix.shape == j.fluxMatrix.shape
        np.testing.assert_allclose(m.pSS, j.pSS, rtol=1e-8, atol=1e-15)
        assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8)
    assert m.JtargetSS > 0 and np.isclose(m.pSS.sum(), 1.0)
    names = [s[0] for s in m.stage_timings.stages]
    assert names == [s[0] for s in j.stage_timings.stages]


def test_stagewise_from_jax_fitted_state(west_h5, arrays):
    """Inject the JAX build's fitted PCA + stratified bank, then compare
    discretization -> flux -> cleaning -> JtargetSS stage by stage."""
    j = JaxModelWE()
    j.initialize([west_h5], COMMON["ref_struct"], "jax",
                 basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="pca",
                 tau=1.0)
    j.get_iterations()
    j.get_coordSet(j.maxIter)
    j.dimReduce()
    j.enable_mesh()
    j.cluster_coordinates(n_clusters=N_CLUSTERS, streaming=True, stratified=True,
                          user_bin_mapper=JaxMapper([EDGES]),
                          scan_small_batches=True)
    strat = j._strat
    strat._sync_host()

    m = modelWE(device="cpu")
    m.initialize(ArrayWEDataset(arrays), COMMON["ref_struct"], "port",
                 basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="pca",
                 tau=1.0)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    fitted_state_from_arrays(
        m, pca_mean=j.coordinates.mean_, pca_components=j.coordinates.components_,
        pca_explained_variance=j.coordinates.explained_variance_,
        centers=strat.centers, counts=strat.counts, center_bin=strat.center_bin,
        valid=strat.valid, initialized=strat.initialized, we_remap=strat.we_remap,
        bin_edges=[EDGES],
    )
    m.launch_discretization()
    feats = m._featurize_all()
    bank = strat.compact_bank()
    n_reg = strat.n_total_clusters
    pb, cb = m._raw_we_bins()
    assert_ids_match(m._child_idx, j._child_idx, feats["child"],
                     strat.we_remap[cb], *bank, n_regular=n_reg)
    assert_ids_match(m._parent_idx, j._parent_idx, feats["parent"],
                     strat.we_remap[pb], *bank, n_regular=n_reg)

    for model in (j, m):
        model.get_fluxMatrix(0, first_iter=1, last_iter=model.maxIter)
    np.testing.assert_allclose(m.fluxMatrixRaw, j.fluxMatrixRaw, rtol=1e-12)
    for model in (j, m):
        model.organize_fluxMatrix()
    assert m.fluxMatrix.shape == j.fluxMatrix.shape
    np.testing.assert_allclose(m.fluxMatrix, j.fluxMatrix, rtol=1e-12)
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    for model in (j, m):
        model.get_Tmatrix()
        model.get_steady_state()
        model.get_steady_state_target_flux()
    np.testing.assert_allclose(m.Tmatrix, j.Tmatrix, rtol=1e-12)
    np.testing.assert_allclose(m.pSS, j.pSS, rtol=1e-8, atol=1e-15)
    assert m.JtargetSS == pytest.approx(j.JtargetSS, rel=1e-8)


def test_dedup_off_matches_auto(arrays):
    auto = _port_build(arrays, True)
    off = _port_build(arrays, True, dedup_coordinates=False)
    assert auto._features.parent_is_lazy and not off._features.parent_is_lazy
    for k in ("child", "parent", "pcoord0", "pcoord1", "weights", "iteration",
              "offsets"):
        np.testing.assert_array_equal(auto._features[k], off._features[k])
    assert auto.JtargetSS == off.JtargetSS
    np.testing.assert_array_equal(np.concatenate(auto.dtrajs),
                                  np.concatenate(off.dtrajs))


def test_stratified_predict_matches_jax(arrays):
    rng = np.random.default_rng(2)
    n_bins, k, d = 3, 4, 5
    X_fit = rng.normal(size=(90, d)).astype(np.float32)
    bins_fit = np.repeat(np.arange(n_bins), 30)
    j, p = JaxStrat(n_bins, k, d, seed=4), StratifiedKmeans(n_bins, k, d, seed=4)
    j.partial_fit(X_fit, bins_fit)
    p.partial_fit(X_fit, bins_fit)
    np.testing.assert_array_equal(p.centers, j.centers)
    for n in (50, HOST_BATCH_THRESHOLD + 10):  # host and device routes
        X = rng.normal(size=(n, d)).astype(np.float32)
        b = rng.integers(0, n_bins, n)
        basis, target = rng.random(n) < 0.1, rng.random(n) < 0.1
        out = p.predict(X, b, is_basis=basis, is_target=target)
        ref = j.predict(X, b, is_basis=basis, is_target=target)
        assert_ids_match(out, ref, X, b, *p.compact_bank(),
                         n_regular=p.n_total_clusters)


def test_device_family_seeding_is_not_ported():
    """Device-family seeding is ported now: a bin seeding from
    ``HOST_BATCH_THRESHOLD`` members seeds through ``seed_bins_batched``
    (tests/test_torch_seeding.py holds it to the JAX package)."""
    from msm_we_tpu_torch.ops.kmeans import seed_bin

    s = StratifiedKmeans(1, 2, 3, seed=5)
    X = np.random.default_rng(0).normal(size=(HOST_BATCH_THRESHOLD, 3)).astype(np.float32)
    assert s.partial_fit(X, np.zeros(len(X), int)) == {0}
    assert s.seeded_by_family == {"host": 0, "device": 1}
    packed = seed_bin(5, torch.as_tensor(X), torch.ones(len(X)), 2).numpy()
    np.testing.assert_array_equal(s.centers, packed[:, :-1])
    np.testing.assert_array_equal(s.counts, packed[:, -1])


@pytest.mark.parametrize("change", ["mdtraj", "bin_mapper", "profile_dir"])
def test_unported_configurations_raise(arrays, change, tmp_path):
    """mdtraj topologies are not ported and raise, naming their ROADMAP
    entry. A missing ``user_bin_mapper`` is read from the west.h5, which
    without westpa (or on in-memory data) raises the JAX package's
    ``RuntimeError``; ``profile_dir`` writes a trace and changes nothing."""
    if change == "mdtraj":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_build(arrays, True, ref_struct="topology.pdb")
    elif change == "bin_mapper":
        with pytest.raises(RuntimeError, match="msm_we_tpu_torch.binning"):
            _port_build(arrays, True, step_kwargs={"clustering": {}})
    else:
        traced = _port_build(arrays, True, profile_dir=str(tmp_path))
        files = os.listdir(tmp_path)
        assert len(files) == 1 and files[0].endswith(".json")
        assert traced.build_profile.trace_path == str(tmp_path / files[0])
        assert traced.JtargetSS == _port_build(arrays, True).JtargetSS


def test_west_h5_paths_and_lagged_flux_raise(west_h5, arrays):
    """west.h5 paths are read by the port's own reader; a lag with no usable
    history raises as in the JAX package (lagged flux itself:
    test_torch_analysis.py)."""
    from msm_we_tpu_torch.data.westh5 import WEDataset as PortWEDataset

    f = modelWE(device="cpu")
    f.initialize([west_h5], COMMON["ref_struct"], "x",
                 basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]])
    assert isinstance(f._dataset, PortWEDataset) and f.fileList == [west_h5]
    assert f.coordsExist is True and f.nSeg == N_SEG
    f.close_files()
    m = _port_build(arrays, True)
    with pytest.raises(ValueError, match="enough history"):
        m.get_fluxMatrix(N_ITER)


def _default_device_of(entry_point, tmp_path):
    """The device ``entry_point`` runs on when no device is given."""
    from msm_we_tpu_torch.entry import entry, hot_step
    from msm_we_tpu_torch.testing import make_problem

    if entry_point == "modelWE":
        return modelWE().device
    if entry_point == "load":
        path = tmp_path / "m.pkl"
        modelWE(device="cpu").save(path)
        return modelWE.load(path).device
    if entry_point == "entry":
        return entry()[1][0].device
    p = make_problem(n_segments=256, n_raw_features=16, n_components=4,
                     n_bins=4, k_per_bin=3, seed=1)
    return hot_step(p)["fm"].device


@pytest.mark.parametrize("entry_point", ["modelWE", "load", "entry", "hot_step"])
def test_entry_points_default_to_the_card(entry_point, tmp_path):
    """``modelWE()``, ``modelWE.load(path)``, ``entry()`` and
    ``hot_step(problem)`` run on the card when no device is given; without
    CUDA they raise the ``as_device`` error (no fallback to the CPU)."""
    import inspect

    from msm_we_tpu_torch.entry import entry, hot_step

    fn = {"modelWE": modelWE.__init__, "load": modelWE.load, "entry": entry,
          "hot_step": hot_step}[entry_point]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            _default_device_of(entry_point, tmp_path)
    else:
        assert _default_device_of(entry_point, tmp_path).type == "cuda"


def test_port_imports_no_jax_h5py_or_networkx():
    """In a fresh interpreter the port, its reader module, a tiny CPU build
    and a fitted ``NonMarkovModel`` pull in none of the JAX package's
    stack."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {root!r})
        import numpy as np
        import msm_we_tpu_torch
        from msm_we_tpu_torch import (ArrayWEDataset, RectilinearBinMapper,
                                      generate_we_arrays, modelWE)
        import msm_we_tpu_torch.entry, msm_we_tpu_torch.convert
        import msm_we_tpu_torch.data.westh5, msm_we_tpu_torch.tracing
        from msm_we_tpu_torch.msm import MatrixFPT, NonMarkovModel
        m = modelWE(device="cpu")
        m.build_analyze_model(
            file_paths=ArrayWEDataset(generate_we_arrays(12, 32, seed=17)),
            ref_struct={{"coords": None, "nAtoms": 4, "coord_ndim": 3}},
            modelName="iso", basis_pcoord_bounds=[[9.0, 10.0]],
            target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca",
            tau=1.0, n_clusters=3, show_live_display=False,
            step_kwargs={{"clustering": {{
                "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 13)]),
                "scan_small_batches": True}}}},
        )
        assert m.JtargetSS > 0 and len(m.validation_models) == 2
        m.get_committor()
        m.get_implied_timescales()
        m.bootstrap_target_flux(n_boot=5)
        MatrixFPT.fpt_distribution(m.Tmatrix, [0], [m.nBins - 1], [1.0],
                                   max_n_lags=5, engine="device", device="cpu")
        traj = np.random.default_rng(7).integers(0, 3, 5000)
        nm = NonMarkovModel([traj], stateA=[0], stateB=[2], lag_time=2)
        assert abs(nm.populations().sum() - 1.0) < 1e-12 and nm.mfpts()["mfptAB"] > 0
        assert nm.empirical_weighted_FS()[2] > 0
        loaded = [n for n in ("jax", "msm_we_tpu", "h5py", "networkx", "rich")
                  if n in sys.modules]
        print("LOADED", loaded)
        assert not loaded, loaded
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_update_cluster_structures_matches_jax(west_h5, arrays):
    j = _jax_build(west_h5, False)
    m = _port_build(arrays, False)
    j.update_cluster_structures()
    m.update_cluster_structures()
    assert m.cluster_structures.keys() == j.cluster_structures.keys()
    for c in j.cluster_structures:
        np.testing.assert_array_equal(np.asarray(m.cluster_structures[c]),
                                      np.asarray(j.cluster_structures[c]))
        assert m.cluster_structure_weights[c] == j.cluster_structure_weights[c]
        assert [s[:2] for s in m.structure_iteration_segments[c]] == [
            s[:2] for s in j.structure_iteration_segments[c]
        ]


def test_pca_moments_and_device_transform_match_jax():
    """The f32 moment path and the above-threshold transform (a torch
    product on the model's device) against the JAX package's."""
    from msm_we_tpu.ops.pca import MomentAccumulator as JaxMoments

    from msm_we_tpu_torch.ops.pca import MomentAccumulator

    rng = np.random.default_rng(3)
    d = 300
    mix = rng.normal(size=(d, d)) * 0.1
    blocks = [(rng.normal(size=(n, d)) @ mix + 2.0).astype(np.float32)
              for n in (700, 513, 1024)]
    models = {}
    for dtype in (np.float64, np.float32):
        port, ref = MomentAccumulator(d, dtype=dtype), JaxMoments(d, dtype=dtype)
        for b in blocks:
            port.add(b)
            ref.add(b)
        rtol = 1e-12 if dtype == np.float64 else 1e-4
        np.testing.assert_allclose(port.M2, ref.M2, rtol=rtol, atol=rtol * np.abs(ref.M2).max())
        np.testing.assert_allclose(port.mean, ref.mean, rtol=1e-12)
        models[dtype] = (port.finalize(variance_cutoff=0.9),
                         ref.finalize(variance_cutoff=0.9))
    pm, jm = models[np.float64]
    assert pm.n_components == jm.n_components
    X = np.concatenate(blocks)
    # Above _DEVICE_TRANSFORM_MIN_FLOPS: torch on the model's device vs jnp
    assert 2.0 * X.size * pm.n_components >= 5e7
    np.testing.assert_allclose(pm.transform(X), jm.transform(X), rtol=1e-4, atol=1e-4)
    small = X[:50]
    np.testing.assert_array_equal(pm.transform(small), jm.transform(small))
