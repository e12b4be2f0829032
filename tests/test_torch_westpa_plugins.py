"""``msm_we_tpu_torch.westpa_plugins`` against ``msm_we_tpu.westpa_plugins``
on the CPU (``device: "cpu"`` in the plugin config), without a WESTPA
install.

The 15 cases of ``tests/test_westpa_plugins.py``, the fake-WESTPA cycles of
``tests/test_restart_driver_integration.py`` (4) and
``tests/test_optimization_driver_integration.py`` (2), run over the port. At
these sizes (40 x 24 segments, host-family seeding) the port's plugin build
equals the JAX build: dtrajs equal, JtargetSS and pSS to 1e-12. On a port
model that carries the JAX model's fitted PCA and bank
(``convert.fitted_state_from_arrays``) the start-state entries, the restart
artifacts (``startstates.txt``, ``pSS.txt``, ``JtargetSS.txt``) and the
optimized microstate assignments equal JAX's; a full restart cycle writes
the same artifacts as the JAX driver's. A plain-pickle round trip of the
WESTPA-wrapped mapper keeps the device it was given, and a config without
``device`` builds on the card, which raises here (no CUDA): nothing falls
back to the CPU in silence.
"""
import json
import os
import pickle
import sys
import types
from collections import defaultdict
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import h5py
import numpy as np
import pytest
import torch

from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.westpa_plugins import hamsm_driver as jhd
from msm_we_tpu.westpa_plugins import optimization_driver as jod
from msm_we_tpu.westpa_plugins import restart_driver as jrd
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.convert import fitted_state_from_arrays
from msm_we_tpu_torch.westpa_plugins.hamsm_driver import build_hamsm_from_config
from msm_we_tpu_torch.westpa_plugins.optimization_driver import (
    _optimized_assign,
    _wrap_for_westpa,
    compute_new_pcoord_map,
    compute_optimized_bins_for_model,
)
from msm_we_tpu_torch.westpa_plugins.restart_driver import (
    check_target_reached,
    fix_deprecated_initialization,
    load_restart_state,
    marathon_west_files,
    save_restart_state,
    start_state_entries,
    write_restart_artifacts,
)

torch.set_num_threads(1)

EDGES = np.linspace(0, 10, 11)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}
TOL = dict(rtol=1e-12, atol=1e-15)


def _config(name, mapper_cls, **extra):
    return {
        "model_name": name,
        "n_clusters": 2,
        "tau": 1.0,
        "basis_pcoord_bounds": [[9.0, 10.0]],
        "target_pcoord_bounds": [[0.0, 1.0]],
        "dimreduce_method": "pca",
        "cross_validation_groups": 0,
        "user_bin_mapper": mapper_cls([EDGES]),
        "ref_pdb_file": REF,
        "show_live_display": False,
        **extra,
    }


@pytest.fixture(scope="module")
def west_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_weplug") / "west.h5"
    generate_west_h5(str(path), n_iterations=40, n_segments=24, seed=21)
    return str(path)


@pytest.fixture(scope="module")
def jax_model(west_h5):
    return jhd.build_hamsm_from_config(_config("plugin_test", JaxMapper), [west_h5])


@pytest.fixture(scope="module")
def hamsm_model(west_h5):
    return build_hamsm_from_config(
        _config("plugin_test", RectilinearBinMapper, device="cpu"), [west_h5])


@pytest.fixture(scope="module")
def carried(west_h5, jax_model):
    """A port model with the JAX plugin model's fitted PCA and bank, solved
    by the port's own stages."""
    j = jax_model
    strat = j._strat
    strat._sync_host()
    m = modelWE(device="cpu")
    m.initialize([west_h5], REF, "plugin_test", basis_pcoord_bounds=[[9.0, 10.0]],
                 target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="pca", tau=1.0)
    m.get_iterations()
    m.get_coordSet(m.maxIter)
    fitted_state_from_arrays(
        m, pca_mean=j.coordinates.mean_, pca_components=j.coordinates.components_,
        pca_explained_variance=j.coordinates.explained_variance_,
        centers=strat.centers, counts=strat.counts, center_bin=strat.center_bin,
        valid=strat.valid, initialized=strat.initialized, we_remap=strat.we_remap,
        bin_edges=[EDGES])
    m.get_fluxMatrix(0, first_iter=1)
    m.organize_fluxMatrix()
    m.get_Tmatrix()
    m.get_steady_state()
    m.get_steady_state_target_flux()
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    np.testing.assert_allclose(m.pSS, j.pSS, **TOL)
    return m


def test_check_target_reached(west_h5, tmp_path):
    assert check_target_reached(west_h5) and jrd.check_target_reached(west_h5)
    norec = tmp_path / "norec.h5"
    with h5py.File(west_h5, "r") as src, h5py.File(norec, "w") as dst:
        src.copy("iterations", dst)
        for key in dst["iterations"]:
            seg_index = dst[f"iterations/{key}/seg_index"]
            data = seg_index[:]
            data["endpoint_type"] = 1
            seg_index[...] = data
    assert not check_target_reached(str(norec))
    assert not jrd.check_target_reached(str(norec))


def test_restart_state_roundtrip(tmp_path):
    f = str(tmp_path / "restart.dat")
    state = load_restart_state(f)
    assert state == jrd.load_restart_state(f) == {"restarts_completed": 0,
                                                   "runs_completed": 0}
    state["runs_completed"] = 3
    save_restart_state(f, state)
    assert load_restart_state(f) == jrd.load_restart_state(f) == state


def test_fix_deprecated_initialization():
    old = {"tstate-file": "a", "bstate_file": "b", "segs-per-state": 2}
    fixed = fix_deprecated_initialization(dict(old))
    assert fixed == jrd.fix_deprecated_initialization(dict(old)) == {
        "tstate_file": "a", "bstate_file": "b", "segs_per_state": 2}


@pytest.mark.parametrize("restarts_to_use", [-1, 2, 0.5, 0.2])
def test_marathon_west_files(restarts_to_use):
    for state in ({"restarts_completed": 2, "runs_completed": 3},
                  {"restarts_completed": 3, "runs_completed": 2}):
        files = marathon_west_files(state, n_runs=3, restarts_to_use=restarts_to_use,
                                    base_path="B")
        assert files == jrd.marathon_west_files(
            state, n_runs=3, restarts_to_use=restarts_to_use, base_path="B")
        assert files  # a fraction rounding to 0 still takes one restart
    with pytest.raises(ValueError, match="restarts_to_use"):
        marathon_west_files(state, restarts_to_use=0)


def test_hamsm_from_config_matches_jax(hamsm_model, jax_model):
    m, j = hamsm_model, jax_model
    assert m.device.type == "cpu"
    assert m.JtargetSS > 0 and np.isclose(m.pSS.sum(), 1.0)
    np.testing.assert_array_equal(np.concatenate(m.dtrajs), np.concatenate(j.dtrajs))
    np.testing.assert_allclose(m.JtargetSS, j.JtargetSS, **TOL)
    np.testing.assert_allclose(m.pSS, j.pSS, **TOL)


def test_hamsm_from_config_devices_and_datasets(west_h5, hamsm_model):
    """The device comes from the keyword, else the config, else the card
    (which raises without CUDA); an ``ArrayWEDataset`` of the arrays the
    file was written from gives the file build bitwise."""
    from msm_we_tpu_torch.data import generate_we_arrays

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_hamsm_from_config(_config("x", RectilinearBinMapper), [west_h5])
    model = build_hamsm_from_config(
        _config("arrays", RectilinearBinMapper, device="cuda"),
        ArrayWEDataset(generate_we_arrays(40, 24, seed=21)), device="cpu")
    assert model.device.type == "cpu"
    np.testing.assert_array_equal(np.concatenate(model.dtrajs),
                                  np.concatenate(hamsm_model.dtrajs))
    assert model.JtargetSS == hamsm_model.JtargetSS


def _entries(model):
    model.update_cluster_structures(build_pcoord_cache=True)
    return list(start_state_entries(model, model.pSS))


def test_start_state_entries(hamsm_model, carried, jax_model):
    entries = _entries(hamsm_model)
    assert len(entries) > 0
    total = sum(w for _b, _s, w, _x in entries)
    assert np.isclose(total, hamsm_model.pSS[: hamsm_model.n_clusters].sum(), rtol=1e-6)
    bins = {b for b, _s, _w, _x in entries}
    assert hamsm_model.n_clusters not in bins and hamsm_model.n_clusters + 1 not in bins
    # The carried model's entries equal the JAX model's
    got = _entries(carried)
    jax_model.update_cluster_structures(build_pcoord_cache=True)
    want = list(jrd.start_state_entries(jax_model, jax_model.pSS))
    assert [e[:2] for e in got] == [e[:2] for e in want]
    np.testing.assert_allclose([e[2] for e in got], [e[2] for e in want], **TOL)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a[3]), np.asarray(b[3]))


def _artifacts(d):
    lines = [ln.split() for ln in open(f"{d}/startstates.txt").read().strip().splitlines()]
    return (float(open(f"{d}/JtargetSS.txt").read()), np.loadtxt(f"{d}/pSS.txt"),
            [(ln[0], ln[2]) for ln in lines], np.array([float(ln[1]) for ln in lines]))


def test_write_restart_artifacts(hamsm_model, carried, jax_model, tmp_path):
    hamsm_model.update_cluster_structures(build_pcoord_cache=True)
    restart_dir = str(tmp_path / "restart0")
    sstates = write_restart_artifacts(hamsm_model, restart_dir, store_h5=True)
    J, pss, refs, weights = _artifacts(restart_dir)
    assert J == hamsm_model.JtargetSS and np.allclose(pss, hamsm_model.pSS)
    assert sstates == f"{restart_dir}/startstates.txt" and refs
    assert all(lab.startswith("b") and "_s" in lab and ref.startswith("hdf:")
               for lab, ref in refs)
    assert (weights > 0).all()
    # hamsm.obj holds CPU state and reads back on the device asked for
    with open(f"{restart_dir}/hamsm.obj", "rb") as f:
        assert np.allclose(pickle.load(f).pSS, hamsm_model.pSS)
    restored = modelWE.load(f"{restart_dir}/hamsm.obj", device="cpu")
    np.testing.assert_array_equal(restored.pSS, hamsm_model.pSS)
    # The carried model's artifacts equal the JAX model's
    for model, write, d in ((carried, write_restart_artifacts, "port"),
                            (jax_model, jrd.write_restart_artifacts, "jax")):
        model.update_cluster_structures(build_pcoord_cache=True)
        write(model, str(tmp_path / d), store_h5=True)
    got, want = _artifacts(tmp_path / "port"), _artifacts(tmp_path / "jax")
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[3], want[3], **TOL)


def _extended_coords(model, n):
    feats = model._featurize_all()
    return np.concatenate([feats["pcoord1"][:n], feats["child"][:n]],
                          axis=1).astype(np.float32)


def test_compute_optimized_bins(hamsm_model, carried, jax_model):
    mapper = compute_optimized_bins_for_model(hamsm_model, n_active_bins=8)
    out = mapper.assign(_extended_coords(hamsm_model, 16))
    assert out.shape == (16,) and (out >= 0).all() and (out < 8).all()
    assert mapper.clusterer.strat.device.type == "cpu"
    # The carried model's microstate table and assignments equal JAX's. The
    # default strategy calls sklearn's KMeans unseeded (as the reference
    # does), so the parity check seeds the same clustered-MFPT strategy
    from msm_we_tpu import optimization as jopt
    from msm_we_tpu_torch import optimization as opt

    def seeded(module):
        def strategy(model):
            disc, var = module.solve_discrepancy(model.Tmatrix, model.pSS, model.indTargets)
            return module.get_clustered_mfpt_bins(var, disc, model.pSS, 8, seed=1)
        return strategy

    got = compute_optimized_bins_for_model(carried, n_active_bins=8,
                                           binning_strategy=seeded(opt))
    want = jod.compute_optimized_bins_for_model(jax_model, n_active_bins=8,
                                                binning_strategy=seeded(jopt))
    np.testing.assert_array_equal(got.microstate_mapper, want.microstate_mapper)
    coords = _extended_coords(carried, 400)
    np.testing.assert_array_equal(got.assign(coords), want.assign(coords))


def test_compute_new_pcoord_map(hamsm_model, carried, jax_model):
    rng = np.random.default_rng(0)
    coord_map = {i: rng.normal(size=(4, 3)) for i in range(10)}
    pcoord_map = compute_new_pcoord_map(hamsm_model, coord_map,
                                        lambda s: np.array([float(s)]))
    assert set(pcoord_map) == set(range(10))
    assert pcoord_map[3].shape == (1 + hamsm_model.ndim,) and pcoord_map[3][0] == 3.0
    got = compute_new_pcoord_map(carried, coord_map, lambda s: np.array([float(s)]),
                                 batch_size=3)
    want = jod.compute_new_pcoord_map(jax_model, coord_map, lambda s: np.array([float(s)]))
    for s in coord_map:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-5, atol=1e-6)


def test_hamsm_config_device_pipeline(west_h5, hamsm_model):
    """``device_pipeline``/``show_live_display`` flow through to
    ``build_analyze_model``; the result matches the host-route build."""
    model = build_hamsm_from_config(
        _config("plugin_dp", RectilinearBinMapper, device="cpu", device_pipeline=True),
        [west_h5])
    assert model._mesh is not None and model.device_pipeline
    assert model.JtargetSS == pytest.approx(hamsm_model.JtargetSS, rel=1e-6)


def test_optimized_bin_mapper_rejects_single_positional():
    from msm_we_tpu_torch.optimization import OptimizedBinMapper

    with pytest.raises(TypeError, match="bytestring"):
        OptimizedBinMapper(b"deadbeef")


def _fake_func_bin_mapper(monkeypatch):
    captured = {}

    class FakeFuncBinMapper:
        def __init__(self, func, nbins, args=None, kwargs=None):
            captured.update(func=func, nbins=nbins, args=args or ())

    binning_mod = types.ModuleType("westpa.core.binning")
    binning_mod.FuncBinMapper = FakeFuncBinMapper
    core_mod = types.ModuleType("westpa.core")
    core_mod.binning = binning_mod
    westpa_mod = types.ModuleType("westpa")
    westpa_mod.core = core_mod
    monkeypatch.setitem(sys.modules, "westpa", westpa_mod)
    monkeypatch.setitem(sys.modules, "westpa.core", core_mod)
    monkeypatch.setitem(sys.modules, "westpa.core.binning", binning_mod)
    return captured


def test_wrap_for_westpa_funcbinmapper(monkeypatch, hamsm_model):
    """The WESTPA-facing mapper is a FuncBinMapper over ``assign`` with the
    (coords, mask, output) contract; its args carry the workers' device
    through a plain pickle round trip, and the unpickled bank assigns
    there."""
    captured = _fake_func_bin_mapper(monkeypatch)

    class FakeMapper:
        nbins = 5
        clusterer = SimpleNamespace(strat=SimpleNamespace(device=torch.device("cpu")))

        def assign(self, coords):
            return np.full(len(coords), 3)

    _wrap_for_westpa(FakeMapper(), device="cpu")
    assert captured["nbins"] == 5 and captured["args"][1] == "cpu"
    output = np.zeros(4, int)
    captured["func"](np.zeros((4, 2)), np.array([True, False, True, True]), output,
                     *captured["args"])
    assert output.tolist() == [3, 0, 3, 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _wrap_for_westpa(FakeMapper())  # the default is the card

    mapper = compute_optimized_bins_for_model(hamsm_model, n_active_bins=8)
    _wrap_for_westpa(mapper, device="cpu")
    func, args = captured["func"], pickle.loads(pickle.dumps(captured["args"]))
    restored, device = args
    assert device == "cpu" and restored.clusterer.strat.device.type == "cpu"
    # A bank found on another device is moved to the carried one first
    restored.clusterer.strat.device = torch.device("meta")
    coords = _extended_coords(hamsm_model, 64)
    mask = np.ones(len(coords), bool)
    mask[::7] = False
    output = np.full(len(coords), -1)
    func(coords, mask, output, *args)
    assert restored.clusterer.strat.device.type == "cpu"
    np.testing.assert_array_equal(output[mask], mapper.assign(coords[mask]))
    assert (output[~mask] == -1).all()
    _optimized_assign(coords, mask, output, restored, device="cpu")


def test_pcoord1d_flux_empty_range_raises(west_h5):
    from msm_we_tpu_torch.extended import ExtendedModelWE

    model = ExtendedModelWE(device="cpu")
    model.initialize([west_h5], REF, "ext", basis_pcoord_bounds=[[9.0, 10.0]],
                     target_pcoord_bounds=[[0.0, 1.0]], dim_reduce_method="none",
                     tau=1.0)
    model.get_iterations()
    with pytest.raises(ValueError, match="last_iter > first_iter"):
        model.get_pcoord1D_fluxMatrix(0, 5, 5, np.linspace(0, 10, 5))


def test_start_state_weights_use_sorted_pss(hamsm_model):
    """Per-cluster start-state weight equals the pcoord-sorted pSS entry of
    that cluster (``cluster_structures`` is keyed by raw ids)."""
    hamsm_model.update_cluster_structures(build_pcoord_cache=True)
    sort_idx = np.asarray(hamsm_model.pcoord_sort_indices)
    assert not np.array_equal(sort_idx, np.arange(hamsm_model.nBins))
    inv = np.empty(hamsm_model.nBins, dtype=int)
    inv[sort_idx] = np.arange(hamsm_model.nBins)
    per_bin = {}
    for b, _s, w, _x in start_state_entries(hamsm_model, hamsm_model.pSS):
        per_bin[b] = per_bin.get(b, 0.0) + w
    assert per_bin
    for b, w in per_bin.items():
        np.testing.assert_allclose(w, hamsm_model.pSS[inv[b]], rtol=1e-9)


# ------------------------------------------------- the restart driver cycle


class FakeRC:
    def __init__(self, config):
        self.config = config
        self.propagator = SimpleNamespace(get_pcoord=lambda state: None)
        self.sim_manager = None

    def pstatus(self, *args, **kwargs):
        pass


class FakeConfig:
    def __init__(self, values):
        self.values = values

    def get(self, keys, default=None):
        return self.values.get(tuple(keys), default)


class FakeDataManager:
    def __init__(self, h5file):
        self.we_h5filename = h5file
        self.store_h5 = True
        self.hamsm_model = None

    def finalize_run(self):
        pass

    def close_backing(self):
        pass

    def get_basis_states(self, n_iter):
        return [SimpleNamespace(label="b0", probability=0.5, auxref="bstate.pdb")]

    def get_target_states(self, n_iter):
        return [SimpleNamespace(label="t0", pcoord=[0.5])]


class FakeSimManager:
    def __init__(self, data_manager, max_iters):
        self.data_manager = data_manager
        self.work_manager = SimpleNamespace(is_master=True)
        self.n_iter = max_iters + 1  # finalize_run: iter already incremented
        self.max_total_iterations = max_iters
        self.current_iter_bstates = [
            SimpleNamespace(label="b0", probability=0.5, auxref="bstate.pdb")
        ]
        self._callback_table = defaultdict(set)
        self.finalize_run = object()
        self.post_propagation = object()

    def register_callback(self, hook, cb, priority):
        self._callback_table[hook].add((priority, cb.__name__, cb))


def _we_dir(path):
    """A prepared WE directory (west.h5 at 25 x 16, seed 23)."""
    os.makedirs(path / "traj_segs")
    os.makedirs(path / "seg_logs")
    generate_west_h5(str(path / "west.h5"), n_iterations=25, n_segments=16, seed=23)
    with open(path / "restart_initialization.json", "w") as fp:
        json.dump({"bstate_file": "b.txt", "tstate_file": "t.txt",
                   "segs_per_state": 1}, fp)


@pytest.fixture
def fake_westpa(monkeypatch, tmp_path):
    """Mock westpa modules, and chdir into a prepared WE directory."""
    calls = {"w_init": [], "w_run": 0}
    westpa = types.ModuleType("westpa")
    westpa.rc = FakeRC(FakeConfig({("west", "propagation", "max_total_iterations"): 25}))
    cli = types.ModuleType("westpa.cli")
    core = types.ModuleType("westpa.cli.core")
    w_init = types.ModuleType("westpa.cli.core.w_init")
    w_run = types.ModuleType("westpa.cli.core.w_run")
    w_init.initialize = lambda **kwargs: calls["w_init"].append(kwargs)

    def run_simulation():
        calls["w_run"] += 1

    w_run.run_simulation = run_simulation
    core.w_init, core.w_run = w_init, w_run
    for name, mod in [("westpa", westpa), ("westpa.cli", cli), ("westpa.cli.core", core),
                      ("westpa.cli.core.w_init", w_init), ("westpa.cli.core.w_run", w_run)]:
        monkeypatch.setitem(sys.modules, name, mod)
    work = tmp_path / "port"
    _we_dir(work)
    monkeypatch.chdir(work)
    return dict(calls=calls, westpa=westpa, dir=work)


def _driver_config(base_path, **extra):
    return {
        "n_restarts": 2, "n_runs": 1, "extension_iters": 0,
        "model_name": "restart_test", "n_clusters": 2, "tau": 1.0,
        "basis_pcoord_bounds": [[9.0, 10.0]], "target_pcoord_bounds": [[0.0, 1.0]],
        "dimreduce_method": "pca", "cross_validation_groups": 0, "ref_pdb_file": REF,
        "base_path": str(base_path), "show_live_display": False, **extra,
    }


def _run_restart(module, fake_westpa, mapper_cls, **extra):
    dm = FakeDataManager("west.h5")
    sm = FakeSimManager(dm, max_iters=25)
    fake_westpa["westpa"].rc.sim_manager = sm
    driver = module.RestartDriver(sm, _driver_config(
        os.getcwd(), user_bin_mapper=mapper_cls([EDGES]), **extra))
    driver.prepare_new_we()
    return driver


def test_restart_driver_full_cycle(fake_westpa, monkeypatch):
    from msm_we_tpu_torch.westpa_plugins import restart_driver

    driver = _run_restart(restart_driver, fake_westpa, RectilinearBinMapper, device="cpu")
    assert os.path.exists("restart0/run1/west.h5")
    assert json.load(open("restart.dat")) == {"restarts_completed": 1, "runs_completed": 0}
    model = driver.model
    assert model is not None and model.device.type == "cpu" and model.JtargetSS > 0
    J, pss, refs, weights = _artifacts("restart0")
    assert J == model.JtargetSS and np.allclose(pss, model.pSS)
    assert refs and all(lab.startswith("b") and "_s" in lab and ref.startswith("hdf:")
                        for lab, ref in refs)
    assert np.isclose(weights.sum(), model.pSS[: model.n_clusters].sum(), rtol=1e-6)
    blines = open("restart0/basisstates.txt").read().strip().splitlines()
    assert float(blines[0].split()[1]) == pytest.approx(0.5 * 1e-10)
    assert open("restart0/targetstates.txt").read().startswith("t0 0.5")
    for name in ("hamsm.obj", "flux_plot.pdf", "coarse_flux_profile.pdf",
                 "pseudocomm-flux_plot.pdf", "hamsm_vs_direct_flux_comparison_plot.pdf"):
        assert os.path.exists(f"restart0/{name}"), name
    restored = modelWE.load("restart0/hamsm.obj", device="cpu")
    np.testing.assert_array_equal(restored.pSS, model.pSS)
    calls = fake_westpa["calls"]
    assert len(calls["w_init"]) == 1 and calls["w_run"] == 1
    assert calls["w_init"][0]["sstate_file"].endswith("startstates.txt")
    assert os.path.exists("restart0/restart_initialization.json")
    assert json.load(open("restart_initialization.json"))["sstate_file"].endswith(
        "startstates.txt")
    # The JAX driver's cycle in a copy of the directory writes the same
    # artifacts (the hdf: references differ only by the directory)
    jdir = fake_westpa["dir"].parent / "jax"
    _we_dir(jdir)
    monkeypatch.chdir(jdir)
    _run_restart(jrd, fake_westpa, JaxMapper)
    got, want = _artifacts(fake_westpa["dir"] / "restart0"), _artifacts(jdir / "restart0")
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert [(a, b.replace(str(fake_westpa["dir"]), "")) for a, b in got[2]] == \
        [(a, b.replace(str(jdir), "")) for a, b in want[2]]
    np.testing.assert_allclose(got[3], want[3], **TOL)


def test_restart_driver_mid_marathon_run(fake_westpa):
    """With n_runs=3, finishing run 1 archives it, re-inits from the
    initialization JSON and relaunches, without building an haMSM."""
    from msm_we_tpu_torch.westpa_plugins import restart_driver

    driver = _run_restart(restart_driver, fake_westpa, RectilinearBinMapper,
                          device="cpu", n_runs=3)
    assert json.load(open("restart.dat")) == {"restarts_completed": 0, "runs_completed": 1}
    assert os.path.exists("restart0/run1/west.h5")
    calls = fake_westpa["calls"]
    assert len(calls["w_init"]) == 1 and calls["w_init"][0]["bstate_file"] == "b.txt"
    assert calls["w_run"] == 1 and driver.model is None


def test_restart_driver_extension_when_target_unreached(fake_westpa):
    """No recycling events and extension_iters > 0: extension mode (lock
    file, runs reset, data re-linked, run continued, no re-init)."""
    from msm_we_tpu_torch.westpa_plugins import restart_driver

    with h5py.File("west.h5", "a") as h5:
        for key in h5["iterations"]:
            seg_index = h5[f"iterations/{key}/seg_index"]
            data = seg_index[:]
            data["endpoint_type"] = 1
            seg_index[...] = data
    with open("west.cfg", "w") as fp:
        fp.write("west:\n  propagation:\n    max_total_iterations: 25\n")
    dm = FakeDataManager("west.h5")
    dm.open_backing = lambda: None
    sm = FakeSimManager(dm, max_iters=25)
    fake_westpa["westpa"].rc.sim_manager = sm
    driver = restart_driver.RestartDriver(sm, _driver_config(
        os.getcwd(), extension_iters=10, device="cpu"))
    driver.prepare_new_we()
    assert os.path.exists(restart_driver.EXTENSION_LOCKFILE)
    assert json.load(open("restart.dat")) == {"restarts_completed": 0, "runs_completed": 0}
    assert os.path.islink("traj_segs")
    assert "max_total_iterations: 35" in open("west.cfg").read()
    assert fake_westpa["westpa"].rc.sim_manager.max_total_iterations == 35
    assert fake_westpa["calls"]["w_run"] == 1 and fake_westpa["calls"]["w_init"] == []


def test_restart_driver_skips_mid_run(fake_westpa):
    from msm_we_tpu_torch.westpa_plugins import restart_driver

    dm = FakeDataManager("west.h5")
    sm = FakeSimManager(dm, max_iters=25)
    sm.n_iter = 10  # mid-run
    fake_westpa["westpa"].rc.sim_manager = sm
    restart_driver.RestartDriver(sm, _driver_config(os.getcwd(), device="cpu")).prepare_new_we()
    assert not os.path.exists("restart.dat")
    assert fake_westpa["calls"]["w_run"] == 0


# --------------------------------------------- the optimization driver cycle


@pytest.fixture
def fake_opt_westpa(monkeypatch, tmp_path, hamsm_model):
    westpa = types.ModuleType("westpa")

    class OptConfig:
        def get(self, keys, default=None):
            return {("west", "system", "system_options", "pcoord_ndim"): 1,
                    ("west", "propagation", "max_total_iterations"): 10}.get(
                tuple(keys), default)

    we_driver = SimpleNamespace(bin_target_counts=np.full(8, 4), bin_mapper=None)
    rng = np.random.default_rng(0)
    coord_map = {i: rng.normal(size=(4, 3)) for i in range(12)}
    coord_map_path = tmp_path / "coord_map.pkl"
    with open(coord_map_path, "wb") as fp:
        pickle.dump(coord_map, fp)
    propagator = SimpleNamespace(
        synd_model=SimpleNamespace(backmap=lambda s: np.array([float(s), 99.0])))
    westpa.rc = SimpleNamespace(
        pstatus=lambda *a, **k: None, config=OptConfig(),
        get_we_driver=lambda: we_driver, get_propagator=lambda: propagator)
    monkeypatch.setitem(sys.modules, "westpa", westpa)
    data_manager = SimpleNamespace(hamsm_model=hamsm_model, processCoordinates=None)
    sim_manager = SimpleNamespace(
        data_manager=data_manager, work_manager=SimpleNamespace(is_master=True),
        max_total_iterations=25, register_callback=lambda hook, cb, p: None,
        finalize_run=object())
    return dict(sim_manager=sim_manager, we_driver=we_driver,
                coord_map_path=str(coord_map_path), coord_map=coord_map)


def test_optimization_driver_bins_and_pcoord_map(fake_opt_westpa, hamsm_model):
    from msm_we_tpu_torch.westpa_plugins.optimization_driver import OptimizationDriver

    driver = OptimizationDriver(
        fake_opt_westpa["sim_manager"],
        {"full_coord_map": fake_opt_westpa["coord_map_path"], "max_iters": 100,
         "device": "cpu"})
    assert driver.device == "cpu"
    mapper = driver.compute_optimized_bins()
    out = mapper.assign(_extended_coords(hamsm_model, 12))
    assert (out >= 0).all() and (out < 8).all()
    alloc = driver.compute_optimized_allocation()
    assert np.array_equal(alloc, fake_opt_westpa["we_driver"].bin_target_counts)
    pcoord_map = driver.compute_new_pcoord_map()
    assert set(pcoord_map) == set(fake_opt_westpa["coord_map"])
    assert pcoord_map[5].shape == (1 + hamsm_model.ndim,) and pcoord_map[5][0] == 5.0
    bins = driver.default_bin_optimizer(hamsm_model)
    assert bins.shape == (hamsm_model.nBins,) and not np.isnan(bins).any()
    assert set(np.unique(bins)) <= set(range(6))


def test_custom_binning_strategy(fake_opt_westpa, hamsm_model):
    def halves(model):
        n = model.n_clusters
        return np.array([0] * (n // 2) + [1] * (n - n // 2))

    mapper = compute_optimized_bins_for_model(hamsm_model, n_active_bins=8,
                                              binning_strategy=halves)
    assert set(np.unique(list(mapper.microstate_mapper))) <= {0, 1, 6, 7}


def test_optimization_driver_wraps_the_mapper_for_its_device(fake_opt_westpa, monkeypatch):
    """``do_optimization`` hands WESTPA a FuncBinMapper whose args carry the
    config's device, then continues WE."""
    from msm_we_tpu_torch.westpa_plugins.optimization_driver import OptimizationDriver

    rc = sys.modules["westpa"].rc
    captured = _fake_func_bin_mapper(monkeypatch)
    westpa = sys.modules["westpa"]
    westpa.rc = rc
    runs = []
    w_run = types.ModuleType("westpa.cli.core.w_run")
    w_run.run_simulation = lambda: runs.append(1)
    for name in ("westpa.cli", "westpa.cli.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    sys.modules["westpa.cli.core"].w_run = w_run
    monkeypatch.setitem(sys.modules, "westpa.cli.core.w_run", w_run)
    driver = OptimizationDriver(
        fake_opt_westpa["sim_manager"],
        {"full_coord_map": fake_opt_westpa["coord_map_path"], "max_iters": 100,
         "device": "cpu"})
    monkeypatch.setattr(driver, "compute_new_pcoord_map", lambda: {})
    monkeypatch.setattr(driver, "update_westpa_pcoord", lambda m: None)
    driver.do_optimization()
    assert captured["args"][1] == "cpu" and captured["nbins"] == 8
    assert runs == [1]
    assert fake_opt_westpa["sim_manager"].max_total_iterations == 35
