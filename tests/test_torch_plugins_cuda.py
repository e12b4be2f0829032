"""The extended analysis and the WESTPA drivers on the card against the CPU
at 30 x 200 segments. JAX-free, so they also run on a GPU machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_plugins_cuda.py

Each skips without a GPU. Tolerances: cluster ids equal card vs CPU except
at near-ties; where the dtrajs are equal, everything after them is host
float64, so h, kh and the driver's JtargetSS agree to 1e-12 relative.
"""
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.extended import ExtendedModelWE
from msm_we_tpu_torch.ops import stratified_assign as sa
from msm_we_tpu_torch.testing import near_tie_rows

EDGES = np.linspace(0, 10, 13)
REF = {"coords": None, "nAtoms": 4, "coord_ndim": 3}


@pytest.fixture(scope="module")
def arrays():
    return generate_we_arrays(n_iterations=30, n_segments=200, seed=17)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _extended(arrays, device):
    model = ExtendedModelWE(device=device)
    model.build_analyze_model(
        file_paths=ArrayWEDataset(arrays), ref_struct=REF, modelName="ext_cuda",
        basis_pcoord_bounds=[[9.0, 10.0]], target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca", tau=1.0, n_clusters=5, show_live_display=False,
        step_kwargs={"clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES])}})
    model.get_hflux(conv=1e-3, max_iters=2000)
    model.get_model_aristoffian()
    return model


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-300))


@pytest.mark.cuda
def test_extended_on_the_card_matches_the_cpu(cuda_device, arrays):
    g, c = _extended(arrays, "cuda"), _extended(arrays, "cpu")
    flips = int((np.concatenate(g.dtrajs) != np.concatenate(c.dtrajs)).sum())
    assert flips <= 1e-3 * sum(len(d) for d in c.dtrajs)
    if not flips:
        for name in ("h", "kh", "varh"):
            assert _rel(getattr(g, name), getattr(c, name)) <= 1e-12, name
    for method in ("adaptive", "uniform", "log_uniform"):
        for m in (g, c):
            m.binMethod, m.nB, m.nW = method, 6, 60
            m.get_model_steady_state_aristoffian()
            assert np.isclose(m.alloc.sum(), 1.0) and m.binObjective >= 0
        if method != "adaptive" and not flips:
            assert _rel(g.binObjective, c.binObjective) <= 1e-12
    it = g.maxIter
    kh_g, kh_c = g.get_iter_aristoffian(it), c.get_iter_aristoffian(it)
    assert kh_g.shape == kh_c.shape == (g.nSeg, 1)
    if not flips:
        assert _rel(kh_g, kh_c) <= 1e-12
    for m in (g, c):
        prob = m.evolve_probability(500, 50)
        assert np.abs(prob.sum(axis=1) - 1.0).max() <= 1e-8


@pytest.mark.cuda
def test_extended_device_work_launches_h4(cuda_device, arrays):
    """The adaptive kh bins run k-means on the card, and a batch of
    ``HOST_BATCH_THRESHOLD`` rows or more of ``_model_cluster_assign``
    predicts through H4."""
    g = _extended(arrays, "cuda")
    sa.reset_launch_counts()
    g.binMethod, g.nB = "adaptive", 6
    g._kh_bin_centers(6)
    assert sa.launch_counts()["pair_assign"] > 0
    parent, child, _w = g._dataset.iter_coord_pairs(g.maxIter)
    g.load_iter_data(g.maxIter)
    reps = -(-5000 // len(child))
    coords = np.concatenate([child] * reps)
    pcoords = np.concatenate([g.pcoord1List] * reps)
    sa.reset_launch_counts()
    ids = g._model_cluster_assign(coords, pcoords)
    assert sa.launch_counts()["pair_assign"] > 0 and ids.shape == (len(coords),)
    # H4's ids against the host family's, equal except at near-ties
    strat = g._strat
    feats = g.reduceCoordinates(np.nan_to_num(coords)).astype(np.float32)
    eff = strat.we_remap[g._bin_mapper.assign(np.nan_to_num(pcoords))]
    on_card = strat.global_id[strat.assign_flat(feats, eff, False)]
    on_host = strat.global_id[strat.assign_flat(feats, eff, True)]
    bad = np.flatnonzero(on_card != on_host)
    assert near_tie_rows(bad, on_card, on_host, feats, eff, *strat.compact_bank()).all()


def _driver(arrays, device):
    from msm_we_tpu_torch.westpa_plugins.hamsm_driver import build_hamsm_from_config

    return build_hamsm_from_config(dict(
        model_name="drv_cuda", n_clusters=5, tau=1.0, basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", ref_pdb_file=REF,
        user_bin_mapper=RectilinearBinMapper([EDGES]), show_live_display=False,
        device=device), ArrayWEDataset(arrays))


@pytest.mark.cuda
def test_drivers_on_the_card_match_the_cpu(cuda_device, arrays, tmp_path):
    from msm_we_tpu_torch.westpa_plugins.optimization_driver import (
        _wrap_for_westpa,
        compute_new_pcoord_map,
        compute_optimized_bins_for_model,
    )
    from msm_we_tpu_torch.westpa_plugins.restart_driver import (
        start_state_entries,
        write_restart_artifacts,
    )

    g, c = _driver(arrays, "cuda"), _driver(arrays, "cpu")
    assert g.device.type == "cuda" and c.device.type == "cpu"
    flips = int((np.concatenate(g.dtrajs) != np.concatenate(c.dtrajs)).sum())
    assert flips <= 1e-3 * sum(len(d) for d in c.dtrajs)
    if not flips:
        assert _rel(g.JtargetSS, c.JtargetSS) <= 1e-12
    g.update_cluster_structures(build_pcoord_cache=True)
    entries = list(start_state_entries(g, g.pSS))
    total = sum(w for _b, _s, w, _x in entries)
    assert np.isclose(total, g.pSS[: g.n_clusters].sum(), rtol=1e-6)
    write_restart_artifacts(g, str(tmp_path / "restart0"), store_h5=True)
    restored = modelWE.load(str(tmp_path / "restart0" / "hamsm.obj"), device="cuda")
    assert restored.device.type == "cuda"
    np.testing.assert_array_equal(restored.pSS, g.pSS)

    mapper = compute_optimized_bins_for_model(g, n_active_bins=8)
    feats = g._featurize_all()
    coords = np.column_stack([feats["pcoord1"], feats["child"]]).astype(np.float32)
    sa.reset_launch_counts()
    live = mapper.assign(coords)
    assert sa.launch_counts()["pair_assign"] > 0
    captured = {}

    class FuncBinMapper:
        def __init__(self, func, nbins, args=None, kwargs=None):
            captured.update(func=func, args=tuple(args))

    binning = types.ModuleType("westpa.core.binning")
    binning.FuncBinMapper = FuncBinMapper
    saved = {n: sys.modules.get(n) for n in ("westpa", "westpa.core", "westpa.core.binning")}
    sys.modules.update({"westpa": types.ModuleType("westpa"),
                        "westpa.core": types.ModuleType("westpa.core"),
                        "westpa.core.binning": binning})
    try:
        _wrap_for_westpa(mapper)
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
    args = pickle.loads(pickle.dumps(captured["args"]))
    assert args[1] == "cuda" and args[0].clusterer.strat.device.type == "cpu"
    output = np.full(len(coords), -1)
    sa.reset_launch_counts()
    captured["func"](coords, np.ones(len(coords), bool), output, *args)
    assert sa.launch_counts()["pair_assign"] > 0
    assert args[0].clusterer.strat.device.type == "cuda"
    np.testing.assert_array_equal(output, live)
    rng = np.random.default_rng(3)
    pmap = compute_new_pcoord_map(g, {i: rng.normal(size=(4, 3)) for i in range(50)},
                                  lambda s: np.array([float(s)]))
    assert pmap[7].shape == (1 + g.ndim,) and pmap[7][0] == 7.0
    assert os.path.exists(tmp_path / "restart0" / "startstates.txt")
