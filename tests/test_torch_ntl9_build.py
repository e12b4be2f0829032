"""The WESTPA plugin's build at NTL9 widths (the benchmark configuration
``westpa_ntl9``) on the CPU: the configuration is ``westpa_default``'s but
its widths, its run is ``westpa_default``'s WE run bitwise with 900-wide
coordinates that keep WE continuity and carry ~30 PCA components at the
plugin's 0.95 cutoff; a fitted PCA transform decides its projection route
once; and the build's spans ``reduce_moments`` and ``project`` and counts
of parent rows record under ``collect()`` and nowhere else.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

from benchmark.reference.build import _pca
from benchmark.traffic.we_run import generate
from benchmark.traffic.we_run_wide import generate as generate_wide, loading
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE, tracing
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.ops import pca as pca_mod

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 24


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        return json.load(fh)


CONFIG = _config("westpa_ntl9")


def _synthetic(config):
    s = dict(config["synthetic"])
    s["target_bounds"], s["basis_bounds"] = tuple(s["target_bounds"]), tuple(s["basis_bounds"])
    return s


@pytest.fixture(scope="module")
def run():
    return generate_wide(21, 300, SEED, CONFIG["wide"], **_synthetic(CONFIG))


def test_the_configuration_is_westpa_default_at_ntl9_widths():
    base = _config("westpa_default")
    changed = {"name", "source", "deployment", "precision", "wide", "assumed"}
    assert set(CONFIG) == set(base) | {"wide"}
    for key in set(base) - changed - {"synthetic"}:
        assert CONFIG[key] == base[key], key
    assert CONFIG["synthetic"] == dict(base["synthetic"], n_atoms=300)
    assert CONFIG["reduced"] == [] and CONFIG["name"] == "westpa_ntl9"
    assert CONFIG["source"].endswith("msm_we/_hamsm/_dimensionality.py")
    assert CONFIG["assumed"][0].startswith("900 raw coordinates")
    assert "TF32 off" in CONFIG["precision"]
    with open(os.path.join(ROOT, "benchmark", "workloads", "westpa_ntl9.100k.json")) as fh:
        wl = json.load(fh)
    with open(os.path.join(ROOT, "benchmark", "workloads", "westpa_default.100k.json")) as fh:
        base_wl = json.load(fh)
    assert wl["config"] == "westpa_ntl9" and wl["driver"] == "build_wide"
    assert wl["traffic"] == base_wl["traffic"] and set(wl["checks"]) == set(base_wl["checks"])


def test_the_we_run_is_westpa_defaults_bitwise(run):
    s = _synthetic(CONFIG)
    base = generate(21, 300, SEED, **dict(s, n_atoms=4))
    assert len(run) == len(base)
    for wide, it in zip(run, base):
        for key in ("weights", "parent_ids", "pcoords", "recycled"):
            np.testing.assert_array_equal(wide[key], it[key])
        assert wide["coords"].shape == (len(it["weights"]), 2, 300, 3)


def test_a_parent_frame_is_its_parents_child_frame(run):
    fresh = 0
    for prev, it in zip(run, run[1:]):
        p = it["parent_ids"]
        kept = p >= 0
        np.testing.assert_array_equal(it["coords"][kept, 0], prev["coords"][p[kept], 1])
        # A walker without a recorded parent starts from a frame of its own
        fresh += int((~kept).sum())
        for i in np.flatnonzero(~kept):
            assert not (it["coords"][i, 0] == prev["coords"][:, 1]).all(axis=(1, 2)).any()
    assert fresh > 0
    assert ArrayWEDataset(run).check_continuity(last_iter=len(run) - 1)


def test_the_coordinates_carry_about_thirty_components(run):
    child = np.concatenate([d["coords"][:, 1].reshape(len(d["coords"]), -1)
                            for d in run[:-2]])
    _mean, comp = _pca(child, CONFIG["build"]["variance_cutoff"], np.float64)
    assert 28 <= len(comp) <= 32
    w = CONFIG["wide"]
    L = loading(w["n_modes"], 900, w["loading_seed"])
    np.testing.assert_allclose(L @ L.T, np.eye(w["n_modes"]), atol=1e-12)
    # The same molecule in every run; another seed draws other frames
    other = generate_wide(3, 50, SEED + 1, w, **_synthetic(CONFIG))
    assert not np.array_equal(other[0]["coords"], run[0]["coords"][:50])


def _model(d, F, device="cpu", far=False):
    rng = np.random.default_rng(d + F)
    comp = np.linalg.qr(rng.standard_normal((d, F)))[0].T
    mean = rng.normal(1e4 if far else 0.0, 1.0, d)
    return pca_mod.PCAModel(mean, comp, np.geomspace(4.0, 0.2, F), device=device)


@pytest.mark.parametrize("far", [False, True], ids=["folded", "centred"])
def test_narrow_features_are_the_host_product_as_before(far):
    """At 12 widths the route is host numpy for every call, and the features
    are bitwise the product the transform has always taken."""
    pca = _model(12, 2, far=far)
    assert pca.route == "host"
    rows = pca.mean_ + np.random.default_rng(5).normal(0, 2.0, (8192, 12))
    comp = pca.components_.T.astype(np.float32)
    if far:
        want = ((rows - pca.mean_).astype(np.float32)) @ comp
    else:
        want = rows.astype(np.float32) @ comp - (pca.mean_ @ pca.components_.T).astype(np.float32)
    np.testing.assert_array_equal(pca.transform(rows), want)
    np.testing.assert_array_equal(pca.transform(rows[:8]), want[:8])


@pytest.mark.parametrize("d,F,route", [(12, 2, "host"), (900, 2, "host"), (900, 30, "kernel"),
                                       (300, 10, "kernel")])
def test_the_route_is_chosen_once_from_width_and_device(monkeypatch, d, F, route):
    """On CUDA a transform of ``_KERNEL_MIN_ROW_FLOPS`` or more a row takes the
    features kernel for every call, whatever its rows; anything narrower, and
    every transform off CUDA, host numpy. (No card here: the device is taken
    as CUDA at the fit, the calls then run the kernel's wrapper on the CPU.)"""
    assert _model(d, F).route == "host"
    monkeypatch.setattr(pca_mod, "as_device", torch.device)
    pca = _model(d, F, device="cuda")
    assert pca.route == route
    calls = []

    def spy(raw_a, raw_b, proj):
        calls.append(len(raw_a))
        assert raw_b is None and raw_a.is_contiguous() and proj.is_contiguous()
        return raw_a @ proj, None

    monkeypatch.setattr(pca_mod, "transform_features", spy)
    pca.device = torch.device("cpu")
    rows = pca.mean_ + np.random.default_rng(6).normal(0, 1.0, (8192, d))
    for n in (8192, 8, 1):
        got = pca.transform(rows[:n])
        assert got.shape == (n, F) and got.dtype == np.float32
        np.testing.assert_allclose(got, (rows[:n] - pca.mean_) @ pca.components_.T,
                                   rtol=1e-4, atol=1e-3)
    assert calls == ([8192, 8, 1] if route == "kernel" else [])


def test_project_spans_only_where_something_listens():
    pca = _model(12, 2)
    rows = np.zeros((4, 12))
    pca.transform(rows)
    with tracing.collect() as col:
        pca.transform(rows)
        pca.transform(rows)
    assert list(col.spans) == ["project"] and len(col.spans["project"]) == 2


def _build(data, groups=0, dedup="auto"):
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=ArrayWEDataset(data),
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="ntl9", basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
        n_clusters=3, cross_validation_groups=groups, cross_validation_blocks=4,
        allow_validation_failure=True, show_live_display=False,
        dedup_coordinates=dedup,
        step_kwargs={"clustering": {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 11)])}},
    )
    return m


def _arrays():
    return generate_we_arrays(12, 32, seed=17)


def test_a_build_counts_its_parent_rows_under_collect():
    data = _arrays()
    plain = _build(data)
    with tracing.collect() as col:
        m = _build(data, groups=2)
    recorded = sum(int((d["parent_ids"] >= 0).sum()) for d in data[1:m.maxIter - 1])
    rows = len(m._features["child"])
    assert col.counts["parent_rows_gathered"] == recorded > 0
    assert col.counts["parent_rows_gathered"] + col.counts["parent_rows_projected"] == rows
    assert "dedup_fallback" not in col.counts
    assert len(col.spans["reduce_moments"]) == 1 and col.spans["reduce_moments"][0] > 0
    np.testing.assert_array_equal(m.pSS[: len(plain.pSS)], plain.pSS)
    # Without the gather every parent row is projected
    with tracing.collect() as col:
        _build(data, dedup=False)
    assert col.counts == {"parent_rows_projected": rows} | {
        k: v for k, v in col.counts.items() if k.startswith("fold_")}


def test_counts_record_nothing_without_collect(monkeypatch):
    """Outside a ``collect()`` block the build's counts find no collector."""
    from msm_we_tpu_torch import features

    seen = []
    monkeypatch.setattr(features, "count", lambda name, n=1: seen.append(
        (name, tracing.collector())) or tracing.count(name, n))
    _build(_arrays())
    assert {n for n, _c in seen} == {"parent_rows_gathered", "parent_rows_projected"}
    assert all(c is None for _n, c in seen)


def _batch_centred_rows(model, coords):
    """``reduceCoordinates`` with each call's rows centred on their mean."""
    out = np.asarray(model.coordinates.transform(model.processCoordinates(coords)))
    return out - out.mean(0)


@pytest.mark.parametrize("check", ["pre-flight", "sample"])
def test_a_fallback_is_counted_and_names_its_check(monkeypatch, caplog, check):
    from msm_we_tpu_torch import features

    data = _arrays()
    if check == "sample":
        # Continuity claimed but broken: frame 0 of every later segment moved
        for d in data[2:]:
            d["coords"][:, 0] += 1e-3
        monkeypatch.setattr(ArrayWEDataset, "check_continuity", lambda self, **_k: True)
    else:
        monkeypatch.setattr(modelWE, "reduceCoordinates", _batch_centred_rows)
    log = logging.getLogger("msm_we_tpu_torch")
    monkeypatch.setattr(log, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="msm_we_tpu_torch"):
        with tracing.collect() as col:
            m = _build(data)
    assert col.counts["dedup_fallback"] == 1 and "parent_rows_gathered" not in col.counts
    assert col.counts["parent_rows_projected"] == len(m._features["child"])
    assert any(f"at the {check}" in r.getMessage() for r in caplog.records)
    assert features.featurize_dedup(m, verify=True) is None
