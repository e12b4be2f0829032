"""The WESTPA plugin's build binned wide (the benchmark configuration
``westpa_bins128``: 128 WE bins x 25 clusters a bin, 3,202 states before
cleaning) through the port's normal path on the CPU, at 21 iterations x
1,000 segments of the configuration's own synthetic run: the run fills the
bins, the port's build equals the JAX package's on the same run (ids,
flux, steady state and target flux of the model and its validation
groups), and its streaming clustering takes the path that ``westpa_default``'s
10 bins never take: fill batches that gather several iterations, and bins
remapped when the data runs out.
"""
import json
import os

import numpy as np
import pytest
import torch

import msm_we_tpu.data.synthetic as jax_synthetic
from msm_we_tpu.binning import RectilinearBinMapper as JaxMapper
from msm_we_tpu.model import modelWE as JaxModelWE
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE, tracing
from benchmark.traffic.we_run import generate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        return json.load(fh)


CONFIG = _config("westpa_bins128")
N_ITER, N_SEG, SEED = 21, 1000, 2**31 + 22


def _arguments(mapper, config=CONFIG):
    """``build_analyze_model``'s arguments as the plugin passes the
    configuration's settings (``benchmark/drivers/build.py``)."""
    b = config["build"]
    first = b["first_analysis_iter"]
    return dict(
        ref_struct={"coords": None, "nAtoms": config["synthetic"]["n_atoms"],
                    "coord_ndim": 3},
        modelName=b["model_name"], basis_pcoord_bounds=b["basis_pcoord_bounds"],
        target_pcoord_bounds=b["target_pcoord_bounds"],
        dimreduce_method=b["dimreduce_method"], n_clusters=b["n_clusters"], tau=b["tau"],
        step_kwargs={
            "dimReduce": {"use_weights": b["use_weights"],
                          "variance_cutoff": b["variance_cutoff"], "first_iter": first},
            "clustering": {"first_cluster_iter": first,
                           "user_bin_mapper": mapper([np.asarray(b["we_bin_edges"])])},
        },
        fluxmatrix_iters=[first, -1],
        allow_validation_failure=b["allow_validation_failure"],
        cross_validation_groups=b["cross_validation_groups"],
        cross_validation_blocks=b["cross_validation_blocks"],
        device_pipeline=b["device_pipeline"], show_live_display=False)


def _run(config):
    s = config["synthetic"]
    return generate(N_ITER, N_SEG, SEED, warmup=s["warmup"], n_atoms=s["n_atoms"],
                    pcoord_len=s["pcoord_len"], target_bounds=tuple(s["target_bounds"]),
                    basis_bounds=tuple(s["basis_bounds"]), x_min=s["x_min"],
                    x_max=s["x_max"], dt=s["dt"], noise=s["noise"],
                    barrier=s["barrier"], n_we_bins=s["n_we_bins"])


@pytest.fixture(scope="module")
def run():
    return _run(CONFIG)


@pytest.fixture(scope="module")
def built(run):
    with tracing.collect() as col:
        m = modelWE(device="cpu")
        m.build_analyze_model(file_paths=ArrayWEDataset(run),
                              **_arguments(RectilinearBinMapper))
    return m, col


def test_the_run_fills_the_bins(run):
    edges = np.asarray(CONFIG["build"]["we_bin_edges"])
    assert len(edges) == 129 and CONFIG["synthetic"]["n_we_bins"] == 128
    child = np.concatenate([d["pcoords"][:, -1, 0] for d in run[1:-1]])
    filled = np.bincount(np.clip(np.digitize(child, edges) - 1, 0, 127), minlength=128)
    assert (filled > 0).sum() >= 120


def test_the_wide_build_matches_jax(run, built, tmp_path, monkeypatch):
    m, _col = built
    monkeypatch.setattr(jax_synthetic, "generate_trajectory_arrays", lambda _s: run)
    path = jax_synthetic.generate_west_h5(
        str(tmp_path / "west.h5"), settings=jax_synthetic.SynthWESettings())
    j = JaxModelWE()
    j.build_analyze_model(file_paths=[path], **_arguments(JaxMapper))
    assert m.fluxMatrixRaw.shape[0] == j.fluxMatrixRaw.shape[0] > 3000
    for port, ref in [(m, j)] + list(zip(m.validation_models, j.validation_models)):
        np.testing.assert_array_equal(np.concatenate(port.dtrajs),
                                      np.concatenate(ref.dtrajs))
        np.testing.assert_allclose(port.fluxMatrix, ref.fluxMatrix, rtol=1e-12)
        np.testing.assert_allclose(port.pSS, ref.pSS, rtol=1e-8, atol=1e-15)
        assert port.JtargetSS == pytest.approx(ref.JtargetSS, rel=1e-8)
    assert len(m.validation_models) == CONFIG["build"]["cross_validation_groups"]


def test_the_wide_fold_gathers_iterations_and_remaps_bins(built):
    """At ~8 walkers a bin an iteration a bin needs several iterations to
    reach its 25 rows, and bins still short when the data runs out are
    remapped; at 10 bins (``westpa_default``, ~90 walkers a bin) every
    iteration fills the bins it reaches, one batch an iteration."""
    _m, col = built
    assert col.counts["fold_gathered_iterations"] >= N_ITER // 2
    assert col.counts["fold_remapped_bins"] > 0
    base = _config("westpa_default")
    with tracing.collect() as narrow:
        m = modelWE(device="cpu")
        m.build_analyze_model(file_paths=ArrayWEDataset(_run(base)),
                              **_arguments(RectilinearBinMapper, base))
    assert narrow.counts["fold_gathered_iterations"] == 0
    assert narrow.counts["fold_remapped_bins"] == 0
