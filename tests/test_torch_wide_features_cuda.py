"""The PCA projection at NTL9 widths on the card (D = 900 raw coordinates,
F = 30 components): ``PCAModel`` takes the features kernel
(``ops.stratified_assign.transform_features``), whose features of a row
are bitwise the same whatever rows share the call, so a build's gathered
parent features (``features.featurize_dedup``) pass their bitwise checks
and are kept. Imports no JAX; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_wide_features_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark.traffic.we_run_wide import generate
from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE, tracing
from msm_we_tpu_torch.ops.pca import PCAModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, F = 900, 30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pca(device, seed=0):
    """A fitted transform at D x F: orthonormal components, a mean near
    the origin (the centering folded into the offset) or far from it (the
    rows centred in f64 first)."""
    rng = np.random.default_rng(seed)
    comp = np.linalg.qr(rng.standard_normal((D, F)))[0].T
    return PCAModel(rng.normal(0, 1, D), comp, np.geomspace(4.0, 0.2, F), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("far", [False, True], ids=["folded", "centred"])
def test_a_rows_features_do_not_depend_on_its_call(cuda_device, far):
    pca = _pca(cuda_device)
    if far:
        pca = PCAModel(pca.mean_ + 1e4, pca.components_, pca.explained_variance_,
                       device=cuda_device)
    assert pca.route == "kernel" and pca._fold_ok is not far
    rng = np.random.default_rng(1)
    rows = pca.mean_ + rng.normal(0, 2.0, (8192, D))
    whole = pca.transform(rows)
    assert whole.shape == (8192, F) and whole.dtype == np.float32
    for n in (1000, 8):
        np.testing.assert_array_equal(pca.transform(rows[:n]), whole[:n])
    for i in rng.choice(8192, 16, replace=False):
        np.testing.assert_array_equal(pca.transform(rows[i:i + 1]), whole[i:i + 1])
    # Rows in another order and another company
    pick = rng.choice(8192, 256, replace=False)
    np.testing.assert_array_equal(pca.transform(rows[pick]), whole[pick])


@pytest.mark.cuda
def test_a_small_wide_build_keeps_the_gathered_route(cuda_device):
    """A build over 21 x 300 segments of ``westpa_ntl9``'s run at 900 raw
    coordinates: no fallback, every parent with a recorded parent gathered."""
    with open(os.path.join(ROOT, "benchmark", "configs", "westpa_ntl9.json")) as fh:
        cfg = json.load(fh)
    b, s = cfg["build"], dict(cfg["synthetic"])
    s["target_bounds"], s["basis_bounds"] = tuple(s["target_bounds"]), tuple(s["basis_bounds"])
    run = generate(21, 300, 2**31 + 7, cfg["wide"], **s)
    first = b["first_analysis_iter"]
    with tracing.collect() as col:
        model = modelWE(device=cuda_device)
        model.build_analyze_model(
            file_paths=ArrayWEDataset(run),
            ref_struct={"coords": None, "nAtoms": s["n_atoms"], "coord_ndim": 3},
            modelName=b["model_name"], basis_pcoord_bounds=b["basis_pcoord_bounds"],
            target_pcoord_bounds=b["target_pcoord_bounds"],
            dimreduce_method="pca", n_clusters=5, tau=b["tau"],
            step_kwargs={
                "dimReduce": {"variance_cutoff": b["variance_cutoff"], "first_iter": first},
                "clustering": {"first_cluster_iter": first, "user_bin_mapper":
                               RectilinearBinMapper([np.asarray(b["we_bin_edges"])])},
            },
            fluxmatrix_iters=[first, -1], cross_validation_groups=0,
            show_live_display=False)
    assert model.coordinates.route == "kernel" and model.ndim >= 20
    assert "dedup_fallback" not in col.counts
    gathered, projected = col.counts["parent_rows_gathered"], col.counts["parent_rows_projected"]
    recorded = sum(int((d["parent_ids"] >= 0).sum()) for d in run[1:model.maxIter - 1])
    assert gathered == recorded and gathered + projected == len(model._features["child"])
    assert gathered / (gathered + projected) >= 0.9
