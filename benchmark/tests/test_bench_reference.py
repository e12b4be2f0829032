"""The plain references at a small size on the CPU: each agrees with
itself exactly, holds the port's CPU route close, and reads its control
(one precision lower) as further off."""
import json
import os

import numpy as np
import pytest
import torch

import bench_helpers
from benchmark.reference import build as build_ref
from benchmark.reference import hot_step as hot_ref
from benchmark.traffic.hot_problem import make_problem
from benchmark.traffic.we_run import generate


@pytest.fixture(scope="module")
def problem():
    return make_problem(n_segments=2048, n_raw_features=60, n_components=8, n_bins=6,
                        k_per_bin=5, seed=2**31 + 5)


def test_hot_reference_judges_itself_exactly(problem):
    out = hot_ref.Judge(problem)(hot_ref.solve(problem))
    assert out == dict(bad_ids=0, id_gap=0.0, flux_err=0.0, pss_err=0.0,
                       target_flux_err=0.0)


def test_hot_reference_holds_the_port_and_its_control_apart(problem):
    from msm_we_tpu_torch.entry import hot_step

    judge = hot_ref.Judge(problem)
    port = judge(hot_step(problem, "two_transform", "cpu"))
    control = judge(hot_ref.solve(problem, tf32=True))
    assert port["bad_ids"] == control["bad_ids"] == 0
    for k in ("id_gap", "flux_err", "pss_err", "target_flux_err"):
        assert port[k] < 1e-5, (k, port)
        assert control[k] > 10 * max(port[k], 1e-7), (k, control, port)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12])
    assert hot_ref._tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0]


def test_transition_matrix_recycles_and_keeps_idle_states():
    fm = torch.tensor([[0.0, 2.0, 0.0, 0.0], [1.0, 0.0, 0.0, 1.0],
                       [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 3.0]], dtype=torch.float64)
    basis = torch.tensor([False, False, True, False])
    target = torch.tensor([False, False, False, True])
    T = hot_ref.transition_matrix(fm, basis, target)
    assert T.tolist() == [[0, 1, 0, 0], [0.5, 0, 0, 0.5], [0, 0, 1, 0], [0, 0, 1, 0]]


@pytest.fixture(scope="module")
def built():
    from msm_we_tpu_torch.binning import RectilinearBinMapper
    from msm_we_tpu_torch.data import ArrayWEDataset
    from msm_we_tpu_torch.model import modelWE

    cfg = bench_helpers.load_json(os.path.join(bench_helpers.BENCH, "configs",
                                               "westpa_default.json"))
    data = generate(24, 150, 2**31 + 21)
    b = cfg["build"]
    m = modelWE(device="cpu")
    m.build_analyze_model(
        file_paths=ArrayWEDataset(data), ref_struct={"coords": None, "nAtoms": 4,
                                                     "coord_ndim": 3},
        modelName="t", basis_pcoord_bounds=b["basis_pcoord_bounds"],
        target_pcoord_bounds=b["target_pcoord_bounds"], dimreduce_method="pca",
        n_clusters=b["n_clusters"], tau=b["tau"],
        step_kwargs={"dimReduce": {"variance_cutoff": b["variance_cutoff"]},
                     "clustering": {"user_bin_mapper": RectilinearBinMapper(
                         [np.asarray(b["we_bin_edges"])])}},
        allow_validation_failure=True, show_live_display=False)
    return cfg, data, m


def test_block_iterations_are_the_builds(built):
    cfg, data, m = built
    b = cfg["build"]
    assert build_ref.block_iterations(m.maxIter, b["cross_validation_groups"],
                                      b["cross_validation_blocks"]) == [
        [i for i in its if 1 <= i < m.maxIter] for its in m.validation_iterations]


def test_build_reference_holds_the_port_and_its_control_apart(built):
    from benchmark.drivers.build import extract

    cfg, data, m = built
    judge = build_ref.Judge(data, cfg)
    state = extract(m, len(cfg["build"]["we_bin_edges"]) - 1)
    port = judge(state)
    control = judge(judge.control(state))
    assert port["bad_ids"] == port["not_connected"] == 0, port
    for k in ("pca_err", "flux_err", "pss_err", "target_flux_err"):
        assert port[k] < 1e-10, (k, port)
        assert control[k] > 1e-9, (k, control)
    assert port["id_gap"] < 1e-6 < control["id_gap"], (port, control)
    json.dumps(port)


def test_strong_sets():
    ring = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], float)
    assert build_ref._n_strong_sets(ring) == 1
    chain = np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0]], float)
    assert build_ref._n_strong_sets(chain) == 3
