"""Tests of the port's CUDA paths that need no JAX, so they also run on a
GPU machine where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_repeatability.py

Each skips without a GPU.
"""
import numpy as np
import pytest
import torch

from msm_we_tpu_torch import ArrayWEDataset, RectilinearBinMapper, modelWE
from msm_we_tpu_torch.data import generate_we_arrays
from msm_we_tpu_torch.ops import kmeans as tkmeans

EDGES = np.linspace(0, 10, 13)
COMMON = dict(
    ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
    modelName="repeatability",
    basis_pcoord_bounds=[[9.0, 10.0]],
    target_pcoord_bounds=[[0.0, 1.0]],
    dimreduce_method="pca",
    tau=1.0,
    n_clusters=3,
    show_live_display=False,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_minibatch_update_is_deterministic_on_cuda(cuda_device):
    """Ten calls on the same CUDA inputs give bitwise equal centers and
    counts (no atomic-order sums), close to the CPU's serial sums."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(200_000, 12, generator=g).cuda()
    w = torch.rand(200_000, generator=g).cuda()
    idx = torch.randint(0, 300, (200_000,), generator=g).cuda()
    centers = torch.randn(300, 12, generator=g).cuda()
    counts = torch.rand(300, generator=g).cuda()
    first = tkmeans.minibatch_update(centers, counts, X, w, idx)
    for _ in range(9):
        again = tkmeans.minibatch_update(centers, counts, X, w, idx)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    ref = tkmeans.minibatch_update(centers.cpu(), counts.cpu(), X.cpu(), w.cpu(),
                                   idx.cpu())
    torch.testing.assert_close(first[0].cpu(), ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(first[1].cpu(), ref[1], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_deepcopy_and_save_keep_cuda_models_usable(cuda_device, tmp_path):
    """Copies of a CUDA model stay on CUDA; its pickle loads on the CPU."""
    m = modelWE(device=cuda_device)
    m.build_analyze_model(
        file_paths=ArrayWEDataset(generate_we_arrays(12, 32, seed=17)),
        step_kwargs={"clustering": {"user_bin_mapper": RectilinearBinMapper([EDGES]),
                                    "scan_small_batches": True}},
        **COMMON,
    )
    assert m.post_cluster_model.device.type == "cuda"
    assert m.post_cluster_model._strat.device.type == "cuda"
    m.save(tmp_path / "m.pkl")
    loaded = modelWE.load(tmp_path / "m.pkl", device="cpu")
    assert loaded.device.type == "cpu" and loaded._strat.device.type == "cpu"
    assert loaded.JtargetSS == m.JtargetSS
