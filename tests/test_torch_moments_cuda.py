"""The PCA moments of ``ops/pca.py`` kept on the card: ``MomentAccumulator``
with ``dtype=np.float32`` on CUDA against the float64 host path, at the
widths of the ``westpa_ntl9.100k`` build (100 batches of 1,000 x 900).
JAX-free, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moments_cuda.py

Skips without a GPU. Each batch is centred in f64 on the card before its
f32 product, so M2 holds to the f32 path's rtol of 1e-4 far from the
origin; Chan's update runs on the card in f64, and the host reads M2 once,
at ``finalize``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msm_we_tpu_torch import tracing
from msm_we_tpu_torch.ops.pca import MomentAccumulator

N_BATCH, ROWS, D, RANK = 100, 1000, 900, 40


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batches(seed=25):
    """Low-rank frames (40 slow modes and small noise) far from the origin,
    like the cell's 900 coordinates."""
    rng = np.random.default_rng(seed)
    loading = rng.normal(size=(RANK, D)) * (0.96 ** np.arange(RANK))[:, None]
    offset = rng.uniform(-50.0, 50.0, size=D)
    for _ in range(N_BATCH):
        z = rng.normal(size=(ROWS, RANK))
        yield z @ loading + 0.05 * rng.normal(size=(ROWS, D)) + offset


@pytest.mark.cuda
def test_device_moments_match_f64_and_read_once(cuda_device):
    acc = MomentAccumulator(D, dtype=np.float32, device=cuda_device)
    ref = MomentAccumulator(D)
    with tracing.collect() as col:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for X in _batches():
                acc.add(X)
                ref.add(X)
            torch.cuda.synchronize()
        model = acc.finalize()
    assert col.counts == {"moments_device_batches": N_BATCH, "moments_readbacks": 1}

    names = [e.name for e in prof.events()]
    assert sum("Memcpy HtoD" in n for n in names) >= N_BATCH  # the profiler saw copies
    assert not [n for n in names if "Memcpy DtoH" in n]

    M2 = acc.M2
    np.testing.assert_allclose(M2, ref.M2, rtol=1e-4, atol=1e-4 * np.abs(ref.M2).max())
    np.testing.assert_allclose(acc.mean, ref.mean, rtol=1e-12,
                               atol=1e-12 * np.abs(ref.mean).max())
    assert acc.n == ref.n == acc.n_samples == N_BATCH * ROWS
    assert model.n_components == ref.finalize().n_components
    np.testing.assert_array_equal(model.mean_, acc.mean)
