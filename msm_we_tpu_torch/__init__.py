"""msm_we_tpu_torch: the PyTorch/CUDA port of msm_we_tpu (haMSM estimation
from weighted-ensemble data) for NVIDIA Hopper GPUs.

The main path is ``modelWE(device=...).build_analyze_model(...)`` on an
in-memory :class:`ArrayWEDataset`; the hot step is in
:mod:`msm_we_tpu_torch.entry`. CUDA tensors run the hand-written kernels
of ``csrc/``; CPU tensors run their plain PyTorch versions.
"""
from . import _device  # noqa: F401  (pins float32 products to IEEE)
from .binning import RectilinearBinMapper
from .data import ArrayWEDataset, generate_we_arrays
from .model import modelWE

__version__ = "0.1.0"

__all__ = ["modelWE", "ArrayWEDataset", "RectilinearBinMapper", "generate_we_arrays"]
