"""msm_we_tpu_torch: the PyTorch/CUDA port of msm_we_tpu (haMSM estimation
from weighted-ensemble data) for NVIDIA Hopper GPUs.

The main path is ``modelWE(device=...).build_analyze_model(...)`` on a list
of west.h5 paths (:class:`WEDataset`) or an in-memory
:class:`ArrayWEDataset`; the hot step is in :mod:`msm_we_tpu_torch.entry`;
the trajectory models (``NonMarkovModel``, ``MarkovPlusColorModel``, the
ensembles and the FPT engines) are in :mod:`msm_we_tpu_torch.msm`. CUDA tensors run the hand-written kernels
of ``csrc/``; CPU tensors run their plain PyTorch versions.
"""
from . import _device  # noqa: F401  (pins float32 products to IEEE)
from .binning import RectilinearBinMapper
from .data import ArrayWEDataset, WEDataset, generate_we_arrays, generate_west_h5
from .model import modelWE
from .msm import (
    DirectFPT,
    DiscreteEnsemble,
    DiscretePathEnsemble,
    Ensemble,
    MarkovFPT,
    MarkovPlusColorModel,
    MatrixFPT,
    NonMarkovFPT,
    NonMarkovModel,
    PathEnsemble,
)

__version__ = "0.1.0"

__all__ = [
    "modelWE", "ArrayWEDataset", "WEDataset", "RectilinearBinMapper",
    "generate_we_arrays", "generate_west_h5",
    "Ensemble", "PathEnsemble", "DiscreteEnsemble", "DiscretePathEnsemble",
    "DirectFPT", "MatrixFPT", "MarkovFPT", "NonMarkovFPT",
    "NonMarkovModel", "MarkovPlusColorModel",
]
