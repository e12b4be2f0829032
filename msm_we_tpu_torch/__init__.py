"""msm_we_tpu_torch: the PyTorch/CUDA port of msm_we_tpu (haMSM estimation
from weighted-ensemble data) for NVIDIA Hopper GPUs.

The main path is ``modelWE(device=...).build_analyze_model(...)`` on a list
of west.h5 paths (:class:`WEDataset`) or an in-memory
:class:`ArrayWEDataset`; the hot step is in :mod:`msm_we_tpu_torch.entry`;
the trajectory models (``NonMarkovModel``, ``MarkovPlusColorModel``, the
ensembles and the FPT engines) are in :mod:`msm_we_tpu_torch.msm`; the
extended analysis (``ExtendedModelWE``) and ``optimization`` load lazily, as
in the JAX package; the command line is ``msm-we-tpu-torch``
(:mod:`msm_we_tpu_torch.cli`) and the WESTPA drivers are in
:mod:`msm_we_tpu_torch.westpa_plugins`. CUDA tensors run the hand-written
kernels of ``csrc/``; CPU tensors run their plain PyTorch versions.
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
    "NonMarkovModel", "MarkovPlusColorModel", "ExtendedModelWE",
]


def __getattr__(name):
    if name == "ExtendedModelWE":
        from .extended import ExtendedModelWE

        return ExtendedModelWE
    if name == "optimization":
        # importlib, not `from . import`: that re-enters this __getattr__
        # while the submodule attribute is not set yet
        import importlib

        return importlib.import_module(".optimization", __name__)
    raise AttributeError(f"module 'msm_we_tpu_torch' has no attribute {name!r}")
