"""Standalone trajectory-MSM and first-passage-time library of the port
(counterparts of ``msm_we_tpu/msm/ensembles.py``, ``fpt.py`` and ``nmm.py``).
The ensembles and the models are host numpy; the FPT engines can run on a
device."""
from .ensembles import DiscreteEnsemble, DiscretePathEnsemble, Ensemble, PathEnsemble
from .fpt import DirectFPT, MarkovFPT, MatrixFPT, NonMarkovFPT
from .nmm import MarkovPlusColorModel, NonMarkovModel

__all__ = [
    "Ensemble",
    "PathEnsemble",
    "DiscreteEnsemble",
    "DiscretePathEnsemble",
    "DirectFPT",
    "MatrixFPT",
    "MarkovFPT",
    "NonMarkovFPT",
    "NonMarkovModel",
    "MarkovPlusColorModel",
]
