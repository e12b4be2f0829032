"""Trajectory first-passage-time library of the port (counterpart of
``msm_we_tpu/msm/fpt.py``). ``ensembles.py`` and ``nmm.py`` are not ported
yet (ROADMAP, queue 1)."""
from .fpt import DirectFPT, MarkovFPT, MatrixFPT, NonMarkovFPT

__all__ = ["DirectFPT", "MatrixFPT", "MarkovFPT", "NonMarkovFPT"]
