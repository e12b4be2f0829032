"""Standalone utility scripts (counterpart of ``msm_we_tpu/scripts``):
post-hoc coordinate augmentation of west.h5 files. The haMSM build from
the command line is the ``msm-we-tpu-torch build`` CLI."""
from .collect_coordinates import augment_west_h5  # noqa: F401
