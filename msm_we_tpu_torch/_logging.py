"""Package logger (counterpart of ``msm_we_tpu/_logging.py``).

A plain stream handler: the compute paths never depend on a TTY or on
rich, which the port imports only inside the optional live display.
"""
from __future__ import annotations

import logging

log = logging.getLogger("msm_we_tpu_torch")
if not log.handlers:
    log.addHandler(logging.StreamHandler())
# INFO by default, like the JAX package; embedders can pin a level before
# importing the package
if log.level == logging.NOTSET:
    log.setLevel(logging.INFO)
log.propagate = False
