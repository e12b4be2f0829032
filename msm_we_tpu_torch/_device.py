"""Device helpers and the float32 precision policy of the port.

Importing this module pins every float32 matrix product to full IEEE
float32: no TF32 in cuBLAS or cuDNN. This keeps the precision split of the
JAX package (``docs/design.md``): geometry in exact f32 (TF32 would move
near-tie cluster assignments), accumulated statistics in f64, small solves
in host f64.

The port's entry points (``modelWE``, ``modelWE.load``, ``entry``,
``hot_step``) run on the card by default; a caller asks for the CPU with
``device="cpu"``. Everything below them takes the explicit device it is
given (or follows the device of its tensors), and nothing falls back to
the CPU: ``as_device("cuda")`` raises where no CUDA device is available.
CPU tensors run the plain PyTorch versions; CUDA tensors launch the
hand-written kernels or raise.
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def as_device(device):
    """``torch.device`` from a string or device; ``None`` is refused."""
    if device is None:
        raise ValueError("an explicit device is required ('cpu' or 'cuda')")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(a, device, dtype=None):
    """A numpy array (or tensor) as a contiguous tensor on ``device``."""
    t = torch.as_tensor(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def f64_threshold(value, dtype):
    """The largest ``dtype`` number not above the float ``value``. A
    ``dtype`` tensor ``x`` compared with it on the device (``x > t``, ``x <=
    t``) decides as ``float(x)`` compared with ``value`` on the host would,
    without the host read."""
    kind = np.dtype(str(dtype).removeprefix("torch.")).type
    with np.errstate(over="ignore"):  # beyond the dtype's range: its max
        t = kind(value)
        if float(t) > value:
            t = np.nextafter(t, kind(-np.inf))
    return float(t)
