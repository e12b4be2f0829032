"""The float64 steady-state tail's row passes as CUDA kernels
(``csrc/tail_rows.cu``), and the rule that sends a tail to them.

The PyTorch tail (``step._steady_state``) squares its matrix with cuBLAS
and passes over its rows between the products. On the card, in float64,
two kernels take those passes, each touching the matrix once:

* :func:`renormalize`: a squared matrix's rows divided in place by their
  sums clamped at 1e-30, after each squaring (the fixed ones and every
  extra round's). Plain version: ``step._renormalize``.
* :func:`transition`: the transition matrix in float64 from the f32 (or
  f64) flux matrix, its copy in the flux's dtype and each row's target
  mass ``sum_{j in target} T_ij``, in one pass. Plain version:
  ``step._transition_matrix`` (and ``step._target_flux``, whose sum
  ``p . mass`` takes in another order).

Both sum in float64 in fixed orders, so their results repeat bit for bit
and match the plain versions to float64 reordering. Neither allocates
inside its launch or reads back to the host, so both are captured into the
step's CUDA graph, the renormalisation also inside the conditional rounds.

:func:`uses_kernels` is the rule: a tail that runs in float64 on a CUDA
device (``ops.steady_tail.tail_dtype``: an f32 flux matrix of more than
``S_MAX`` states, or an f64 one) takes the kernels, and every other tail
keeps the plain versions. ``step.steady_state_from_flux`` asks it once.
The wrappers' launches are counted with the other kernels'
(``stratified_assign.KERNELS``).

The tail's float64 matrices keep their rows on ``ROW_ALIGN`` bytes
(:func:`_aligned_empty`): cuBLAS's product of two (3,202, 3,202) f64
matrices takes 1.21-1.37 ms with such rows and 1.72 ms with rows of 3,202
(16-byte steps) on an H100 (PERF.md, section 6), and the renormalisation
reads them 16 bytes a load.
"""
from __future__ import annotations

import torch

from ._ext import _count_launch, check, library

__all__ = ["ROW_ALIGN", "renormalize", "transition", "uses_kernels"]

ROW_ALIGN = 32


def _aligned_empty(S, dtype, device):
    """An uninitialised (S, S) matrix whose rows start every ``ROW_ALIGN``
    bytes: the first ``S`` columns of a buffer whose rows are padded to
    that step."""
    step = ROW_ALIGN // dtype.itemsize
    ld = -(-S // step) * step
    return torch.empty((S, ld), dtype=dtype, device=device)[:, :S]


def uses_kernels(device, dtype):
    """Whether a PyTorch tail in ``dtype`` on ``device`` takes the row
    kernels: CUDA and float64."""
    return torch.device(device).type == "cuda" and dtype == torch.float64


def _check_cuda(x, what):
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"tail_rows needs a CUDA {what}; the plain version "
                         "is in step.py")


def _check_rows(a):
    """Raise unless ``a`` is an (S, S) float64 matrix whose rows lie on
    ``ROW_ALIGN`` bytes (unit column stride). Returns ``S``."""
    if a.dtype != torch.float64:
        raise TypeError(f"the matrix has dtype {a.dtype}, expected torch.float64")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or a.shape[0] < 1:
        raise ValueError(f"the matrix must be square, got shape {tuple(a.shape)}")
    S, ld = a.shape[0], a.stride(0)
    if (a.stride(1) != 1 or ld < S or ld * 8 % ROW_ALIGN
            or a.data_ptr() % ROW_ALIGN):
        raise ValueError(f"the matrix's rows must start on {ROW_ALIGN} bytes "
                         f"(strides {a.stride()}); see _aligned_empty")
    return S


def renormalize(a):
    """Divide each row of ``a`` (S, S) f64 on the card, in place, by its sum
    clamped at 1e-30: one launch on the current stream (no
    synchronisation). Returns ``a``. Raises on a CPU tensor, another dtype
    or rows off ``ROW_ALIGN`` bytes."""
    _check_cuda(a, "matrix")
    S = _check_rows(a)
    with torch.cuda.device(a.device):
        err = library().msm_tail_renorm(
            a.data_ptr(), S, a.stride(0),
            torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "tail_rows.renormalize")
    _count_launch(renormalize)
    return a


def _check_transition(fm, basis_mask, target_mask):
    _check_cuda(fm, "flux matrix")
    if fm.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fm has dtype {fm.dtype}, expected float32 or float64")
    if fm.dim() != 2 or fm.shape[0] != fm.shape[1] or fm.shape[0] < 1:
        raise ValueError(f"fm must be square, got shape {tuple(fm.shape)}")
    if not fm.is_contiguous():
        raise ValueError("fm must be contiguous")
    S = fm.shape[0]
    for name, m in (("basis_mask", basis_mask), ("target_mask", target_mask)):
        if not isinstance(m, torch.Tensor) or m.device != fm.device:
            raise ValueError(f"{name} must be a tensor on {fm.device}")
        if m.dtype != torch.bool or tuple(m.shape) != (S,):
            raise ValueError(f"{name} must be a bool vector of {S} states")
        if not m.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return S


def transition(fm, basis_mask, target_mask):
    """The transition matrix of ``fm`` (S, S) f32 or f64 on the card, one
    launch on the current stream (no synchronisation): ``(T, T_out,
    mass)``. ``T`` is float64 with rows on ``ROW_ALIGN`` bytes; ``T_out``
    is ``T`` in ``fm``'s dtype (``T`` itself for an f64 ``fm``, else its f32
    copy, bitwise ``T.to(float32)``); ``mass`` (S,) f64 is each row's sum
    over the target columns. Raises on a CPU tensor, another dtype or
    layout."""
    S = _check_transition(fm, basis_mask, target_mask)
    dev = fm.device
    T = _aligned_empty(S, torch.float64, dev)
    T32 = (torch.empty((S, S), dtype=torch.float32, device=dev)
           if fm.dtype == torch.float32 else None)
    mass = torch.empty(S, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = library().msm_tail_transition(
            fm.data_ptr(), int(fm.dtype == torch.float64),
            basis_mask.data_ptr(), target_mask.data_ptr(), S, T.stride(0),
            T.data_ptr(), None if T32 is None else T32.data_ptr(),
            mass.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "tail_rows.transition")
    _count_launch(transition)
    return T, T if T32 is None else T32, mass
