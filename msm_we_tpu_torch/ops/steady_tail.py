"""The hot step's steady-state tail as one CUDA kernel
(``csrc/steady_tail.cu``) and the route between it and its plain version.

``steady_tail`` computes what ``step._steady_state`` computes for one f32
flux matrix on the card: the transition matrix, ``ceil(log2(n_iters))``
squarings each followed by a row renormalisation, the stationary vector
and its residual, at most ``max_extra_squarings`` extra rounds while the
residual exceeds ``tol``, and the target flux, in one launch, with no host
read and no conditional graph node. It returns ``(T, p, flux, residual,
rounds)``, ``rounds`` the extra squarings taken (``int32``, on the device).
The kernel sums in fixed orders, so its results repeat bit for bit; they
match the PyTorch tail to f32 reordering (cuBLAS and torch's reductions add
in other orders, and the kernel renormalises by a row's reciprocal), not
bitwise.

The route follows what the input shows, by two rules that
``step.steady_state_from_flux`` asks once each, inside a capture and out.
:func:`uses_kernel`: a CUDA f32 flux matrix of at most ``S_MAX`` states
takes the kernel. Larger matrices, where the squarings are real matrix
products, keep the PyTorch tail (``torch.where`` rounds eagerly, conditional
nodes in a graph), and so do other dtypes and CPU tensors: that PyTorch
tail (``step._steady_state`` with ``step._where_rounds``) is the kernel's
plain version, and ``testing.steady_state_early_exit`` counts its rounds.
:func:`tail_dtype`: the PyTorch tail of an f32 flux matrix of more than
``S_MAX`` states runs in float64, on the CPU and on CUDA alike, and returns
its outputs in f32. There the f32 residual ``||p T - p||_1`` sits at its
rounding floor (about ``sqrt(S)`` f32 epsilons, 3.4e-6 at 3,202 states,
above ``tol`` = 1e-6), so the f32 test would take its extra squarings by
the order of its sums and not by the chain; in float64 it means what the
float64 reference means by it. A difference by design from the JAX
package's f32 ``while_loop``: a higher precision, never a lower one.
The wrapper's launches are counted with the other kernels'
(``stratified_assign.KERNELS``).
"""
from __future__ import annotations

import math

import torch

from .._device import f64_threshold
from ._ext import _count_launch, check, library

__all__ = ["S_MAX", "MAX_STATES", "steady_tail", "tail_dtype", "uses_kernel"]

# The largest S that takes the kernel: the crossover with the PyTorch tail
# in a CUDA graph on an H100 (PERF.md, section 6: 640 wins at 0 and 16
# extra rounds, 768 loses at 16); above it an f32 tail runs in float64
S_MAX = 640
# The kernel's own limit: two vectors of S floats in shared memory
# (kMaxStates in csrc/steady_tail.cu)
MAX_STATES = 2048
TILE = 32  # kTN: the columns of a squaring's output tile
CHUNK = 64  # kChunk: the values of k a squaring stages, the scratch's padding


def _fixed_squarings(n_iters):
    """The squarings before the tail's first convergence test:
    ``ceil(log2(n_iters))``, at least one."""
    return max(int(math.ceil(math.log2(max(n_iters, 2)))), 1)


def uses_kernel(device, dtype, n_states):
    """Whether a flux matrix of ``n_states`` states of ``dtype`` on
    ``device`` takes the kernel: CUDA, float32 and ``n_states <= S_MAX``."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and n_states <= S_MAX)


def tail_dtype(dtype, n_states):
    """The dtype in which the PyTorch tail of a flux matrix of ``n_states``
    states of ``dtype`` runs: float64 for float32 above ``S_MAX`` states,
    else ``dtype``. It does not depend on the device."""
    if dtype == torch.float32 and n_states > S_MAX:
        return torch.float64
    return dtype


def _scratch_floats(S):
    NP = -(-S // CHUNK) * CHUNK
    return 3 * NP * NP + 2 * (NP // TILE) * NP + 2 * NP


def _check_inputs(fm, basis_mask, target_mask):
    if not isinstance(fm, torch.Tensor) or fm.device.type != "cuda":
        raise ValueError("steady_tail needs a CUDA flux matrix; the plain "
                         "version is step.steady_state_from_flux")
    if fm.dtype != torch.float32:
        raise TypeError(f"fm has dtype {fm.dtype}, expected torch.float32")
    if fm.dim() != 2 or fm.shape[0] != fm.shape[1]:
        raise ValueError(f"fm must be square, got shape {tuple(fm.shape)}")
    if not fm.is_contiguous():
        raise ValueError("fm must be contiguous")
    S = fm.shape[0]
    if not 1 <= S <= MAX_STATES:
        raise ValueError(f"steady_tail takes 1 to {MAX_STATES} states, got {S}")
    for name, m in (("basis_mask", basis_mask), ("target_mask", target_mask)):
        if not isinstance(m, torch.Tensor) or m.device != fm.device:
            raise ValueError(f"{name} must be a tensor on {fm.device}")
        if m.dtype != torch.bool or tuple(m.shape) != (S,):
            raise ValueError(f"{name} must be a bool vector of {S} states")
        if not m.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return S


def steady_tail(fm, basis_mask, target_mask, n_iters=512, tol=1e-6,
                max_extra_squarings=16, counter=None):
    """The tail of ``fm`` (S, S) f32 on the card, one kernel launch on the
    current stream (no synchronisation): ``(T, p, flux, residual,
    rounds)``. ``counter``, a 0-dim ``int32`` CUDA tensor, gains the rounds
    taken (the traced graph's ``tail_rounds``). Raises on a CPU tensor,
    another dtype or layout, or more than ``MAX_STATES`` states."""
    S = _check_inputs(fm, basis_mask, target_mask)
    if counter is not None and (counter.device != fm.device
                                or counter.dtype != torch.int32
                                or counter.numel() != 1):
        raise ValueError("counter must be one int32 on the flux's device")
    dev = fm.device
    T = torch.empty((S, S), dtype=torch.float32, device=dev)
    p = torch.empty(S, dtype=torch.float32, device=dev)
    flux = torch.empty((), dtype=torch.float32, device=dev)
    residual = torch.empty((), dtype=torch.float32, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(_scratch_floats(S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = library().msm_steady_tail(
            fm.data_ptr(), basis_mask.data_ptr(), target_mask.data_ptr(), S,
            _fixed_squarings(n_iters), int(max_extra_squarings),
            f64_threshold(tol, torch.float32), T.data_ptr(), p.data_ptr(),
            flux.data_ptr(), residual.data_ptr(), rounds.data_ptr(),
            None if counter is None else counter.data_ptr(),
            scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    check(err, "steady_tail")
    _count_launch(steady_tail)
    return T, p, flux, residual, rounds

