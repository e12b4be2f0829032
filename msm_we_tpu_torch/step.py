"""The single-device haMSM step: assign, override, scatter flux, steady state.

Counterpart of the single-device part of ``msm_we_tpu/parallel/sharded.py``
(``_raw_pair_assign``, ``_apply_overrides``, ``_assign_overridden``,
``_discretize_and_flux``, ``_scatter_flux``, ``fused_step_single``,
``steady_state_from_flux``, and the one-device forms of
``build_sharded_pair_assign`` / ``build_sharded_single_assign`` /
``build_sharded_cluster_stats``): what one rank computes on its rows.
``parallel/sharded.py`` runs these over a ('data', 'model') mesh of ranks
and adds the argmin combine and the all-reduce. The assignment and flux go
through the kernels of ``ops/stratified_assign.py`` on CUDA tensors and
their plain versions on CPU tensors.

The center bank must be compact (valid centers first, in global-id order):
the row index of the winning center is its global cluster id.
"""
from __future__ import annotations

import math

import torch

from ._device import f64_threshold
from .ops import steady_tail
from .ops.stratified_assign import assign_flux, pair_assign

__all__ = [
    "fused_step_single",
    "steady_state_from_flux",
    "pair_assign_predict",
    "single_assign_predict",
    "cluster_stats",
]


def _apply_overrides(pidx, cidx, basis_p, basis_c, target_c, n_states,
                     target_p=None, predict_order=False):
    """Basis/target overrides. ``predict_order`` (the reference's predict,
    used for dtrajs): target is checked last, so target wins rows inside
    both regions. Flux order (the reference's flux build): end-in-target,
    then start-in-target (``target_p``), then basis for both ends, so
    basis wins."""
    B, T = n_states - 2, n_states - 1

    def where(mask, value, idx):
        return idx if mask is None else torch.where(mask, value, idx)

    if predict_order:
        pidx = where(basis_p, B, pidx)
        cidx = where(basis_c, B, cidx)
        pidx = where(target_p, T, pidx)
        cidx = where(target_c, T, cidx)
    else:
        cidx = where(target_c, T, cidx)
        pidx = where(target_p, T, pidx)
        pidx = where(basis_p, B, pidx)
        cidx = where(basis_c, B, cidx)
    return pidx.to(torch.int32), cidx.to(torch.int32)


def _scatter_flux(pidx, cidx, w, n_states):
    """(S, S) flux of ``w`` at (parent, child), accumulated in the dtype of
    ``w``: f64 weights give the facade's parity-grade flux (WE weights span
    hundreds of decades; an f32 scatter would flush small ones)."""
    flat = pidx.to(torch.int64) * n_states + cidx.to(torch.int64)
    fm = torch.zeros(n_states * n_states, dtype=w.dtype, device=w.device)
    return fm.index_add_(0, flat, w).reshape(n_states, n_states)


def _raw_pair_assign(fp, fc, pbins, cbins, centers, center_bin, valid):
    """Nearest-center ids for parent and child rows, no overrides."""
    return pair_assign(fp, fc, pbins, cbins, centers, center_bin, valid)


def _assign_overridden(fp, fc, pbins, cbins, basis_p, basis_c, target_c,
                       centers, center_bin, valid, n_states, target_p=None,
                       predict_order=False):
    """Assign parent and child rows and apply the overrides in one kernel
    launch (the H4 epilogue)."""
    return pair_assign(
        fp, fc, pbins, cbins, centers, center_bin, valid, n_states=n_states,
        basis_p=basis_p, basis_c=basis_c, target_p=target_p,
        target_c=target_c, order="predict" if predict_order else "flux",
    )


def _discretize_and_flux(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
                         centers, center_bin, valid, n_states, target_p=None):
    """Assign, flux-order overrides and the flux scatter (in the dtype of
    ``w``) as one H3 launch. Returns ``(fm, pidx, cidx)``."""
    pidx, cidx, fm = assign_flux(
        fp, fc, pbins, cbins, w, basis_p, basis_c, target_c, centers,
        center_bin, valid, n_states, target_p=target_p,
    )
    return fm, pidx, cidx


def fused_step_single(fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
                      centers, center_bin, valid, n_states, target_p=None):
    """Single-device fused discretize + flux (the benchmark hot path).
    Returns ``(fm, pidx, cidx)``."""
    return _discretize_and_flux(
        fp, fc, pbins, cbins, basis_p, basis_c, target_c, w, centers,
        center_bin, valid, n_states, target_p=target_p,
    )


def pair_assign_predict(fp, fc, pbins, cbins, basis_p, basis_c, target_c,
                        centers, center_bin, valid, n_states, target_p=None):
    """One-device ``build_sharded_pair_assign``: predict-order (target
    wins) parent and child ids, the dtrajs numbering."""
    return _assign_overridden(
        fp, fc, pbins, cbins, basis_p, basis_c, target_c, centers,
        center_bin, valid, n_states, target_p=target_p, predict_order=True,
    )


def single_assign_predict(fc, cbins, basis_c, target_c, centers, center_bin,
                          valid, n_states):
    """One-device ``build_sharded_single_assign``: one row set with the
    predict-order overrides (the dedup discretization fast path)."""
    return pair_assign(
        None, fc, None, cbins, centers, center_bin, valid, n_states=n_states,
        basis_c=basis_c, target_c=target_c, order="predict",
    )


def cluster_stats(cid, p1, n_live, k_max):
    """One-device ``build_sharded_cluster_stats``: per-cluster child-pcoord
    count, sum, min and max from device-resident ids ``cid`` (N,) and
    pcoords ``p1`` (N, ndim) f32, without bringing the ids to the host.

    Returns ``(counts int32, sums f64, vmin f32, vmax f32)``, each
    ``(k_max + 1, ndim)``. ``k_max`` is the nominal bank width; rows whose
    id is outside ``[0, n_live)`` (basis and target overrides included) land
    in the trash row ``k_max``. NaN pcoords are excluded per dimension, as
    the host route's ``good`` mask does. Untouched cells keep count 0, sum
    0, min +inf and max -inf. Plain torch ops (``index_add_``,
    ``scatter_reduce_``): the JAX package computes these with XLA scatters,
    not a Pallas kernel.

    The sums are accumulated in f64, which the card adds natively (the JAX
    package sums in f32): one f32 accumulator a cluster over millions of
    rows loses the digits the pcoord sort needs (a partial sum of 5e5 has
    an f32 spacing of 0.03).
    """
    dev = p1.device
    ndim = p1.shape[1]
    cid = cid.long()
    in_range = (cid >= 0) & (cid < n_live)
    bucket = torch.where(in_range, cid, k_max)
    good = ~torch.isnan(p1) & in_range[:, None]
    shape = (k_max + 1, ndim)
    counts = torch.zeros(shape, dtype=torch.int32, device=dev).index_add_(
        0, bucket, good.to(torch.int32)
    )
    sums = torch.zeros(shape, dtype=torch.float64, device=dev).index_add_(
        0, bucket, torch.where(good, p1, 0.0).double()
    )
    index = bucket[:, None].expand(-1, ndim)
    vmin = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
    vmin.scatter_reduce_(0, index, torch.where(good, p1, float("inf")), "amin")
    vmax = torch.full(shape, float("-inf"), dtype=torch.float32, device=dev)
    vmax.scatter_reduce_(0, index, torch.where(good, p1, float("-inf")), "amax")
    return counts, sums, vmin, vmax


def _transition_matrix(fm, basis_mask, target_mask):
    """Row-normalized ``fm`` with sink recycling: rows without outflux stay
    put, target rows recycle uniformly into the basis. The row divisor is
    exact (no clamp), so rows with outflux below 1e-30 stay stochastic."""
    S = fm.shape[0]
    dev, dt = fm.device, fm.dtype
    out = fm.sum(1)
    pos = out > 0
    T = torch.where(
        pos[:, None], fm / torch.where(pos, out, torch.ones_like(out))[:, None],
        torch.zeros_like(fm),
    )
    eye = torch.eye(S, dtype=torch.bool, device=dev)
    T = torch.where((~pos)[:, None] & eye, torch.ones_like(T), T)
    n_basis = basis_mask.sum().clamp(min=1).to(dt)
    recycle = torch.where(
        basis_mask, 1.0 / n_basis, torch.zeros((), dtype=dt, device=dev)
    )
    return torch.where(target_mask[:, None], recycle[None, :], T)


# Rows of the tail's squared matrices start on this many bytes: cuBLAS's
# product of two (3,202, 3,202) f64 matrices takes 1.21-1.37 ms with such
# rows and 1.72 ms with rows of 3,202 (16-byte steps) on an H100 (PERF.md,
# section 6)
ROW_ALIGN = 32


def _aligned_empty(S, like):
    """An uninitialised (S, S) matrix of ``like``'s dtype and device whose
    rows start every ``ROW_ALIGN`` bytes: the first ``S`` columns of a
    buffer whose rows are padded to that step."""
    step = ROW_ALIGN // like.element_size()
    ld = -(-S // step) * step
    return torch.empty((S, ld), dtype=like.dtype, device=like.device)[:, :S]


def _aligned(T):
    """``T`` (S, S) with its rows on ``ROW_ALIGN`` bytes: itself where they
    are, else a copy (the same values)."""
    if T.is_contiguous() and T.shape[1] * T.element_size() % ROW_ALIGN == 0:
        return T
    return _aligned_empty(T.shape[0], T).copy_(T)


def _square(Tn):
    out = torch.mm(Tn, Tn, out=_aligned_empty(Tn.shape[0], Tn))
    # Renormalize rows: f32 powering drifts row sums off 1
    return out.div_(out.sum(1, keepdim=True).clamp(min=1e-30))


def _stationary(Tn, T):
    """``p = p0 T^n`` from the uniform ``p0``, normalized, and its residual
    ``||p T - p||_1``."""
    S = T.shape[0]
    p0 = torch.ones(S, dtype=T.dtype, device=T.device) / S
    p = p0 @ Tn
    p = p / p.sum().clamp(min=1e-30)
    return p, (p @ T - p).abs().sum()


def _fixed_squarings(n_iters):
    return max(int(math.ceil(math.log2(max(n_iters, 2)))), 1)


def _target_flux(T, p, target_mask):
    return (torch.where(target_mask[None, :], T, torch.zeros_like(T))
            * p[:, None]).sum()


def _where_rounds(Tn, p, residual, T, tol, n_rounds):
    """Guarded rounds: each computes its candidate and keeps it only where
    the 0-dim flag ``residual > tol`` holds, so a round after convergence
    changes nothing (the early-exit loop's result, no host read)."""
    for _ in range(n_rounds):
        go = residual > tol
        Tc = _square(Tn)
        pc, rc = _stationary(Tc, T)
        Tn = torch.where(go, Tc, Tn)
        p = torch.where(go, pc, p)
        residual = torch.where(go, rc, residual)
    return Tn, p, residual


def _steady_state(fm, basis_mask, target_mask, n_iters, tol,
                  max_extra_squarings, rounds):
    """The tail with its extra squarings taken by ``rounds`` (the signature
    of :func:`_where_rounds`; ``_graph.conditional_rounds`` inside a
    capture), in ``ops.steady_tail.tail_dtype``: float64 for an f32 ``fm``
    of more than ``S_MAX`` states, else ``fm``'s dtype. ``tol`` becomes the
    largest number of that dtype not above it, so the device comparison
    decides as a host read would. The outputs are in ``fm``'s dtype."""
    dtype = steady_tail.tail_dtype(fm.dtype, fm.shape[0])
    tol = f64_threshold(tol, dtype)
    T = _aligned(_transition_matrix(fm.to(dtype), basis_mask, target_mask))
    Tn = T
    for _ in range(_fixed_squarings(n_iters)):
        Tn = _square(Tn)
    p, residual = _stationary(Tn, T)
    Tn, p, residual = rounds(Tn, p, residual, T, tol, max_extra_squarings)
    out = T, p, _target_flux(T, p, target_mask), residual
    return tuple(x.to(fm.dtype) for x in out)


def steady_state_from_flux(fm, basis_mask, target_mask, n_iters=512,
                           tol=1e-6, max_extra_squarings=16):
    """Device tail, its outputs in the dtype of ``fm``: row-normalize with
    sink recycling, then ``p0 T^n`` by repeated squaring.

    ``ceil(log2(n_iters))`` squarings, then at most ``max_extra_squarings``
    rounds, each taken only while the residual ``||p T - p||_1`` exceeds
    ``tol`` (the JAX package's ``while_loop``). The check stays on the
    device, with no host read, and the result is the early-exit loop's (the
    first round whose residual is ``<= tol``, else the last). A CUDA f32
    ``fm`` of at most ``ops.steady_tail.S_MAX`` states takes one kernel
    (``ops.steady_tail.steady_tail``) that runs the whole tail, its loop
    included. Otherwise every round computes its candidate and keeps it
    only while the 0-dim flag ``residual > tol`` holds, and a CUDA graph of
    a step takes the rounds as conditional nodes instead
    (``_graph.steady_state_conditional``); an f32 ``fm`` of more than
    ``S_MAX`` states takes that tail in float64, on the CPU and on CUDA
    (``ops.steady_tail.tail_dtype``), where its f32 residual would sit at
    its rounding floor. Returns ``(T, p, flux, residual)``.
    """
    if steady_tail.uses_kernel(fm.device, fm.dtype, fm.shape[0]):
        return steady_tail.steady_tail(fm, basis_mask, target_mask, n_iters,
                                       tol, max_extra_squarings)[:4]
    return _steady_state(fm, basis_mask, target_mask, n_iters, tol,
                         max_extra_squarings, _where_rounds)
