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
their plain versions on CPU tensors; ``_apply_overrides`` and
``_scatter_flux`` live there, beside the plain versions that use them.
The steady-state tail decides its route here (:func:`steady_state_from_flux`).

The center bank must be compact (valid centers first, in global-id order):
the row index of the winning center is its global cluster id.
"""
from __future__ import annotations

import torch

from . import _graph
from ._device import f64_threshold
from .ops import steady_tail
from .ops.steady_tail import _fixed_squarings
from .ops.stratified_assign import (
    _apply_overrides,
    _scatter_flux,
    assign_flux,
    pair_assign,
)

__all__ = [
    "fused_step_single",
    "steady_state_from_flux",
    "pair_assign_predict",
    "single_assign_predict",
    "cluster_stats",
]


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


def _target_flux(T, p, target_mask):
    return (torch.where(target_mask[None, :], T, torch.zeros_like(T))
            * p[:, None]).sum()


def _round(Tn, T):
    """One extra squaring: ``Tn`` squared, its stationary vector and
    residual."""
    Tc = _square(Tn)
    return (Tc, *_stationary(Tc, T))


def _where_rounds(Tn, p, residual, T, tol, n_rounds):
    """Guarded rounds: each computes its candidate and keeps it only where
    the 0-dim flag ``residual > tol`` holds, so a round after convergence
    changes nothing (the early-exit loop's result, no host read)."""
    for _ in range(n_rounds):
        go = residual > tol
        Tc, pc, rc = _round(Tn, T)
        Tn = torch.where(go, Tc, Tn)
        p = torch.where(go, pc, p)
        residual = torch.where(go, rc, residual)
    return Tn, p, residual


def _conditional_rounds(Tn, p, residual, T, tol, n_rounds):
    """:func:`_where_rounds` inside a capture by ``_graph``: each round is a
    conditional node on ``residual > tol`` (so a round after convergence
    launches no more than the flag's kernels) and writes its result into
    the tail's own ``Tn``, ``p`` and ``residual``, whose addresses the rest
    of the graph reads. In a traced capture each round taken adds one to
    the counter ``tail_rounds``."""
    rounds = _graph.counter("tail_rounds")
    for _ in range(n_rounds):
        with _graph.conditional(residual > tol):
            if rounds is not None:
                rounds.add_(1)
            Tc, pc, rc = _round(Tn, T)
            Tn.copy_(Tc)
            p.copy_(pc)
            residual.copy_(rc)
    return Tn, p, residual


def _rounds(Tn, p, residual, T, tol, n_rounds):
    """The PyTorch tail's extra rounds: conditional nodes inside a capture
    by ``_graph`` (``_graph.capturing()``, host state), else guarded
    rounds."""
    rounds = _conditional_rounds if _graph.capturing() else _where_rounds
    return rounds(Tn, p, residual, T, tol, n_rounds)


def _steady_state(fm, basis_mask, target_mask, n_iters, tol,
                  max_extra_squarings, rounds, dtype):
    """The PyTorch tail in ``dtype``, its extra squarings taken by
    ``rounds`` (:func:`_rounds`, :func:`_where_rounds` or
    :func:`_conditional_rounds`). ``tol`` becomes the largest number of
    ``dtype`` not above it, so the device comparison decides as a host read
    would. The outputs are in ``fm``'s dtype."""
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
    first round whose residual is ``<= tol``, else the last).

    The route is decided here, from what the input shows. A CUDA f32 ``fm``
    of at most ``ops.steady_tail.S_MAX`` states takes one kernel
    (``ops.steady_tail.uses_kernel``, ``steady_tail``) that runs the whole
    tail, its loop included. Otherwise the PyTorch tail runs in
    ``ops.steady_tail.tail_dtype`` (float64 for an f32 ``fm`` of more than
    ``S_MAX`` states, on the CPU and on CUDA, where its f32 residual would
    sit at its rounding floor), its rounds taken by :func:`_rounds`: inside
    a capture by ``_graph`` conditional nodes (:func:`_conditional_rounds`),
    elsewhere each round computes its candidate and keeps it only while
    the 0-dim flag ``residual > tol`` holds (:func:`_where_rounds`). In a
    traced capture the tail marks ``device_ms["tail"]`` where it starts,
    counts its route (``tail_fused``, ``tail_f64``) and its rounds
    (``tail_rounds``). Returns ``(T, p, flux, residual)``.
    """
    S = fm.shape[0]
    kernel = steady_tail.uses_kernel(fm.device, fm.dtype, S)
    dtype = steady_tail.tail_dtype(fm.dtype, S)
    _graph.mark("tail")
    _graph.count("tail_fused", kernel)
    _graph.count("tail_f64", dtype != fm.dtype)
    if kernel:
        return steady_tail.steady_tail(
            fm, basis_mask, target_mask, n_iters, tol, max_extra_squarings,
            counter=_graph.counter("tail_rounds"))[:4]
    return _steady_state(fm, basis_mask, target_mask, n_iters, tol,
                         max_extra_squarings, _rounds, dtype)
