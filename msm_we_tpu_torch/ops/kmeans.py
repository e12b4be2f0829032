"""Stratified k-means primitives in PyTorch.

Counterpart of ``msm_we_tpu/ops/kmeans.py``: the masked stratified scores
and assignment, and the streaming (running weighted mean) center updates.
Seeding (``kmeans_plusplus``, ``lloyd``, ``seed_bin``, ``seed_bins_batched``,
``kmeans_fit``) is not ported yet (ROADMAP, queue 1): the build's seeding
runs on the host numpy family of ``ops/stratified.py``.

Scores are ``|c|^2 - 2 x.c`` (the per-row ``|x|^2`` is argmin-invariant and
dropped), masked to valid centers of the row's WE bin. The JAX package
folds the mask into the GEMM as a one-hot penalty block for up to 64 bins,
a layout choice for XLA's matmul->argmin fusion; here one elementwise mask
serves every bin count, and on CUDA the assignment is the hand-written
kernel of ``ops/stratified_assign.py``, which never builds the (N, K)
score matrix.
"""
from __future__ import annotations

import torch

__all__ = [
    "pairwise_dist2",
    "masked_scores",
    "masked_assign",
    "minibatch_update",
    "masked_minibatch_step",
    "masked_minibatch_scan",
]

# Masked score: float32 3.4e38, the JAX package's _BIG (an all-masked row
# then takes index 0, as jnp.argmin and the Pallas min-of-iota do)
_BIG = 3.4e38


def pairwise_dist2(X, C):
    """Squared Euclidean distances, (N, d) x (K, d) -> (N, K)."""
    x2 = (X * X).sum(1, keepdim=True)
    c2 = (C * C).sum(1)[None, :]
    return x2 - 2.0 * (X @ C.T) + c2


def masked_scores(X, seg_bin, C, center_bin, valid, c2=None):
    """Per row, every valid center in the row's WE bin scores
    ``|c|^2 - 2 x.c`` (``c2`` overrides ``|c|^2``); everything else
    scores ``_BIG``."""
    if c2 is None:
        c2 = (C * C).sum(1)
    scores = c2[None, :] - 2.0 * (X @ C.T)
    ok = valid[None, :] & (center_bin[None, :] == seg_bin[:, None])
    return torch.where(ok, scores, torch.full_like(scores, _BIG))


def masked_assign(X, seg_bin, C, center_bin, valid, n_bins=None):
    """Nearest valid center within each row's WE bin: the flat center-row
    index (int32) per row. On CUDA tensors this is the H4-family kernel
    (``pair_assign`` on one row set); on CPU tensors the dense plain
    version. ``n_bins`` is accepted for signature parity with the JAX
    function and does not change the result."""
    from .stratified_assign import pair_assign

    del n_bins
    return pair_assign(
        None, X.contiguous(), None, seg_bin.to(torch.int32).contiguous(),
        C.contiguous(), center_bin.to(torch.int32).contiguous(),
        valid.to(torch.bool).contiguous(),
    )


def _segment_sums(values, idx, k):
    """Per-center sums of ``values`` rows in an order fixed by the data:
    rows are stably sorted by center id, then each center's run is reduced
    by ``segment_reduce``, which assigns no two threads to one output (no
    atomics). CUDA's ``index_add_`` adds in atomic order, so two runs on
    the same inputs could differ in the last bits."""
    idx_sorted, order = torch.sort(idx, stable=True)
    lengths = torch.bincount(idx_sorted, minlength=k)
    return torch.segment_reduce(values.index_select(0, order), "sum",
                                lengths=lengths, axis=0, unsafe=True)


def minibatch_update(centers, counts, X, w, idx):
    """Streaming (running weighted mean) center update. Rows with ``w == 0``
    contribute exact zeros. Returns ``(new_centers, new_counts)``.

    On the CPU the sums are ``index_add_`` (serial, row order); on CUDA
    they are :func:`_segment_sums`, so repeated builds are bitwise equal."""
    k = centers.shape[0]
    idx = idx.to(torch.int64)
    if idx.device.type == "cpu":
        wsum = torch.zeros(k, dtype=w.dtype, device=w.device).index_add_(0, idx, w)
        xsum = torch.zeros_like(centers).index_add_(0, idx, X * w[:, None])
    else:
        sums = _segment_sums(torch.cat([X * w[:, None], w[:, None]], dim=1), idx, k)
        xsum, wsum = sums[:, :-1].contiguous(), sums[:, -1].contiguous()
    new_counts = counts + wsum
    # Exact divisor: a 1e-30 clamp collapses the running mean for
    # sub-clamp f32 weight totals (WE weights span hundreds of decades)
    pos = new_counts > 0
    denom = torch.where(pos, new_counts, torch.ones_like(new_counts))
    new_centers = torch.where(
        pos[:, None], (centers * counts[:, None] + xsum) / denom[:, None],
        centers,
    )
    return new_centers, new_counts


def masked_minibatch_step(centers, counts, X, w, seg_bin, center_bin, valid,
                          n_bins=None):
    """Stratified assignment followed by the running-mean update."""
    idx = masked_assign(X, seg_bin, centers, center_bin, valid, n_bins=n_bins)
    return minibatch_update(centers, counts, X, w, idx)


def masked_minibatch_scan(centers, counts, X_all, eff_bin, w_all, init_mask,
                          starts, lengths, center_bin, valid, n_bins=None):
    """A run of streaming minibatch updates over row windows of ``X_all``.

    Batch ``b`` is the rows ``[starts[b], starts[b] + lengths[b])``. A row
    is inert (weight 0, bin -1) when excluded from training (``eff_bin``
    -1) or in a not-yet-initialized bin (``init_mask``); inert rows add
    exact zeros, so the loop equals the per-batch
    :func:`masked_minibatch_step` sequence over the live rows. Zero-length
    batches are skipped. ``w_all`` None trains unweighted (live rows weigh
    1). Each batch is assigned against the previous batch's centers, the
    MiniBatchKMeans streaming semantics. The JAX package runs this fold as
    one ``lax.scan``; here it is a loop of device launches that queue
    without a host sync.
    """
    c, n = centers, counts
    for start, length in zip(starts, lengths):
        start, length = int(start), int(length)
        if length <= 0:
            continue
        Xb = X_all[start:start + length]
        bb = eff_bin[start:start + length].to(torch.int64)
        ok = (bb >= 0) & init_mask[bb.clamp(min=0)]
        bb = torch.where(ok, bb, torch.full_like(bb, -1)).to(torch.int32)
        if w_all is None:
            wb = ok.to(X_all.dtype)
        else:
            wb = torch.where(
                ok, w_all[start:start + length], torch.zeros((), dtype=w_all.dtype,
                                                            device=w_all.device)
            )
        c, n = masked_minibatch_step(c, n, Xb, wb, bb, center_bin, valid,
                                     n_bins=n_bins)
    return c, n
