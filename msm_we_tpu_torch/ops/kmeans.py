"""Stratified and flat k-means primitives in PyTorch.

Counterpart of ``msm_we_tpu/ops/kmeans.py``: the masked stratified scores
and assignment, the streaming (running weighted mean) center updates, and
the device seeding family (``kmeans_plusplus``, ``lloyd``, ``seed_bin``,
``seed_bins_batched``, ``kmeans_fit``).

Scores are ``|c|^2 - 2 x.c`` (the per-row ``|x|^2`` is argmin-invariant and
dropped), masked to valid centers of the row's WE bin. The JAX package
folds the mask into the GEMM as a one-hot penalty block for up to 64 bins,
a layout choice for XLA's matmul->argmin fusion; here one elementwise mask
serves every bin count, and on CUDA the assignment is the hand-written
kernel of ``ops/stratified_assign.py``, which never builds the (N, K)
score matrix. A flat (one-bin) assignment is the same kernel with every
row and center in bin 0.

Sums per center run in an order fixed by the data on every device
(``_center_sums``), so repeated GPU builds are bitwise equal.

Weighted k-means++ cannot reproduce JAX's PRNG. Its draws are designed
instead: ``k`` uniforms per bin from a CPU ``torch.Generator``, and the
distances, scores and their prefix sums in float64 with a fixed
association (elementwise ops only), so a CPU and a CUDA seeding choose the
same rows bitwise. JAX draws with ``jax.random.choice`` over f32
probabilities; the two packages' seedings are different valid draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_device

__all__ = [
    "pairwise_dist2",
    "assign_flat",
    "masked_scores",
    "masked_assign",
    "kmeans_plusplus",
    "lloyd",
    "minibatch_update",
    "masked_minibatch_step",
    "masked_minibatch_scan",
    "seed_bin",
    "seed_bins_batched",
    "kmeans_fit",
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


def assign_flat(X, C, valid):
    """Nearest valid center of ``C`` for each row of ``X``: flat int32 ids.

    :func:`masked_assign` with every row and center in one bin, so on CUDA
    it is the H4 kernel (any feature width: one tile plan of one bin).
    JAX's ``assign_flat`` scores the full
    ``|x|^2 - 2 x.c + |c|^2`` and also returns the distance; this scores
    ``|c|^2 - 2 x.c``, so ids may differ from JAX's only at near-ties."""
    zeros_x = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    zeros_c = torch.zeros(C.shape[0], dtype=torch.int32, device=X.device)
    return masked_assign(X, zeros_x, C, zeros_c, valid)


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


def _center_sums(X, w, idx, k):
    """``(xsum (k, d), wsum (k,))``: the weighted row sums per center id.
    On the CPU ``index_add_`` (serial, row order); on CUDA
    :func:`_segment_sums`. Either way the order is fixed by the data, so
    repeated runs are bitwise equal."""
    idx = idx.to(torch.int64)
    if idx.device.type == "cpu":
        wsum = torch.zeros(k, dtype=w.dtype, device=w.device).index_add_(0, idx, w)
        xsum = torch.zeros((k, X.shape[1]), dtype=X.dtype,
                           device=X.device).index_add_(0, idx, X * w[:, None])
        return xsum, wsum
    sums = _segment_sums(torch.cat([X * w[:, None], w[:, None]], dim=1), idx, k)
    return sums[:, :-1].contiguous(), sums[:, -1].contiguous()


def minibatch_update(centers, counts, X, w, idx):
    """Streaming (running weighted mean) center update. Rows with ``w == 0``
    contribute exact zeros. Returns ``(new_centers, new_counts)``; the sums
    are :func:`_center_sums`."""
    xsum, wsum = _center_sums(X, w, idx, centers.shape[0])
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


# ----------------------------------------------------------------- seeding


def _uniforms(seed, k):
    """The ``k`` k-means++ uniforms of one seeding, in float64 from a CPU
    generator seeded ``seed``: the same draws on every device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.rand(k, generator=g, dtype=torch.float64)


def _prefix_sum(x):
    """Inclusive prefix sums along the last dim by doubling (Hillis-Steele):
    each step is one elementwise add, so the association is fixed and the
    result is bitwise the same on the CPU and on CUDA, run to run. (CUDA
    ``cumsum`` combines its blocks in an order that depends on timing.)"""
    s = 1
    while s < x.shape[-1]:
        x = torch.cat([x[..., :s], x[..., s:] + x[..., :-s]], dim=-1)
        s *= 2
    return x


def _sq_dist(X64, c64):
    """``|x - c|^2`` per row, (B, P, d) x (B, d) -> (B, P), summed over the
    features one elementwise add at a time (a fixed order on every
    device)."""
    diff = X64 - c64[:, None, :]
    sq = diff * diff
    acc = sq[..., 0]
    for f in range(1, sq.shape[-1]):
        acc = acc + sq[..., f]
    return acc


def _draw(cum, total, u):
    """Row ``i`` of each bin with ``cum[i - 1] <= u * total < cum[i]``: a
    draw proportional to the increments of ``cum``, so a row whose
    increment is zero (zero weight, padding, or already a center) is never
    chosen. The target stays strictly below ``total`` even where ``u *
    total`` rounds up to it; a bin with zero total takes row 0."""
    target = torch.minimum(u * total, torch.nextafter(total, torch.zeros_like(total)))
    idx = torch.searchsorted(cum, target[:, None].contiguous(), right=True)[:, 0]
    return torch.where(total > 0, idx.clamp(max=cum.shape[-1] - 1),
                       torch.zeros_like(idx))


def _kmeans_pp_batched(Xs, ws, k, uniforms):
    """Weighted k-means++ over B bins at once. ``Xs`` (B, P, d) f32, ``ws``
    (B, P), ``uniforms`` (B, k) f64. Returns ``(centers (B, k, d) f32,
    index (B, k) int64)``.

    Distances, scores and prefix sums are float64; the geometry (``Xs``)
    stays f32. When every score of a bin is zero (each distinct point is
    already a center, routine after WE splitting duplicates coordinates),
    the draw falls back to the base weight distribution, as in JAX."""
    B = Xs.shape[0]
    dev = Xs.device
    rows = torch.arange(B, device=dev)
    u = uniforms.to(dev)
    X64 = Xs.double()
    w64 = ws.double().clamp(min=0.0)
    cum0 = _prefix_sum(w64)
    total0 = cum0[:, -1].contiguous()
    idx = _draw(cum0, total0, u[:, 0])
    chosen = [idx]
    mind2 = _sq_dist(X64, X64[rows, idx])
    for i in range(1, k):
        cum = _prefix_sum(w64 * mind2)
        tot = cum[:, -1].contiguous()
        pos = tot > 0
        idx = _draw(torch.where(pos[:, None], cum, cum0),
                    torch.where(pos, tot, total0), u[:, i])
        chosen.append(idx)
        mind2 = torch.minimum(mind2, _sq_dist(X64, X64[rows, idx]))
    index = torch.stack(chosen, dim=1)
    return Xs[rows[:, None], index], index


def _lloyd_batched(Xs, ws, centers, n_iter):
    """Weighted Lloyd sweeps for B bins at once, then the assignment to the
    final centers. Returns ``(centers (B, k, d), wsum (B, k))``.

    Rows carry their bin index and the bank is the B x k centers, so each
    sweep is one :func:`masked_assign` (one H4 launch on CUDA) over every
    bin. Zero-weight rows get bin -1 (no candidate; they add exact zeros).
    Empty clusters keep their center; divisors are exact."""
    B, P, d = Xs.shape
    k = centers.shape[1]
    dev = Xs.device
    X = Xs.reshape(B * P, d)
    w = ws.reshape(B * P)
    bins = torch.arange(B, dtype=torch.int32, device=dev)
    row_bin = torch.where(w > 0, bins.repeat_interleave(P),
                          torch.full_like(w, -1, dtype=torch.int32))
    center_bin = bins.repeat_interleave(k)
    valid = torch.ones(B * k, dtype=torch.bool, device=dev)
    C = centers.reshape(B * k, d).contiguous()
    for _ in range(n_iter):
        xsum, wsum = _center_sums(X, w, masked_assign(X, row_bin, C, center_bin, valid),
                                  B * k)
        pos = wsum > 0
        C = torch.where(pos[:, None],
                        xsum / torch.where(pos, wsum, torch.ones_like(wsum))[:, None], C)
    _xsum, wsum = _center_sums(X, w, masked_assign(X, row_bin, C, center_bin, valid),
                               B * k)
    return C.reshape(B, k, d), wsum.reshape(B, k)


def kmeans_plusplus(X, w, k, generator, return_index=False):
    """Weighted k-means++ seeding of ``k`` centers from the rows of ``X``
    (N, d) f32 with weights ``w`` (N,), on the device of ``X``.

    The ``k`` uniforms come from ``generator``, a CPU ``torch.Generator``,
    so a CPU and a CUDA call with equally seeded generators choose the same
    rows; rows with weight 0 are never chosen. JAX's ``kmeans_plusplus``
    draws from its own PRNG with f32 probabilities, so the two packages
    choose different (equally valid) rows. With ``return_index`` also
    returns the chosen row indices."""
    u = torch.rand(k, generator=generator, dtype=torch.float64)
    centers, index = _kmeans_pp_batched(X[None], w[None], k, u[None])
    return (centers[0], index[0]) if return_index else centers[0]


def lloyd(X, w, centers, n_iter=25):
    """Weighted batch Lloyd iterations with a fixed iteration count (JAX
    ``lloyd``): each sweep assigns through :func:`assign_flat` (H4 on
    CUDA) and sums in a fixed order. Empty clusters keep their center."""
    out, _wsum = _lloyd_batched(X[None], w[None], centers[None], n_iter)
    return out[0]


def seed_bins_batched(seeds, Xs, ws, k, return_index=False):
    """Device seeding of B WE bins at once (JAX ``seed_bins_batched``):
    weighted k-means++, 5 Lloyd sweeps, the assignment to the final centers
    and the per-center weight sums. ``seeds`` holds one integer per bin,
    ``Xs`` (B, P, d) f32 and ``ws`` (B, P) are zero-weight padded to the
    largest member count P. Returns the packed (B, k, d+1) tensor
    (centers | weight sums), and the k-means++ row indices (B, k) with
    ``return_index``.

    Padded rows are inert in every stage. The draws are ``k`` uniforms per
    bin (:func:`_uniforms`), so unlike JAX's the result does not depend on
    P, and each bin's result is the one :func:`seed_bin` gives it alone."""
    u = torch.stack([_uniforms(s, k) for s in seeds])
    init, index = _kmeans_pp_batched(Xs, ws, k, u)
    cb, wsum = _lloyd_batched(Xs, ws, init, n_iter=5)
    packed = torch.cat([cb, wsum[..., None].to(cb.dtype)], dim=2)
    return (packed, index) if return_index else packed


def seed_bin(seed, X, w, k):
    """:func:`seed_bins_batched` for one bin: ``X`` (N, d), ``w`` (N,) ->
    the packed (k, d+1) centers | weight sums (JAX ``seed_bin``, with an
    integer seed in place of a PRNG key)."""
    return seed_bins_batched([seed], X[None], w[None], k)[0]


def kmeans_fit(X, w, k, seed=0, n_iter=50, minibatch=False, batch_size=4096,
               device="cuda", return_init=False):
    """Full weighted k-means fit on ``device``, the card by default (JAX
    ``kmeans_fit``): k-means++ from a generator seeded ``seed``, then
    ``n_iter`` Lloyd sweeps (or one streaming minibatch pass when
    ``minibatch`` and the data exceed ``batch_size``), then the final
    assignment. ``w`` None weighs every row 1. Returns numpy ``(centers,
    ids)``, and the k-means++ row indices with ``return_init``."""
    device = as_device(device)
    X = torch.as_tensor(np.asarray(X, np.float32), device=device).contiguous()
    w = (torch.ones(X.shape[0], dtype=torch.float32, device=device) if w is None
         else torch.as_tensor(np.asarray(w, np.float32), device=device))
    valid = torch.ones(k, dtype=torch.bool, device=device)
    centers, init = kmeans_plusplus(X, w, k, torch.Generator().manual_seed(int(seed)),
                                    return_index=True)
    if not minibatch or X.shape[0] <= batch_size:
        centers = lloyd(X, w, centers, n_iter=n_iter)
    else:
        counts = torch.zeros(k, dtype=torch.float32, device=device)
        for start in range(0, X.shape[0], batch_size):
            xb, wb = X[start:start + batch_size], w[start:start + batch_size]
            centers, counts = minibatch_update(centers, counts, xb, wb,
                                               assign_flat(xb, centers, valid))
    ids = assign_flat(X, centers, valid)
    out = (centers.cpu().numpy(), ids.cpu().numpy().astype(np.int64))
    return (*out, init.cpu().numpy()) if return_init else out
