"""Fused stratified assignment kernels and their plain PyTorch versions.

Counterpart of ``msm_we_tpu/ops/pallas_kernels.py``. Each wrapper is named
for its Pallas kernel and launches its kernel on CUDA tensors: H1 and H2
of ``csrc/stratified_assign.cu``, H3 of ``csrc/assign_flux.cu``, H4 of
``csrc/pair_assign.cu``:

==========================  ==============================================
``transform_assign_child``  H1 ``fused_transform_assign_child``
``transform_assign``        H2 ``fused_transform_assign``
``assign_flux``             H3 ``fused_assign_flux``
``pair_assign``             H4 ``_assign_call``
==========================  ==============================================

What the Pallas wrappers needed for Mosaic is gone: no (n, 1) columns, no
128-padding, no one-hot flux matmul. Two differences from the Pallas
kernels are deliberate, so that the kernels serve production:

* scores are the production ``|c|^2 - 2 x.c`` (``ops/kmeans.py``), or
  ``c2adj - 2 (x P).c`` with the PCA centering folded into ``c2adj`` for
  the transform entry points (and for H3 given ``c2adj`` and the
  uncentered ``x P``) -- never ``|x|^2 - 2 x.c + |c|^2``;
* the parent target override ``target_p`` is applied (flux order: before
  basis, so basis wins; predict order: last, so target wins), as
  ``parallel/sharded.py::_apply_overrides`` does.

The bank must be compact (valid centers first, in global-id order), so the
row index of the winning center is its global cluster id.

Every kernel takes any feature width. H1/H2 stream the raw rows and P
through shared memory into a register tile of rows x features, keep a
block's feature rows in a shared memory tile and stream the bank past it.
H3 and H4 score a row against its own bin's centers only. Both start from
the same plan kernels (``_plan_keys``: the bank sorted stably by bin and
each row's group, with no host synchronisation; ``_plan_keys_plain`` is
its plain version). H4 then groups the rows by bin across the launch
(``_bin_tiles``: one stable ``torch.sort`` and a tile table;
``_bin_tiles_plain``), one tile of one bin a block. H3 keeps the parent
and child rows of ``SEGMENTS_PER_BLOCK`` segments in one block, so that
each segment's two ids meet for the flux, and groups those rows by bin
inside the block, a warp scoring up to ``TASK_ROWS`` rows of one bin at a
time.

A wrapper given CPU tensors runs the ``*_plain`` version beside it (dense
masked scores, ``argmin``, ``_apply_overrides``, ``index_add_``). Given CUDA
tensors it checks device, dtype, shape and contiguity, launches the kernel
on the current stream without synchronising, and raises on a launch error.
There is no fallback between the two. Each wrapper counts its kernel
launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from ._ext import _count_launch, check, library
from .kmeans import masked_scores
from .steady_tail import steady_tail

__all__ = [
    "transform_assign_child",
    "transform_assign_child_plain",
    "transform_assign",
    "transform_assign_plain",
    "assign_flux",
    "assign_flux_plain",
    "pair_assign",
    "pair_assign_plain",
    "c2adj",
    "launch_counts",
    "reset_launch_counts",
]

TILE_ROWS = 64  # rows per H4 tile (kTileRows in csrc/pair_assign.cu)
SEGMENTS_PER_BLOCK = 512  # segments per H3 block (kSegs in csrc/assign_flux.cu)
TASK_ROWS = 32  # rows of one bin an H3 warp scores at once (kTaskRows)
_NO_BIN = 2**40  # sort key of an invalid center: no row bin reaches it
_ORDERS = {None: 0, "flux": 1, "predict": 2}


def c2adj(mean, proj, centers):
    """``|c|^2 + 2 (mu P).c``: the centering of ``(x - mu) P`` folded into
    the bank, so a kernel scores raw rows as ``c2adj - 2 (x P).c``."""
    bias = mean @ proj
    return (centers * centers).sum(1) + 2.0 * (centers @ bias)


def _argmin(X, bins, centers, center_bin, valid, c2=None):
    return torch.argmin(
        masked_scores(X, bins, centers, center_bin, valid, c2=c2), dim=1
    ).to(torch.int32)


def _apply_overrides(pidx, cidx, basis_p, basis_c, target_c, n_states,
                     target_p=None, predict_order=False):
    """Basis/target overrides. ``predict_order`` (the reference's predict,
    used for dtrajs): target is checked last, so target wins rows inside
    both regions. Flux order (the reference's flux build): end-in-target,
    then start-in-target (``target_p``), then basis for both ends, so
    basis wins."""
    B, T = n_states - 2, n_states - 1
    if predict_order:
        pidx = _where(basis_p, B, pidx)
        cidx = _where(basis_c, B, cidx)
        pidx = _where(target_p, T, pidx)
        cidx = _where(target_c, T, cidx)
    else:
        cidx = _where(target_c, T, cidx)
        pidx = _where(target_p, T, pidx)
        pidx = _where(basis_p, B, pidx)
        cidx = _where(basis_c, B, cidx)
    return pidx.to(torch.int32), cidx.to(torch.int32)


def _scatter_flux(pidx, cidx, w, n_states):
    """(S, S) flux of ``w`` at (parent, child), accumulated in the dtype of
    ``w``: f64 weights give the facade's parity-grade flux (WE weights span
    hundreds of decades; an f32 scatter would flush small ones)."""
    flat = pidx.to(torch.int64) * n_states + cidx.to(torch.int64)
    fm = torch.zeros(n_states * n_states, dtype=w.dtype, device=w.device)
    return fm.index_add_(0, flat, w).reshape(n_states, n_states)


# ------------------------------------------------------------------ plain


def transform_assign_child_plain(raw, bins, basis, target, mean, proj,
                                 centers, center_bin, valid, n_states,
                                 emit_features=False, features_only=False):
    """Plain H1: ``g = raw P``, masked nearest center on ``c2adj - 2 g.C``,
    target then basis override (basis wins). Returns ``(idx, g or None)``;
    with ``features_only``, ``(None, g)``."""
    g = raw @ proj
    if features_only:
        return None, g
    idx = _argmin(g, bins, centers, center_bin, valid,
                  c2=c2adj(mean, proj, centers))
    if target is not None:
        idx = torch.where(target, n_states - 1, idx)
    if basis is not None:
        idx = torch.where(basis, n_states - 2, idx)
    return idx.to(torch.int32), (g if emit_features else None)


def transform_assign_plain(raw_p, raw_c, pbins, cbins, w, basis_p, basis_c,
                           target_c, mean, proj, centers, center_bin, valid,
                           n_states, target_p=None, with_flux=True):
    """Plain H2: both row sets through the transform, flux-order overrides,
    and the (S, S) flux of ``w`` (in the dtype of ``w``) when
    ``with_flux``. Returns ``(pidx, cidx, fm or None)``."""
    a = c2adj(mean, proj, centers)
    pidx = _argmin(raw_p @ proj, pbins, centers, center_bin, valid, c2=a)
    cidx = _argmin(raw_c @ proj, cbins, centers, center_bin, valid, c2=a)
    pidx, cidx = _apply_overrides(pidx, cidx, basis_p, basis_c, target_c,
                                  n_states, target_p=target_p)
    fm = _scatter_flux(pidx, cidx, w, n_states) if with_flux else None
    return pidx, cidx, fm


def assign_flux_plain(fp, fc, pbins, cbins, w, basis_p, basis_c, target_c,
                      centers, center_bin, valid, n_states, target_p=None,
                      c2=None):
    """Plain H3: assign both feature sets on ``c2 - 2 x.c`` (``c2`` None:
    ``|c|^2``), flux-order overrides, flux. Returns ``(pidx, cidx, fm)``."""
    pidx = _argmin(fp, pbins, centers, center_bin, valid, c2=c2)
    cidx = _argmin(fc, cbins, centers, center_bin, valid, c2=c2)
    pidx, cidx = _apply_overrides(pidx, cidx, basis_p, basis_c, target_c,
                                  n_states, target_p=target_p)
    return pidx, cidx, _scatter_flux(pidx, cidx, w, n_states)


def _argmin_scores(X, bins, centers, center_bin, valid):
    """Ids and winning scores of the masked nearest center: the
    ``masked_scores`` minimum, ``+inf`` where the row's bin has no valid
    center (the kernel's ``best`` register then stays ``+inf``)."""
    scores = masked_scores(X, bins, centers, center_bin, valid)
    idx = torch.argmin(scores, dim=1)
    best = scores.gather(1, idx[:, None])[:, 0]
    has = (valid[None, :] & (center_bin[None, :] == bins[:, None])).any(1)
    return idx.to(torch.int32), torch.where(has, best, float("inf"))


def pair_assign_plain(fp, fc, pbins, cbins, centers, center_bin, valid,
                      n_states=None, basis_p=None, basis_c=None,
                      target_p=None, target_c=None, order=None,
                      return_scores=False):
    """Plain H4: nearest valid same-bin center ids, optionally followed by
    the override epilogue (``order`` None, ``"flux"`` or ``"predict"``).
    With ``fp=None`` only the ``fc`` rows are assigned and ``cidx`` alone
    is returned; otherwise ``(pidx, cidx)``. ``return_scores`` (no
    overrides) appends the f32 winning scores: ``(cidx, cmin)`` or
    ``(pidx, cidx, pmin, cmin)``."""
    _check_order(order, n_states)
    _check_scores(return_scores, order)
    if return_scores:
        cidx, cmin = _argmin_scores(fc, cbins, centers, center_bin, valid)
        if fp is None:
            return cidx, cmin
        pidx, pmin = _argmin_scores(fp, pbins, centers, center_bin, valid)
        return pidx, cidx, pmin, cmin
    cidx = _argmin(fc, cbins, centers, center_bin, valid)
    pidx = None if fp is None else _argmin(
        fp, pbins, centers, center_bin, valid
    )
    if order is not None:
        if pidx is None:
            B, T = n_states - 2, n_states - 1
            if order == "predict":
                cidx = _where(basis_c, B, cidx)
                cidx = _where(target_c, T, cidx)
            else:
                cidx = _where(target_c, T, cidx)
                cidx = _where(basis_c, B, cidx)
        else:
            pidx, cidx = _apply_overrides(
                pidx, cidx, basis_p, basis_c, target_c, n_states,
                target_p=target_p, predict_order=order == "predict",
            )
    return cidx if pidx is None else (pidx, cidx)


def _where(mask, value, idx):
    return idx if mask is None else torch.where(mask, value, idx)


def _check_order(order, n_states):
    if order not in _ORDERS:
        raise ValueError(f"order must be None, 'flux' or 'predict', got {order!r}")
    if order is not None and n_states is None:
        raise ValueError("overrides need n_states")


def _check_scores(return_scores, order):
    # A score belongs to the raw winner; overrides apply after any combine
    if return_scores and order is not None:
        raise ValueError("scores come only without overrides (order=None)")


# ----------------------------------------------------------------- kernels


def _on_cuda(t, name):
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} is on unsupported device {t.device}")


def _check(t, name, dtype, shape, device, optional=False):
    if t is None:
        if optional:
            return
        raise ValueError(f"{name} is required")
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bank(centers, center_bin, valid, F, device):
    if centers.dim() != 2 or centers.shape[1] != F:
        raise ValueError(f"centers must be (K, {F}), got {tuple(centers.shape)}")
    K = centers.shape[0]
    if K == 0:
        raise ValueError("the center bank is empty")
    _check(centers, "centers", torch.float32, (K, F), device)
    _check(center_bin, "center_bin", torch.int32, (K,), device)
    _check(valid, "valid", torch.bool, (K,), device)
    return K


def _check_rows(n):
    if n >= 2**31:
        raise ValueError(f"{n} rows exceed the kernel's 32-bit row index")


def _plan_keys_plain(pbins, cbins, center_bin, valid):
    """The first half of the H4 plan and all of H3's, in plain torch.

    The plan's rows are the parent rows (``pbins``; None: none), then the
    child rows (``cbins``). Valid centers are sorted stably by bin, invalid
    ones last (``cperm``: sorted position -> center id; the identity for a
    compact bank ordered by bin; ``ckey``: the sorted bins, ``2**40`` for
    an invalid center). A row's group (``rkey``) is the sorted position of
    its bin's first valid center; rows whose bin has no valid center (bin
    -1 included) form the last group, ``K``, which has no centers. The
    centers of group ``g`` are ``cperm[g:g + n]``, where ``n`` counts the
    entries of ``ckey`` equal to ``ckey[g]``. Returns ``(cperm int32, ckey
    int64, rkey int32)``.
    """
    bins = cbins if pbins is None else torch.cat([pbins, cbins])
    K = center_bin.shape[0]
    ckey, cperm = torch.sort(
        torch.where(valid, center_bin.long(), _NO_BIN), stable=True)
    b = bins.long()
    lo = torch.searchsorted(ckey, b)
    hi = torch.searchsorted(ckey, b, right=True)
    rkey = torch.where(hi > lo, lo, K)
    return cperm.to(torch.int32), ckey, rkey.to(torch.int32)


def _plan_keys(pbins, cbins, center_bin, valid):
    """:func:`_plan_keys_plain` on the tensors' device: the plain version on
    the CPU; on CUDA the two plan kernels of ``csrc/pair_assign.cu``
    (``msm_pair_plan_keys``), equal to it element for element, with no
    host synchronisation. The tensors must already be checked."""
    if not _on_cuda(cbins, "cbins"):
        return _plan_keys_plain(pbins, cbins, center_bin, valid)
    dev = cbins.device
    n = cbins.shape[0]
    R = n if pbins is None else 2 * n
    K = center_bin.shape[0]
    ws = torch.empty(K + R, dtype=torch.int32, device=dev)
    cperm, rkey = ws[:K], ws[K:]
    ckey = torch.empty(K, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' device context
        check(library().msm_pair_plan_keys(
            _ptr(pbins), _ptr(cbins), n, _ptr(center_bin), _ptr(valid), K,
            _ptr(cperm), _ptr(ckey), _ptr(rkey), _stream(dev),
        ), "plan keys")
    return cperm, ckey, rkey


def _bin_tiles_plain(pbins, cbins, center_bin, valid, tile_rows=TILE_ROWS):
    """The H4 launch plan in plain torch: rows grouped by bin, in tiles of
    one bin.

    Rows, ``cperm`` and the groups are those of :func:`_plan_keys_plain`.
    ``order`` sorts the rows stably by group. ``tiles`` (n_grid, 4) lists,
    per block, (first row in ``order``, rows, first center in ``cperm``,
    centers): at most ``tile_rows`` rows of one group, groups in order,
    then zero tiles up to ``n_grid = ceil(R / tile_rows) + min(K, R) + 1``,
    a bound on the tile count that needs no host synchronisation. Returns
    ``(order int64, cperm int32, tiles int32)``.
    """
    cperm, ckey, rkey = _plan_keys_plain(pbins, cbins, center_bin, valid)
    dev = ckey.device
    R, K = rkey.shape[0], center_bin.shape[0]
    rkey, order = torch.sort(rkey.long(), stable=True)
    # Rows and centers of each group g = 0..K
    bounds = torch.searchsorted(rkey, torch.arange(K + 2, device=dev))
    rstart, rcount = bounds[:-1], bounds[1:] - bounds[:-1]
    run_end = torch.searchsorted(ckey, ckey, right=True)
    ncent = torch.cat([run_end - torch.arange(K, device=dev),
                       torch.zeros(1, dtype=torch.long, device=dev)])
    ntiles = (rcount + tile_rows - 1) // tile_rows
    tend = torch.cumsum(ntiles, 0)
    n_grid = -(-R // tile_rows) + min(K, R) + 1
    t = torch.arange(n_grid, device=dev)
    g = torch.searchsorted(tend, t, right=True)  # K + 1 past the last tile
    live = g <= K
    g = g.clamp(max=K)
    j = t - (tend[g] - ntiles[g])  # tile number inside its group
    first = rstart[g] + j * tile_rows
    nrows = (rcount[g] - j * tile_rows).clamp(max=tile_rows)
    tiles = torch.stack([first, nrows, g, ncent[g]], 1)
    tiles = torch.where(live[:, None], tiles, torch.zeros_like(tiles))
    return order, cperm, tiles.to(torch.int32).contiguous()


def _bin_tiles(pbins, cbins, center_bin, valid):
    """The H4 launch plan (see :func:`_bin_tiles_plain`) on the tensors'
    device: the plain version on the CPU; on CUDA :func:`_plan_keys`, one
    stable ``torch.sort`` of the row groups and the tile kernels of
    ``csrc/pair_assign.cu``, equal to the plain version element for
    element, with no host synchronisation. The tensors must already be
    checked."""
    if not _on_cuda(cbins, "cbins"):
        return _bin_tiles_plain(pbins, cbins, center_bin, valid)
    dev = cbins.device
    cperm, ckey, rkey = _plan_keys(pbins, cbins, center_bin, valid)
    R, K = rkey.shape[0], center_bin.shape[0]
    n_grid = -(-R // TILE_ROWS) + min(K, R) + 1
    # One int32 workspace: the tiles (16-byte rows), then the per-group
    # scratch
    ws = torch.empty(4 * n_grid + 2 * K + 3, dtype=torch.int32, device=dev)
    tiles = ws[:4 * n_grid].view(n_grid, 4)
    scratch = ws[4 * n_grid:]
    with torch.cuda.device(dev):  # launch in the tensors' device context
        rkey_s, order = torch.sort(rkey, stable=True)
        check(library().msm_pair_plan_tiles(
            _ptr(rkey_s), R, _ptr(ckey), K, _ptr(scratch),
            _ptr(scratch) + 4 * (K + 2), _ptr(tiles), n_grid, _stream(dev),
        ), "pair_assign plan")
    return order, cperm, tiles


def _rows(n, device, names_values, dtype, optional=()):
    for name, t in names_values:
        _check(t, name, dtype, (n,), device, optional=name in optional)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_states(n_states):
    # The two override states follow the regular cluster ids
    if n_states is None or n_states < 3:
        raise ValueError(f"n_states must be >= 3, got {n_states}")


def transform_assign_child(raw, bins, basis, target, mean, proj, centers,
                           center_bin, valid, n_states, emit_features=False,
                           features_only=False):
    """H1 (``fused_transform_assign_child``): child rows only. ``raw`` (N, D)
    f32 -> ``g = raw P`` -> masked nearest center on ``c2adj - 2 g.C`` ->
    target then basis override. Returns ``(idx int32 (N,), g (N, F) or
    None)``; ``g`` excludes the centering (``g - mean P`` are the features).
    ``features_only``: the same kernel emits ``g`` and skips the scoring;
    returns ``(None, g)``.
    """
    if not _on_cuda(raw, "raw"):
        return transform_assign_child_plain(
            raw, bins, basis, target, mean, proj, centers, center_bin, valid,
            n_states, emit_features=emit_features,
            features_only=features_only,
        )
    dev = raw.device
    N, D = raw.shape
    F = proj.shape[1]
    _check(raw, "raw", torch.float32, (N, D), dev)
    _check(proj, "proj", torch.float32, (D, F), dev)
    _check(mean, "mean", torch.float32, (D,), dev)
    K = _check_bank(centers, center_bin, valid, F, dev)
    _rows(N, dev, [("bins", bins)], torch.int32)
    _rows(N, dev, [("basis", basis), ("target", target)], torch.bool,
          optional=("basis", "target"))
    _check_rows(N)
    _check_states(n_states)
    idx = None if features_only else torch.empty(N, dtype=torch.int32, device=dev)
    feats = (torch.empty((N, F), dtype=torch.float32, device=dev)
             if emit_features or features_only else None)
    if N == 0:
        return idx, feats
    # The scores' c2adj; a features-only launch reads no bank
    a = None if features_only else c2adj(mean, proj, centers).contiguous()
    with torch.cuda.device(dev):  # launch in the tensors' device context
        err = library().msm_transform_assign_child(
            _ptr(raw), _ptr(bins), _ptr(basis), _ptr(target), _ptr(proj),
            _ptr(centers), _ptr(a), _ptr(center_bin), _ptr(valid),
            N, D, F, K, n_states, _ptr(idx), _ptr(feats), _stream(dev),
        )
    check(err, "transform_assign_child")
    _count_launch(transform_assign_child)
    return idx, feats


def transform_assign(raw_p, raw_c, pbins, cbins, w, basis_p, basis_c,
                     target_c, mean, proj, centers, center_bin, valid,
                     n_states, target_p=None, with_flux=True):
    """H2 (``fused_transform_assign``): parent and child raw rows through the
    transform, masked assignment, flux-order overrides (``target_p`` before
    basis), and with ``with_flux`` the (S, S) flux of ``w`` accumulated in
    the dtype of ``w`` (f32 or f64). Returns ``(pidx, cidx, fm or None)``.
    """
    if not _on_cuda(raw_c, "raw_c"):
        return transform_assign_plain(
            raw_p, raw_c, pbins, cbins, w, basis_p, basis_c, target_c, mean,
            proj, centers, center_bin, valid, n_states, target_p=target_p,
            with_flux=with_flux,
        )
    dev = raw_c.device
    N, D = raw_c.shape
    F = proj.shape[1]
    _check(raw_p, "raw_p", torch.float32, (N, D), dev)
    _check(raw_c, "raw_c", torch.float32, (N, D), dev)
    _check(proj, "proj", torch.float32, (D, F), dev)
    _check(mean, "mean", torch.float32, (D,), dev)
    K = _check_bank(centers, center_bin, valid, F, dev)
    _rows(N, dev, [("pbins", pbins), ("cbins", cbins)], torch.int32)
    _rows(N, dev, [("basis_p", basis_p), ("basis_c", basis_c),
                   ("target_c", target_c), ("target_p", target_p)],
          torch.bool, optional=("target_p",))
    fm = None
    if with_flux:
        if w is None or w.dtype not in (torch.float32, torch.float64):
            raise TypeError("w must be a float32 or float64 tensor")
        _check(w, "w", w.dtype, (N,), dev)
        fm = torch.zeros((n_states, n_states), dtype=w.dtype, device=dev)
    _check_rows(N)
    _check_states(n_states)
    pidx = torch.empty(N, dtype=torch.int32, device=dev)
    cidx = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return pidx, cidx, fm
    a = c2adj(mean, proj, centers).contiguous()
    with torch.cuda.device(dev):  # launch in the tensors' device context
        err = library().msm_transform_assign(
            _ptr(raw_p), _ptr(raw_c), _ptr(pbins), _ptr(cbins), _ptr(basis_p),
            _ptr(basis_c), _ptr(target_p), _ptr(target_c),
            _ptr(w) if with_flux else None,
            int(with_flux and w.dtype == torch.float64),
            _ptr(proj), _ptr(centers), _ptr(a), _ptr(center_bin), _ptr(valid),
            N, D, F, K, n_states, _ptr(pidx), _ptr(cidx), _ptr(fm), _stream(dev),
        )
    check(err, "transform_assign")
    _count_launch(transform_assign)
    return pidx, cidx, fm


def assign_flux(fp, fc, pbins, cbins, w, basis_p, basis_c, target_c,
                centers, center_bin, valid, n_states, target_p=None, c2=None):
    """H3 (``fused_assign_flux``): features in, parent and child masked
    assignment, flux-order overrides (``target_p`` before basis), and the
    (S, S) flux of ``w`` in its dtype. Returns ``(pidx, cidx, fm)``. Any
    feature width: on CUDA the plan kernels (``_plan_keys``) give each row
    its bin's group, and the kernel groups each block's rows by bin and
    scores them against their bin's centers only.

    Scores are ``c2 - 2 x.c``, with ``c2`` (K,) f32 the centers' ``|c|^2``
    where None. Uncentered features ``g = raw P`` with ``c2 = c2adj(mean,
    P, centers)`` score bitwise as H2 scores its raw rows."""
    if not _on_cuda(fc, "fc"):
        return assign_flux_plain(
            fp, fc, pbins, cbins, w, basis_p, basis_c, target_c, centers,
            center_bin, valid, n_states, target_p=target_p, c2=c2,
        )
    dev = fc.device
    N, F = fc.shape
    _check(fp, "fp", torch.float32, (N, F), dev)
    _check(fc, "fc", torch.float32, (N, F), dev)
    K = _check_bank(centers, center_bin, valid, F, dev)
    _rows(N, dev, [("pbins", pbins), ("cbins", cbins)], torch.int32)
    _rows(N, dev, [("basis_p", basis_p), ("basis_c", basis_c),
                   ("target_c", target_c), ("target_p", target_p)],
          torch.bool, optional=("target_p",))
    if w is None or w.dtype not in (torch.float32, torch.float64):
        raise TypeError("w must be a float32 or float64 tensor")
    _check(w, "w", w.dtype, (N,), dev)
    _check(c2, "c2", torch.float32, (K,), dev, optional=True)
    _check_rows(2 * N)
    _check_states(n_states)
    pidx = torch.empty(N, dtype=torch.int32, device=dev)
    cidx = torch.empty(N, dtype=torch.int32, device=dev)
    fm = torch.zeros((n_states, n_states), dtype=w.dtype, device=dev)
    if N == 0:
        return pidx, cidx, fm
    cperm, ckey, rkey = _plan_keys(pbins, cbins, center_bin, valid)
    if c2 is None:
        c2 = (centers * centers).sum(1).contiguous()
    with torch.cuda.device(dev):  # launch in the tensors' device context
        err = library().msm_assign_flux(
            _ptr(fp), _ptr(fc), _ptr(basis_p), _ptr(basis_c), _ptr(target_p),
            _ptr(target_c), _ptr(w), int(w.dtype == torch.float64),
            _ptr(rkey), _ptr(cperm), _ptr(ckey), _ptr(centers), _ptr(c2),
            N, F, K, n_states, _ptr(pidx), _ptr(cidx), _ptr(fm), _stream(dev),
        )
    check(err, "assign_flux")
    _count_launch(assign_flux)
    return pidx, cidx, fm


def pair_assign(fp, fc, pbins, cbins, centers, center_bin, valid,
                n_states=None, basis_p=None, basis_c=None, target_p=None,
                target_c=None, order=None, return_scores=False):
    """H4 (``_assign_call``): nearest valid same-bin center ids for parent
    and child feature rows, plus an optional override epilogue (``order``
    None, ``"flux"`` or ``"predict"``; masks may be None). ``fp=None``
    assigns the ``fc`` rows alone and returns ``cidx``; otherwise returns
    ``(pidx, cidx)``, int32. Any feature width: on CUDA the rows are
    grouped by bin first (``_bin_tiles``) and the kernel scores each tile
    of one bin against that bin's centers only.

    ``return_scores`` (only with ``order=None``) also returns each row's
    f32 winning score from the same launch, ``+inf`` where the row's bin
    has no valid center (its id is then 0): ``(cidx, cmin)`` or ``(pidx,
    cidx, pmin, cmin)``. The ids are the same with or without it."""
    if not _on_cuda(fc, "fc"):
        return pair_assign_plain(
            fp, fc, pbins, cbins, centers, center_bin, valid,
            n_states=n_states, basis_p=basis_p, basis_c=basis_c,
            target_p=target_p, target_c=target_c, order=order,
            return_scores=return_scores,
        )
    _check_order(order, n_states)
    _check_scores(return_scores, order)
    dev = fc.device
    N, F = fc.shape
    pair = fp is not None
    _check(fc, "fc", torch.float32, (N, F), dev)
    _rows(N, dev, [("cbins", cbins)], torch.int32)
    masks = [("basis_c", basis_c), ("target_c", target_c)]
    if pair:
        _check(fp, "fp", torch.float32, (N, F), dev)
        _rows(N, dev, [("pbins", pbins)], torch.int32)
        masks += [("basis_p", basis_p), ("target_p", target_p)]
    elif basis_p is not None or target_p is not None or pbins is not None:
        raise ValueError("parent bins/masks given without parent rows")
    _rows(N, dev, masks, torch.bool, optional=[m for m, _ in masks])
    _check_bank(centers, center_bin, valid, F, dev)
    _check_rows(2 * N if pair else N)
    if order is not None:
        _check_states(n_states)
    cidx = torch.empty(N, dtype=torch.int32, device=dev)
    pidx = torch.empty(N, dtype=torch.int32, device=dev) if pair else None
    cmin = pmin = None
    if return_scores:
        cmin = torch.empty(N, dtype=torch.float32, device=dev)
        pmin = torch.empty(N, dtype=torch.float32, device=dev) if pair else None
    if N > 0:
        row_order, cperm, tiles = _bin_tiles(pbins if pair else None, cbins,
                                             center_bin, valid)
        c2 = (centers * centers).sum(1).contiguous()
        with torch.cuda.device(dev):  # launch in the tensors' device context
            err = library().msm_pair_assign(
                _ptr(fp), _ptr(fc), _ptr(basis_p), _ptr(basis_c),
                _ptr(target_p), _ptr(target_c), _ptr(row_order), _ptr(tiles),
                tiles.shape[0], _ptr(cperm), _ptr(centers), _ptr(c2), N, F,
                n_states or 0, _ORDERS[order], _ptr(pidx), _ptr(cidx),
                _ptr(pmin), _ptr(cmin), _stream(dev),
            )
        check(err, "pair_assign")
        _count_launch(pair_assign, return_scores)
    if return_scores:
        return (cidx, cmin) if not pair else (pidx, cidx, pmin, cmin)
    return cidx if not pair else (pidx, cidx)


# Every kernel wrapper of the port, by name: one reset and one read of their
# launch counts (the steady-state tail's kernel, ``ops/steady_tail.py``, too)
KERNELS = {
    "transform_assign_child": transform_assign_child,
    "transform_assign": transform_assign,
    "assign_flux": assign_flux,
    "pair_assign": pair_assign,
    "steady_tail": steady_tail,
}
# The CUDA kernel each wrapper launches, by its name in a trace (H1 and H2
# launch one template)
KERNEL_SYMBOLS = {
    "transform_assign_child": "stratified_assign_kernel",
    "transform_assign": "stratified_assign_kernel",
    "assign_flux": "assign_flux_kernel",
    "pair_assign": "pair_assign_kernel",
    "steady_tail": "steady_tail_kernel",
}
for _fn in KERNELS.values():
    _fn.launches = 0
# H4 launches with the score output (the mesh's model axis), also counted
# in pair_assign.launches
pair_assign.score_launches = 0


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    pair_assign.score_launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}

