"""Synthetic problems for tests, the entry point and the chip smoke run,
and the near-tie check that decides when two assignments may differ.

Counterpart of ``msm_we_tpu/testing.py`` (``tiny_stratified_problem``,
``pad_stratified_problem``) plus ``make_problem`` of ``bench.py`` (the hot
step's NTL9-scale shapes). numpy only: the same seed gives the same arrays
as the JAX package's generators. ``steady_state_early_exit`` is the plain
early-exit form of the hot step's steady-state tail and
``flux_order_bound`` the tolerance between two f32 fluxes summed in
different orders (torch).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "tiny_stratified_problem",
    "pad_stratified_problem",
    "make_problem",
    "near_tie_rows",
    "steady_state_early_exit",
    "flux_order_bound",
]


def tiny_stratified_problem(n_rows=64, d=8, n_bins=4, k=4, seed=0):
    """Rows + compact center bank for one fused discretize+flux step.
    Dyadic weights (j/16) make f32 cell sums exact under any order."""
    rng = np.random.default_rng(seed)
    K = n_bins * k
    return dict(
        fp=rng.normal(size=(n_rows, d)).astype(np.float32),
        fc=rng.normal(size=(n_rows, d)).astype(np.float32),
        pbins=rng.integers(0, n_bins, n_rows).astype(np.int32),
        cbins=rng.integers(0, n_bins, n_rows).astype(np.int32),
        basis_p=(rng.random(n_rows) < 0.1),
        basis_c=(rng.random(n_rows) < 0.05),
        target_c=(rng.random(n_rows) < 0.05),
        w=(rng.integers(1, 17, n_rows) / 16.0).astype(np.float32),
        centers=rng.normal(size=(K, d)).astype(np.float32),
        center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k),
        valid=np.ones(K, bool),
        n_states=K + 2,
    )


def pad_stratified_problem(problem, n_pad, k_pad):
    """Pad a :func:`tiny_stratified_problem` to ``n_pad`` rows and a
    ``k_pad``-row bank with inert entries (rows: bin -1, weight 0, masks
    False; bank: bin -2, invalid). Padding must not change the answer."""
    from .features import _pad_rows_to

    p = dict(problem)
    fills = dict(
        fp=0.0, fc=0.0, pbins=-1, cbins=-1,
        basis_p=False, basis_c=False, target_c=False, w=0.0,
    )
    for key, fill in fills.items():
        p[key] = _pad_rows_to(np.asarray(problem[key]), n_pad, fill)
    K = len(problem["valid"])
    if k_pad < K or n_pad < len(problem["w"]):
        raise ValueError("padding cannot shrink the problem")
    p["centers"] = _pad_rows_to(np.asarray(problem["centers"]), k_pad, 0.0)
    p["center_bin"] = _pad_rows_to(np.asarray(problem["center_bin"]), k_pad, -2)
    p["valid"] = _pad_rows_to(np.asarray(problem["valid"]), k_pad, False)
    return p


def make_problem(n_segments=102_400, n_raw_features=900, n_components=30,
                 n_bins=10, k_per_bin=25, seed=0, fallback_frac=0.02):
    """NTL9-scale stratified-assignment problem (``bench.py::make_problem``,
    same seed -> same arrays).

    Raw features are ~300 atoms x 3 coordinates, projected to
    ``n_components`` by a PCA fitted on a subsample. Each segment's parent
    frame is a bit-copy of another segment's child frame (``parent_rows``),
    except a ``fallback_frac`` recycled fraction (``parent_rows == -1``)
    with independent basis-region frames (``raw_fallback``).
    """
    rng = np.random.default_rng(seed)
    n_fb = max(int(n_segments * fallback_frac), 1)
    parent_rows = rng.permutation(n_segments).astype(np.int32)
    fb_idx = np.sort(rng.choice(n_segments, n_fb, replace=False)).astype(np.int32)

    pc_child = 10 * rng.beta(0.7, 0.7, n_segments)
    pc_parent = pc_child[parent_rows].copy()
    pc_parent[fb_idx] = 9.0 + rng.random(n_fb)  # recycled: basis region
    parent_rows[fb_idx] = -1

    def embed(pc):
        base = np.outer(pc, rng.normal(1, 0.2, n_raw_features) * 0.3)
        return (base + rng.normal(0, 0.3, base.shape)).astype(np.float32)

    raw_child = embed(pc_child)
    raw_fallback = embed(pc_parent[fb_idx])
    raw_parent = raw_child[np.where(parent_rows < 0, 0, parent_rows)].copy()
    raw_parent[fb_idx] = raw_fallback

    sub = raw_child[:: max(1, n_segments // 4096)]
    mean = sub.mean(0)
    cov = np.cov((sub - mean).T)
    evals, evecs = np.linalg.eigh(cov)
    comp = evecs[:, np.argsort(evals)[::-1][:n_components]].astype(np.float32)

    edges = np.linspace(0, 10, n_bins + 1)
    pbins = np.clip(np.digitize(pc_parent, edges) - 1, 0, n_bins - 1).astype(np.int32)
    cbins = np.clip(np.digitize(pc_child, edges) - 1, 0, n_bins - 1).astype(np.int32)

    feats_sub = (sub - mean) @ comp
    K = n_bins * k_per_bin
    centers = np.zeros((K, n_components), np.float32)
    sub_pc = pc_child[:: max(1, n_segments // 4096)]
    sub_bins = np.clip(np.digitize(sub_pc, edges) - 1, 0, n_bins - 1)
    for b in range(n_bins):
        members = feats_sub[sub_bins == b]
        if len(members) >= k_per_bin:
            idx = rng.choice(len(members), k_per_bin, replace=False)
            centers[b * k_per_bin : (b + 1) * k_per_bin] = members[idx]
        else:
            centers[b * k_per_bin : (b + 1) * k_per_bin] = rng.normal(
                0, 1, (k_per_bin, n_components)
            )

    weights = np.exp(rng.uniform(np.log(1e-12), 0, n_segments))
    weights /= weights.sum()

    return dict(
        raw_parent=raw_parent, raw_child=raw_child,
        parent_rows=parent_rows, fb_idx=fb_idx, raw_fallback=raw_fallback,
        mean=mean.astype(np.float32), comp=comp,
        pbins=pbins, cbins=cbins,
        basis_p=(pc_parent > 9.0), basis_c=(pc_child > 9.0),
        target_c=(pc_child < 1.0),
        w=weights.astype(np.float32),
        centers=centers,
        center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k_per_bin),
        valid=np.ones(K, bool),
        n_states=K + 2,
    )


_EPS32 = float(np.finfo(np.float32).eps)


def near_tie_rows(rows, ids_a, ids_b, X, bins, centers, center_bin, valid,
                  c2=None, raw=None, proj=None):
    """For each row in ``rows`` (where two assignments disagree), True when
    the disagreement is a near-tie: both chosen centers are valid members
    of the row's bin and score, recomputed in f64 from the f32 inputs,
    within f32 rounding of the f64 minimum.

    The rounding bound is the standard one for an f32 dot product of
    length m, ``m * eps32 * sum |terms|``, taken over the score
    ``c2 - 2 x.c``. With ``raw``/``proj`` given, ``X`` is ``raw @ proj``
    and the bound also covers the D-term transform. Ids are compared raw
    (before any override); override states must be masked out by the
    caller.
    """
    rows = np.asarray(rows, np.int64)
    out = np.zeros(len(rows), bool)
    C = np.asarray(centers, np.float64)
    cb = np.asarray(center_bin)
    vl = np.asarray(valid, bool)
    c2v = (C * C).sum(1) if c2 is None else np.asarray(c2, np.float64)
    for j, r in enumerate(rows):
        cand = np.flatnonzero(vl & (cb == bins[r]))
        a, b = int(ids_a[r]), int(ids_b[r])
        if not (np.isin(a, cand) and np.isin(b, cand)):
            continue
        if raw is not None:
            xr = np.asarray(raw[r], np.float64)
            P = np.asarray(proj, np.float64)
            x = xr @ P
            # |g| error from the D-term sums, propagated into 2 g.c
            g_err = raw.shape[1] * _EPS32 * (np.abs(xr) @ np.abs(P))
        else:
            x = np.asarray(X[r], np.float64)
            g_err = np.zeros_like(x)
        s = c2v[cand] - 2.0 * (C[cand] @ x)
        mag = (
            np.abs(c2v[cand]) + 2.0 * (np.abs(C[cand]) @ np.abs(x))
        ) * (C.shape[1] + 2) * _EPS32 + 2.0 * (np.abs(C[cand]) @ g_err)
        smin = s.min()
        ia = np.flatnonzero(cand == a)[0]
        ib = np.flatnonzero(cand == b)[0]
        out[j] = (s[ia] - smin <= mag[ia] + mag.max()) and (
            s[ib] - smin <= mag[ib] + mag.max()
        )
    return out


def steady_state_early_exit(fm, basis_mask, target_mask, n_iters=512, tol=1e-6,
                            max_extra_squarings=16):
    """``step.steady_state_from_flux`` as a loop that reads the residual on
    the host before each extra squaring and stops at the first one within
    ``tol``: the plain reference of its device-side check. Returns ``(T, p,
    flux, residual, n_extra)``, ``n_extra`` the extra squarings taken."""
    from .step import (
        _fixed_squarings,
        _square,
        _stationary,
        _target_flux,
        _transition_matrix,
    )

    T = _transition_matrix(fm, basis_mask, target_mask)
    Tn = T
    for _ in range(_fixed_squarings(n_iters)):
        Tn = _square(Tn)
    p, residual = _stationary(Tn, T)
    n_extra = 0
    while n_extra < max_extra_squarings and float(residual) > tol:
        Tn = _square(Tn)
        p, residual = _stationary(Tn, T)
        n_extra += 1
    return T, p, _target_flux(T, p, target_mask), residual, n_extra


def flux_order_bound(pidx, cidx, w, n_states):
    """(S, S) f64 bound on how far two f32 flux matrices of the same ids
    and weights, summed in different orders (``atomicAdd``), may lie apart
    in each cell: ``n eps32 sum |w|`` over the cell's ``n`` rows. Each of
    the ``n - 1`` additions of an f32 sum rounds by at most ``eps32 / 2``
    of a partial sum no larger than ``sum |w|``, so either order lies within
    half the bound of the exact sum."""
    import torch

    flat = pidx.long() * n_states + cidx.long()
    size = n_states * n_states
    n = torch.zeros(size, dtype=torch.float64, device=w.device).index_add_(
        0, flat, torch.ones_like(w, dtype=torch.float64))
    mag = torch.zeros(size, dtype=torch.float64, device=w.device).index_add_(
        0, flat, w.double().abs())
    return (n * _EPS32 * mag).reshape(n_states, n_states)
