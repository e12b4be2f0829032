"""Synthetic problems for tests, the entry point and the chip smoke run,
and the near-tie check that decides when two assignments may differ.

Counterpart of ``msm_we_tpu/testing.py`` (``tiny_stratified_problem``,
``pad_stratified_problem``) plus ``make_problem`` of ``bench.py`` (the hot
step's NTL9-scale shapes). numpy only: the same seed gives the same arrays
as the JAX package's generators. ``steady_state_early_exit`` is the plain
early-exit form of the hot step's steady-state tail,
``tail_order_excess`` the tolerance between two f32 (or two float64)
tails that sum in different orders, ``tail_residual_excess`` how far the
tail kernel's residual lies from its own ``T`` and ``p``,
``f32_rounding_excess`` how far the float64 tail's f32 outputs lie from
the float64 loop's, and ``flux_order_bound`` the tolerance between two f32
fluxes summed in different orders (torch).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "tiny_stratified_problem",
    "pad_stratified_problem",
    "make_problem",
    "near_tie_rows",
    "steady_state_early_exit",
    "tail_order_excess",
    "tail_residual_excess",
    "f32_rounding_excess",
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
    ``tol``: the plain reference of its device-side check, in ``fm``'s
    dtype (on ``fm.double()`` the reference of the float64 route of an f32
    ``fm`` above ``ops.steady_tail.S_MAX`` states). Returns ``(T, p, flux,
    residual, n_extra)``, ``n_extra`` the extra squarings taken."""
    from .step import (
        _aligned,
        _fixed_squarings,
        _square,
        _stationary,
        _target_flux,
        _transition_matrix,
    )

    T = _aligned(_transition_matrix(fm, basis_mask, target_mask))
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


def tail_order_excess(got, ref, dtype=None):
    """How far the f32 tail ``got`` = ``(T, p, flux, residual)`` lies beyond
    the bound of the reference ``ref`` (the same four, from the same flux
    matrix, summed in other orders), by output: each number is the largest
    excess of ``|got - ref|`` over its bound, ``<= 0`` within it. With
    ``dtype`` float64 the bounds are the float64 tail's: ``eps32`` becomes
    ``eps64`` below, and the tolerances of ``p`` and the flux shrink by
    ``eps64 / eps32`` (as many roundings, in float64: 1.9e-13 relatively),
    for the row kernels of ``ops/tail_rows.py`` against their plain
    versions.

    * ``T``: ``(S + 2) eps32 |T_ref|`` a cell. A row's outflux is a sum of
      ``S`` nonnegative numbers; any order lies within ``(S - 1) eps32 / 2``
      of the exact sum relatively, so two orders within ``(S - 1) eps32``,
      and each IEEE division adds ``eps32 / 2``. Recycled and identity
      rows are exact.
    * ``p``: ``1e-4 |p_ref| + 1e-6`` a state, and the flux ``1e-4 |J_ref| +
      1e-7``: the tolerances at which the tests hold this f32 tail to the
      JAX package's, another implementation summing in other orders
      (``test_torch_step.py``). After 9 to 25 squarings the distance comes
      from the rounding of whole matrix products, which a chain near
      decomposition amplifies; no term-by-term bound is tighter.
    * the residual ``sum |p T - p|``: ``2 ||p - p_ref||_1 + 2 (S + 1)
      eps32``. Moving ``p`` moves it by at most ``||dp T||_1 + ||dp||_1 <=
      2 ||dp||_1`` (stochastic rows); its ``S`` products and sums of terms
      adding up to at most 2 round by ``(S + 1) eps32`` each way, which also
      covers T's relative change.

    A NaN anywhere reads as NaN, which no ``<= 0`` test passes.
    """
    import torch

    eps = torch.finfo(dtype or torch.float32).eps
    k = eps / _EPS32
    gT, gp, gf, gr = (x.double() for x in got)
    rT, rp, rf, rr = (x.double() for x in ref)
    S = rT.shape[0]
    dp = (gp - rp).abs()
    return dict(
        T=float(((gT - rT).abs() - (S + 2) * eps * rT.abs()).max()),
        p=float((dp - k * (1e-4 * rp.abs() + 1e-6)).max()),
        flux=float((gf - rf).abs() - k * (1e-4 * rf.abs() + 1e-7)),
        residual=float((gr - rr).abs() - (2 * dp.sum() + 2 * (S + 1) * eps)),
    )


def tail_residual_excess(got, ref, tol):
    """How far the tail kernel's residual lies from what it should read,
    for ``got`` = the kernel's ``(T, p, flux, residual)`` and ``ref`` the
    early-exit loop's at the same ``tol`` (``<= 0`` within):

    * ``own``: ``|r - ||p T - p||_1|``, the latter in f64 from the
      kernel's own ``T`` and ``p``, over the rounding of the kernel's sums
      (``csrc/steady_tail.cu``, ``stationary``). Each ``(p T)_j`` of
      nonnegative terms passes ``n1 = ceil(S / 32) + 5`` roundings (a
      lane's fmaf chain, then a warp's five shuffles); the ``S`` terms
      ``|(p T)_j - p_j|`` pass ``n2 = ceil(S / 256) + 13`` (the
      subtraction, a thread's terms, five shuffles, eight warps). So
      ``|r - r64| <= g(n1) ||p T||_1 (1 + g(n2)) + g(n2) r64`` with ``g(n)
      = n u / (1 - n u)``, ``u = eps32 / 2``: 7.7e-7 at 252 states, a
      hundredth of ``tail_order_excess``'s residual term.
    * ``side``: 1 where the two residuals fall on different sides of
      ``tol`` (the kernel's round rule then decided otherwise than the
      loop's), else 0.
    """
    T, p, r = got[0].double(), got[1].double(), float(got[3])
    S = T.shape[0]
    u = _EPS32 / 2

    def g(n):
        return n * u / (1 - n * u)

    pT = p @ T
    r64 = float((pT - p).abs().sum())
    n1, n2 = -(-S // 32) + 5, -(-S // 256) + 13
    bound = g(n1) * float(pT.sum()) * (1 + g(n2)) + g(n2) * r64
    return dict(own=abs(r - r64) - bound,
                side=float((r <= tol) != (float(ref[3]) <= tol)))


def f32_rounding_excess(got, ref):
    """How far the f32 outputs ``got`` lie beyond their own rounding of the
    float64 numbers ``ref``: the largest ``|got - ref| - 2^-24 |ref|`` over
    every number of every pair (an f32 rounds to within half an epsilon,
    relatively). The float64 tail's outputs, which are the float64 loop's
    cast to f32, read at most 1e-12 (how far two float64 sums in other
    orders may move them)."""
    return max(float(((g.double() - r.double()).abs()
                      - 2.0 ** -24 * r.double().abs()).max())
               for g, r in zip(got, ref))


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
