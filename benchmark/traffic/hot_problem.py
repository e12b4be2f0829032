"""The hot step's inputs: an NTL9-scale stratified-assignment problem.

A copy of the port's ``testing.make_problem`` (same seed, same arrays;
``benchmark/tests/test_bench_traffic.py`` holds them equal), and
``reorder``, which deals a problem's segments out in another order. A cell
makes one problem from its traffic's ``problem_seed`` and reorders it by
the run's seed: every run steps the same segments, so the steady-state
tail, whose rounds follow the flux matrix, does the same work in each.
Every parameter comes from a workload file's ``traffic`` object.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_problem", "reorder"]


def make_problem(n_segments=102_400, n_raw_features=900, n_components=30,
                 n_bins=10, k_per_bin=25, seed=0, fallback_frac=0.02):
    """NTL9-scale stratified-assignment problem.

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



SEGMENT_KEYS = ("raw_parent", "raw_child", "pbins", "cbins", "basis_p", "basis_c",
                "target_c", "w")


def reorder(p, seed):
    """The problem ``p`` with its segments in an order drawn from ``seed``:
    the same frames, bins, overrides and weights, and so the same flux
    matrix up to the order of its sums, with every segment index
    (``parent_rows``, ``fb_idx``) mapped to the new order."""
    n = len(p["raw_child"])
    order = np.random.default_rng(seed).permutation(n)  # new row i is old row order[i]
    new_of = np.empty(n, np.int64)
    new_of[order] = np.arange(n)
    q = dict(p)
    for k in SEGMENT_KEYS:
        q[k] = p[k][order]
    rows = p["parent_rows"][order]
    q["parent_rows"] = np.where(rows < 0, -1, new_of[np.maximum(rows, 0)]).astype(np.int32)
    fb = new_of[p["fb_idx"]]
    by_row = np.argsort(fb)
    q["fb_idx"] = fb[by_row].astype(np.int32)
    q["raw_fallback"] = p["raw_fallback"][by_row]
    return q
