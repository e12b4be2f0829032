"""The synthetic weighted-ensemble run that the build cells ingest.

A copy of the port's ``data/synthetic.py`` generator (seeded 1-D
double-well Brownian WE with split/merge resampling and recycling), with
the per-segment coordinate embedding drawn for a whole ensemble at once.
numpy's ``Generator.normal`` fills each element from its own draws, so one
call of ``m * (3 n_atoms - 1)`` values consumes the stream as ``m`` calls
of ``3 n_atoms - 1`` did, and the arrays are those of the original
(``benchmark/tests/test_bench_traffic.py`` holds them equal).

Every parameter comes from a workload file's ``traffic`` object.
"""
from __future__ import annotations

import numpy as np

__all__ = ["generate"]


def _force(x, x_min, x_max, barrier):
    """Negative gradient of a double-well with minima near both ends."""
    span = x_max - x_min
    u = 2.0 * (x - x_min) / span - 1.0
    dUdu = barrier * 4.0 * u * (u * u - 1.0)
    return -dUdu * 2.0 / span


def _embed(x, rng, n_atoms):
    """(m, n_atoms, 3) coordinates of the pcoords ``x``: atom 0's x carries
    the pcoord, the rest is correlated noise, drawn in the order the
    per-segment embedding draws it."""
    n = n_atoms
    z = rng.normal(0, 0.05, (len(x), 3 * n - 1))
    coords = np.zeros((len(x), n, 3))
    coords[:, 0, 0] = x
    coords[:, 1:, 0] = 0.3 * x[:, None] + z[:, : n - 1]
    coords[:, :, 1] = np.sin(x)[:, None] + z[:, n - 1 : 2 * n - 1]
    coords[:, :, 2] = z[:, 2 * n - 1 :]
    return coords


def generate(n_iterations, n_segments, seed, warmup=20, n_atoms=4, pcoord_len=2,
             target_bounds=(0.0, 1.0), basis_bounds=(9.0, 10.0), x_min=0.0,
             x_max=10.0, dt=0.35, noise=1.2, barrier=0.6, n_we_bins=10):
    """Per-iteration dicts (``weights``, ``parent_ids``, ``pcoords`` (m,
    pcoord_len, 1), ``coords`` (m, 2, n_atoms, 3), ``recycled``) of a run
    with ``n_iterations`` usable iterations: ``n_iterations + 1`` are
    recorded after ``warmup`` unrecorded ones, the last one incomplete."""
    rng = np.random.default_rng(seed)
    M = n_segments
    total_iters = n_iterations + 1 + warmup
    basis_x = 0.5 * (basis_bounds[0] + basis_bounds[1])
    bin_edges = np.linspace(x_min, x_max, n_we_bins + 1)

    xs = basis_x + rng.normal(0, 0.1, M)
    ws = np.full(M, 1.0 / M)
    coords_now = _embed(xs, rng, n_atoms)
    parent_of = np.full(M, -1, dtype=int)

    iterations = []
    for it in range(total_iters):
        n = len(xs)
        start_x = xs.copy()
        start_coords = coords_now.copy()
        end_x = (start_x + dt * _force(start_x, x_min, x_max, barrier)
                 + noise * np.sqrt(dt) * rng.normal(0, 1, n))
        end_x = np.clip(end_x, x_min + 1e-3, x_max - 1e-3)
        in_target = (end_x > target_bounds[0]) & (end_x < target_bounds[1])
        end_coords = _embed(end_x, rng, n_atoms)

        pcoords = np.zeros((n, pcoord_len, 1))
        pcoords[:, 0, 0] = start_x
        pcoords[:, -1, 0] = end_x
        for k in range(1, pcoord_len - 1):
            frac = k / (pcoord_len - 1)
            pcoords[:, k, 0] = start_x * (1 - frac) + end_x * frac

        if it >= warmup:
            recorded = np.full_like(parent_of, -1) if it == warmup else parent_of.copy()
            iterations.append(dict(
                weights=ws.copy(), parent_ids=recorded, pcoords=pcoords,
                coords=np.stack([start_coords, end_coords], axis=1),
                recycled=in_target.copy(),
            ))

        next_x = end_x.copy()
        next_coords = end_coords.copy()
        next_parent = np.arange(n)
        next_w = ws.copy()
        recycled = np.flatnonzero(in_target)
        if len(recycled):
            # One basis draw, then the embedding's draws, per recycled walker
            z = rng.normal(0, 1, (len(recycled), 3 * n_atoms))
            x_new = basis_x + 0.1 * z[:, 0]
            c = np.zeros((len(recycled), n_atoms, 3))
            k = n_atoms
            c[:, 0, 0] = x_new
            c[:, 1:, 0] = 0.3 * x_new[:, None] + 0.05 * z[:, 1:k]
            c[:, :, 1] = np.sin(x_new)[:, None] + 0.05 * z[:, k:2 * k]
            c[:, :, 2] = 0.05 * z[:, 2 * k:]
            next_x[recycled] = x_new
            next_coords[recycled] = c
            next_parent[recycled] = -1

        bins = np.clip(np.digitize(next_x, bin_edges) - 1, 0, n_we_bins - 1)
        populated = [b for b in range(n_we_bins) if (bins == b).any()]
        base, rem = divmod(M, len(populated))
        bin_target = {b: max(base, 1) for b in populated}
        if base >= 1 and rem:
            heaviness = np.argsort(
                [-next_w[bins == b].sum() for b in populated], kind="stable")
            for i in heaviness[:rem]:
                bin_target[populated[i]] += 1

        keep_x, keep_w, keep_coords, keep_parent = [], [], [], []
        for b in populated:
            members = np.flatnonzero(bins == b)
            target = bin_target[b]
            # The walkers by their index into ``members``: a merge deletes
            # one in place, a split appends a copy, as the original's
            # array edits do, so argsort and argmax see the same arrays
            mw = next_w[members]
            idx = np.arange(len(members))
            while len(mw) > target:
                order = np.argsort(mw)
                a, b2 = order[0], order[1]
                total = mw[a] + mw[b2]
                keep = a if rng.random() < mw[a] / total else b2
                drop = b2 if keep == a else a
                mw[keep] = total
                mw = np.delete(mw, drop)
                idx = np.delete(idx, drop)
            m = len(mw)
            if m < target:
                mw = np.concatenate([mw, np.empty(target - m)])
                idx = np.concatenate([idx, np.empty(target - m, idx.dtype)])
                while m < target:
                    h = int(np.argmax(mw[:m]))
                    mw[h] /= 2.0
                    mw[m] = mw[h]
                    idx[m] = idx[h]
                    m += 1
            src = members[idx]
            keep_x.append(next_x[src])
            keep_w.append(mw)
            keep_coords.append(next_coords[src])
            keep_parent.append(next_parent[src])

        xs = np.concatenate(keep_x)
        ws = np.concatenate(keep_w)
        coords_now = np.concatenate(keep_coords)
        parent_of = np.concatenate(keep_parent)
        ws = ws / ws.sum()
    return iterations
