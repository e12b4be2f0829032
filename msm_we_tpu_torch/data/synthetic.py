"""Deterministic synthetic weighted-ensemble run, held in memory.

Counterpart of ``msm_we_tpu/data/synthetic.py``: the same seeded 1-D
double-well Brownian WE simulation with split/merge resampling and
recycling, so one seed gives arrays identical to the JAX package's
generator. The port ingests the per-iteration arrays directly
(``data.arrays.ArrayWEDataset``) instead of a west.h5 file; writing a
west.h5 is not ported.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "SynthWESettings",
    "generate_trajectory_arrays",
    "generate_we_arrays",
    "generate_we_replicas",
    "stack_we_runs",
]


class SynthWESettings:
    """Parameters of the synthetic WE run."""

    def __init__(
        self,
        n_iterations=50,
        n_segments=32,
        n_atoms=4,
        pcoord_len=2,
        pcoord_ndim=1,
        target_bounds=(0.0, 1.0),
        basis_bounds=(9.0, 10.0),
        x_min=0.0,
        x_max=10.0,
        dt=0.35,
        noise=1.2,
        barrier=0.6,
        warmup=0,
        seed=0,
    ):
        self.n_iterations = n_iterations
        self.n_segments = n_segments
        self.n_atoms = n_atoms
        self.pcoord_len = pcoord_len
        self.pcoord_ndim = pcoord_ndim
        self.target_bounds = target_bounds
        self.basis_bounds = basis_bounds
        self.x_min = x_min
        self.x_max = x_max
        self.dt = dt
        self.noise = noise
        self.barrier = barrier
        self.warmup = warmup
        self.seed = seed


def _force(x, settings):
    """Negative gradient of a double-well with minima near both ends."""
    span = settings.x_max - settings.x_min
    u = 2.0 * (x - settings.x_min) / span - 1.0  # map to [-1, 1]
    # dU/du of barrier * (u^2 - 1)^2 has minima at u = +-1
    dUdu = settings.barrier * 4.0 * u * (u * u - 1.0)
    return -dUdu * 2.0 / span


def _coords_from_pcoord(x, rng, settings):
    """Embed a scalar pcoord into (n_atoms, 3) coordinates.

    Atom 0's x-component carries the pcoord; the rest is correlated noise so
    dimensionality reduction has structure to find.
    """
    n = settings.n_atoms
    coords = np.zeros((n, 3))
    coords[0, 0] = x
    coords[1:, 0] = 0.3 * x + rng.normal(0, 0.05, n - 1)
    coords[:, 1] = np.sin(x) + rng.normal(0, 0.05, n)
    coords[:, 2] = rng.normal(0, 0.05, n)
    return coords


def generate_trajectory_arrays(settings: SynthWESettings):
    """Run a real weighted-ensemble simulation, returning per-iteration arrays.

    Implements the WE algorithm: binned split/merge resampling every iteration
    (which is what populates the whole pcoord range and produces WE's
    characteristic many-orders-of-magnitude weight spread), plus recycling of
    target-reaching walkers into the basis.

    Returns a list (one entry per iteration) of dicts with keys ``weights``,
    ``parent_ids`` (index into the previous iteration's segments; -1 for
    recycled/initial walkers), ``pcoords`` (n_segs, pcoord_len, pcoord_ndim), ``coords``
    (n_segs, 2, n_atoms, 3) [frame 0 = walker start, frame 1 = walker end],
    and ``recycled`` flags.
    """
    rng = np.random.default_rng(settings.seed)
    M = settings.n_segments
    basis_x = 0.5 * (settings.basis_bounds[0] + settings.basis_bounds[1])

    n_we_bins = 10
    bin_edges = np.linspace(settings.x_min, settings.x_max, n_we_bins + 1)

    # Current walker ensemble (start-of-iteration state)
    xs = basis_x + rng.normal(0, 0.1, M)
    ws = np.full(M, 1.0 / M)
    coords_now = np.array([_coords_from_pcoord(x, rng, settings) for x in xs])
    parent_of = np.full(M, -1, dtype=int)

    iterations = []
    total_iters = settings.n_iterations + settings.warmup
    for _it in range(total_iters):
        n = len(xs)
        start_x = xs.copy()
        start_coords = coords_now.copy()

        # Propagate one tau of Brownian dynamics
        end_x = (
            start_x
            + settings.dt * _force(start_x, settings)
            + settings.noise * np.sqrt(settings.dt) * rng.normal(0, 1, n)
        )
        end_x = np.clip(end_x, settings.x_min + 1e-3, settings.x_max - 1e-3)
        in_target = (end_x > settings.target_bounds[0]) & (
            end_x < settings.target_bounds[1]
        )
        end_coords = np.array([_coords_from_pcoord(x, rng, settings) for x in end_x])

        pcoords = np.zeros((n, settings.pcoord_len, settings.pcoord_ndim))
        pcoords[:, 0, 0] = start_x
        pcoords[:, -1, 0] = end_x
        for k in range(1, settings.pcoord_len - 1):
            frac = k / (settings.pcoord_len - 1)
            pcoords[:, k, 0] = start_x * (1 - frac) + end_x * frac
        # Extra pcoord dimensions: deterministic observables of the primary
        # coordinate plus noise (e.g. a second order parameter), matching
        # the multi-dim pcoords the optimization flow appends
        for j in range(1, settings.pcoord_ndim):
            for k in range(settings.pcoord_len):
                pcoords[:, k, j] = np.sin((j + 1) * pcoords[:, k, 0]) + rng.normal(
                    0, 0.02, n
                )

        if _it >= settings.warmup:
            # First recorded iteration: parents point into unrecorded warmup
            # history; real west.h5 files mark iteration-1 segments with
            # parent_id < 0 (the start-of-trajectory sentinel WESTPA's
            # w_trace and the reference's ancestry walks rely on)
            recorded_parents = (
                np.full_like(parent_of, -1)
                if _it == settings.warmup
                else parent_of.copy()
            )
            iterations.append(
                dict(
                    weights=ws.copy(),
                    parent_ids=recorded_parents,
                    pcoords=pcoords,
                    coords=np.stack([start_coords, end_coords], axis=1),
                    recycled=in_target.copy(),
                )
            )

        # ---- Build the next ensemble: recycle, then split/merge per WE bin
        next_x = end_x.copy()
        next_coords = end_coords.copy()
        next_parent = np.arange(n)
        next_w = ws.copy()
        for ri in np.flatnonzero(in_target):
            next_x[ri] = basis_x + rng.normal(0, 0.1)
            next_coords[ri] = _coords_from_pcoord(next_x[ri], rng, settings)
            next_parent[ri] = -1  # restarted from an initial state

        bins = np.clip(
            np.digitize(next_x, bin_edges) - 1, 0, n_we_bins - 1
        )
        # Equal-share walker targets per populated bin (WE's allocation),
        # apportioned so the ensemble totals EXACTLY n_segments whenever
        # n_segments >= populated bins (each populated bin keeps >= 1
        # walker, so tiny ensembles may exceed the request)
        populated = [b for b in range(n_we_bins) if (bins == b).any()]
        base, rem = divmod(M, len(populated))
        bin_target = {b: max(base, 1) for b in populated}
        if base >= 1 and rem:
            # Deterministic: the extra walkers go to the heaviest bins
            heaviness = np.argsort(
                [-next_w[bins == b].sum() for b in populated], kind="stable"
            )
            for i in heaviness[:rem]:
                bin_target[populated[i]] += 1

        keep_x, keep_w, keep_coords, keep_parent = [], [], [], []
        for b in populated:
            members = np.flatnonzero(bins == b)
            walkers_per_bin = bin_target[b]
            mx = next_x[members]
            mw = next_w[members]
            mc = next_coords[members]
            mp = next_parent[members]

            # Merge down: repeatedly combine the two lightest walkers
            while len(mx) > walkers_per_bin:
                order = np.argsort(mw)
                a, b2 = order[0], order[1]
                total = mw[a] + mw[b2]
                keep = a if rng.random() < mw[a] / total else b2
                drop = b2 if keep == a else a
                mw[keep] = total
                sel = np.setdiff1d(np.arange(len(mx)), [drop])
                mx, mw, mc, mp = mx[sel], mw[sel], mc[sel], mp[sel]

            # Split up: repeatedly duplicate the heaviest walker
            while len(mx) < walkers_per_bin:
                h = int(np.argmax(mw))
                mw[h] /= 2.0
                mx = np.append(mx, mx[h])
                mw = np.append(mw, mw[h])
                mc = np.concatenate([mc, mc[h : h + 1]])
                mp = np.append(mp, mp[h])

            keep_x.append(mx)
            keep_w.append(mw)
            keep_coords.append(mc)
            keep_parent.append(mp)

        xs = np.concatenate(keep_x)
        ws = np.concatenate(keep_w)
        coords_now = np.concatenate(keep_coords)
        parent_of = np.concatenate(keep_parent)
        ws = ws / ws.sum()

    return iterations


def generate_we_arrays(n_iterations=50, n_segments=32, seed=0, warmup=20):
    """Per-iteration arrays of the synthetic run ``generate_west_h5`` of the
    JAX package writes for the same arguments: ``n_iterations + 1``
    iterations, the last one incomplete (its successor is missing), so a
    reader sees exactly ``n_iterations`` usable iterations."""
    return generate_trajectory_arrays(
        SynthWESettings(
            n_iterations=n_iterations + 1,
            n_segments=n_segments,
            seed=seed,
            warmup=warmup,
        )
    )


def stack_we_runs(runs):
    """One WE dataset from independent runs side by side: iteration ``i``
    holds every run's segments of iteration ``i`` in run order, parent ids
    shifted to the run's block of the previous iteration, weights divided
    by the number of runs (each iteration still sums to 1)."""
    n_runs = len(runs)
    if len({len(r) for r in runs}) != 1:
        raise ValueError("the runs must have the same number of iterations")
    stacked = []
    prev_offsets = np.zeros(n_runs, np.int64)
    for it in range(len(runs[0])):
        parts = [r[it] for r in runs]
        offsets = np.concatenate([[0], np.cumsum([len(p["weights"]) for p in parts])[:-1]])
        parents = [
            np.where(np.asarray(p["parent_ids"]) >= 0,
                     np.asarray(p["parent_ids"]) + prev_offsets[r], p["parent_ids"])
            for r, p in enumerate(parts)
        ]
        stacked.append(dict(
            weights=np.concatenate([p["weights"] for p in parts]) / n_runs,
            parent_ids=np.concatenate(parents),
            pcoords=np.concatenate([p["pcoords"] for p in parts]),
            coords=np.concatenate([p["coords"] for p in parts]),
            recycled=np.concatenate([p["recycled"] for p in parts]),
        ))
        prev_offsets = offsets
    return stacked


def generate_we_replicas(n_iterations, n_segments, n_replicas, seed=0, warmup=20,
                         processes=1):
    """``n_replicas`` independent runs of :func:`generate_we_arrays` (seeds
    ``seed .. seed + n_replicas - 1``, ``n_segments`` each), stacked by
    :func:`stack_we_runs` into one run of ``n_replicas * n_segments``
    segments per iteration. The generator's split/merge resampling costs
    grow faster than linearly with the walkers per bin, so a wide
    iteration is made of replicas, generated in ``processes`` worker
    processes (started and stopped here)."""
    args = [(n_iterations, n_segments, seed + r, warmup) for r in range(n_replicas)]
    if processes <= 1:
        return stack_we_runs([generate_we_arrays(*a) for a in args])
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(processes) as pool:
        runs = pool.starmap(generate_we_arrays, args)
    return stack_we_runs(runs)
