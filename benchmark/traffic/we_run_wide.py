"""The synthetic weighted-ensemble run at NTL9 widths that ``westpa_ntl9``'s
build ingests: ~300 atoms, 900 raw coordinates that carry ~30 PCA
components at the plugin's 0.95 cutoff.

The run itself (weights, parents, pcoords, recycling) is ``we_run.generate``'s
at ``n_atoms`` 4 and the same seed, bitwise ``westpa_default``'s. Only the
coordinates are new, drawn from a stream of their own: a frame is a latent
vector of ``n_modes`` modes, the pcoord (times ``pcoord_weight``) and
``n_modes - 1`` slow modes, mapped to the 3 x ``n_atoms`` coordinates by a
fixed orthonormal loading (drawn from ``loading_seed``, the same molecule
in every run), plus isotropic noise of standard deviation ``noise``. Slow
mode ``k`` (from 0) has the stationary spread ``amplitude * spread**k``;
down each walker's line it relaxes by ``relax`` an iteration (an AR(1)
step that keeps that spread). A segment's start frame is its parent's end
frame, bitwise; a walker without a recorded parent (the first iteration,
a recycled walker) starts from a fresh basis frame with its slow modes
drawn at their spread.

Every parameter comes from a configuration's ``synthetic`` and ``wide``
objects.
"""
from __future__ import annotations

import numpy as np

from benchmark.traffic import we_run

__all__ = ["generate", "loading"]


def loading(n_modes, n_coords, seed):
    """(n_modes, n_coords) orthonormal rows: the fixed map from the latent
    modes to the raw coordinates."""
    g = np.random.default_rng(seed).standard_normal((n_coords, n_modes))
    q, r = np.linalg.qr(g)
    return (q * np.sign(np.diag(r))).T


def generate(n_iterations, n_segments, seed, wide, n_atoms=300, **synthetic):
    """``we_run.generate``'s per-iteration dicts at ``n_atoms`` 4 and the
    same seed (``synthetic`` holds its other keyword arguments), with
    ``coords`` (m, 2, n_atoms, 3) of the wide frames in their place."""
    run = we_run.generate(n_iterations, n_segments, seed, n_atoms=4, **synthetic)
    d = 3 * n_atoms
    modes = int(wide["n_modes"])
    L = loading(modes, d, wide["loading_seed"])
    sd = wide["amplitude"] * wide["spread"] ** np.arange(modes - 1)
    relax = float(wide["relax"])
    kick = np.sqrt(1.0 - relax * relax) * sd
    rng = np.random.default_rng([seed % 2**64, 1])

    def frames(x, slow):
        latent = np.concatenate([wide["pcoord_weight"] * x[:, None], slow], axis=1)
        return latent @ L + wide["noise"] * rng.standard_normal((len(x), d))

    end_slow = end_frames = None
    for it in run:
        parents = it["parent_ids"]
        x0, x1 = it["pcoords"][:, 0, 0], it["pcoords"][:, -1, 0]
        fresh = np.flatnonzero(parents < 0)
        kept = np.flatnonzero(parents >= 0)
        slow0 = np.empty((len(parents), modes - 1))
        start = np.empty((len(parents), d))
        if len(kept):
            slow0[kept] = end_slow[parents[kept]]
            start[kept] = end_frames[parents[kept]]
        if len(fresh):
            slow0[fresh] = sd * rng.standard_normal((len(fresh), modes - 1))
            start[fresh] = frames(x0[fresh], slow0[fresh])
        end_slow = relax * slow0 + kick * rng.standard_normal(slow0.shape)
        end_frames = frames(x1, end_slow)
        it["coords"] = np.stack([start, end_frames], axis=1).reshape(
            len(parents), 2, n_atoms, 3)
    return run
