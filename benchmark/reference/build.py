"""Plain reference of the haMSM build, and the judge of what a build made.

A build reduces every segment's parent and child frames (PCA at a variance
cutoff), clusters them per WE bin (k-means), discretizes each frame to its
nearest center in its WE bin (basis and target regions override), sums the
flux matrix of the segment weights, cleans it to one strongly connected
set, sorts the states by mean pcoord, and solves the steady state of the
recycled transition matrix and its flux into the target. Block validation
builds the same from groups of iteration blocks.

Clustering's centers are a local optimum of a streaming k-means that the
reference cannot make again row for row (its k-means++ draws are its
own); so the judge takes the ids, flux, cleaning and steady state
downstream of the build's centers (its output) and works each out again,
and holds the centers themselves to the reference's own streaming
k-means over the same frames by their cost. The PCA before them it works
out on its own. Plain numpy and PyTorch in float64; nothing of the
program is imported.

Numbers (the worst over the build's model and its validation models):

* ``pca_err``: the largest gap between the build's PCA components and the
  reference's (signs aligned; a different number of components reads as
  infinite);
* ``bad_ids``: frames whose state is not a center of the frame's
  effective WE bin, or not the override where one applies (limit 0);
* ``id_gap``: the widest gap by which a chosen center's float64 squared
  distance lies above the bin's nearest, as a share of the row's scale;
* ``flux_err``: the largest cell gap between the build's (sorted,
  normalized) flux matrix and the float64 sum of the weights at its ids
  over its iterations, as a share of the largest cell;
* ``not_connected``: strongly connected sets of the cleaned matrix (with
  the target-to-basis recycling edge) beyond the first (limit 0);
* ``pss_err``, ``target_flux_err``: the L1 gap of the steady state and the
  relative gap of the target flux against the reference's exact solve;
* ``cluster_excess``: how much more the build's centers right after
  clustering cost than the reference's streaming k-means (``_stream_kmeans``)
  with as many centers a WE bin: the summed squared distance of the
  frames the build trains on to their nearest center of their bin, over
  the bins both clustered, as a ratio less 1 (0: as good as the
  reference; centers never updated after their seeding read far above).

``control(state)`` is the reference put in the build's place one precision
below what the configuration states: the PCA, the flux and the steady
state of each model in float32 (float64 stated), the ids with TF32
products (float32 stated); the centers are the build's (a k-means in a
lower precision is no worse a k-means, so ``cluster_excess`` is held
apart by a planted fault instead: centers left as seeded). In the shape
the judge reads.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.hot_step import _tf32

__all__ = ["Judge", "block_iterations"]

ROW_BLOCK = 65536
SEED_LLOYD_ITERS = 5


def block_iterations(max_iter, groups, blocks):
    """The iterations of each validation group: ``blocks`` blocks of
    ``max_iter // blocks`` iterations from 1 (the last one ends an
    iteration early), dealt round-robin to ``groups`` groups."""
    per = max_iter // blocks
    spans = [[s, s + per] for s in range(1, max_iter, per)]
    spans[-1][-1] -= 1
    out = []
    for g in range(groups):
        its = []
        for b in range(g, blocks, groups):
            its.extend(range(*spans[b]))
        out.append([i for i in its if 1 <= i < max_iter])
    return out


def _in_bounds(x, lo, hi):
    return (x > lo) & (x < hi)


def _pca(X, cutoff, dtype):
    """``(mean, components (n, d))``: the eigenvectors of the sample
    covariance of ``X``, by decreasing eigenvalue, as many as first reach
    ``cutoff`` of the variance."""
    X = np.asarray(X, dtype)
    mean = X.mean(0)
    Xc = X - mean
    cov = Xc.T @ Xc / (len(X) - 1)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    evals = np.maximum(evals[order], 0.0)
    ratio = np.cumsum(evals) / max(evals.sum(), 1e-300)
    n = int(np.argmax(ratio >= cutoff) + 1) if (ratio >= cutoff).any() else len(ratio)
    return mean, evecs[:, order[:n]].T


def _closure(A):
    """Reachability: ``R[i, j]`` where state ``j`` can be reached from ``i``
    over the edges ``A > 0`` (by repeated squaring)."""
    R = (np.asarray(A) > 0) | np.eye(len(A), dtype=bool)
    while True:
        R2 = (R.astype(np.float64) @ R.astype(np.float64)) > 0
        if (R2 == R).all():
            return R
        R = R2


def _n_strong_sets(A):
    """How many strongly connected sets the edges ``A > 0`` make."""
    R = _closure(A)
    mutual = R & R.T
    seen = np.zeros(len(A), bool)
    n = 0
    for i in range(len(A)):
        if not seen[i]:
            seen |= mutual[i]
            n += 1
    return n


def _steady_state(fm, i_basis, i_target, dtype):
    """Exact steady state of the recycled transition matrix of ``fm`` and
    its flux into the target, solved in ``dtype``."""
    F = np.asarray(fm, dtype)
    n = len(F)
    out = F.sum(1)
    T = np.zeros_like(F)
    pos = out > 0
    T[pos] = F[pos] / out[pos, None]
    idle = np.flatnonzero(~pos)
    T[idle, idle] = 1.0
    T[i_target] = 0.0
    T[i_target, i_basis] = 1.0 / len(i_basis)
    A = (T.T - np.eye(n, dtype=dtype))
    A[-1] = 1.0
    b = np.zeros(n, dtype)
    b[-1] = 1.0
    p = np.linalg.solve(A, b)
    others = np.setdiff1d(np.arange(n), i_target)
    J = float((p[others, None] * T[np.ix_(others, i_target)]).sum())
    return p, J


class Judge:
    """The float64 reference of one WE run under one configuration."""

    def __init__(self, iterations, config, device="cpu"):
        b = config["build"]
        self.device = device
        self.cutoff = float(b["variance_cutoff"])
        self.lagtime = float(b["tau"])
        self.groups = int(b["cross_validation_groups"])
        self.blocks = int(b["cross_validation_blocks"])
        self.edges = np.asarray(b["we_bin_edges"], np.float64)
        self.basis = [float(v) for v in b["basis_pcoord_bounds"][0]]
        self.target = [float(v) for v in b["target_pcoord_bounds"][0]]
        self.max_iter = len(iterations) - 1
        its = iterations[: self.max_iter - 1]  # the discretized iterations 1..max-1

        def cat(key, f):
            return np.concatenate([f(np.asarray(d[key])) for d in its])

        self.parent_raw = cat("coords", lambda c: c[:, 0].reshape(len(c), -1))
        self.child_raw = cat("coords", lambda c: c[:, 1].reshape(len(c), -1))
        self.pc0 = cat("pcoords", lambda p: p[:, 0, 0])
        self.pc1 = cat("pcoords", lambda p: p[:, -1, 0])
        self.w = cat("weights", lambda w: w.astype(np.float64))
        self.iteration = np.concatenate(
            [np.full(len(d["weights"]), i + 1) for i, d in enumerate(its)])
        nb = len(self.edges) - 1
        self.bins = [np.clip(np.digitize(x, self.edges) - 1, 0, nb - 1)
                     for x in (self.pc0, self.pc1)]
        self.is_b = [_in_bounds(x, *self.basis) for x in (self.pc0, self.pc1)]
        self.is_t = [_in_bounds(x, *self.target) for x in (self.pc0, self.pc1)]
        self.mean, self.comp = _pca(self.child_raw, self.cutoff, np.float64)
        self.flux_iters = {"main": list(range(2, self.max_iter))}
        for g, it in enumerate(block_iterations(self.max_iter, self.groups,
                                                self.blocks)):
            self.flux_iters[f"validation{g}"] = it

    # ---------------------------------------------------------------- parts
    def _aligned(self, comp):
        """The reference's components with the signs of ``comp``."""
        signs = np.sign((self.comp * comp).sum(1))
        signs[signs == 0] = 1.0
        return self.comp * signs[:, None]

    def _features(self, comp, dtype=np.float64):
        mean = np.asarray(self.mean, dtype)
        comp = np.asarray(comp, dtype)
        return [(np.asarray(r, dtype) - mean) @ comp.T
                for r in (self.parent_raw, self.child_raw)]

    def _eff_bins(self, center_bin):
        """Each frame's WE bin, or the nearest bin with centers (by bin
        midpoint, the lower on a tie) where its own has none."""
        mids = 0.5 * (self.edges[:-1] + self.edges[1:])
        filled = np.unique(center_bin)
        remap = np.array([b if b in filled else
                          filled[np.argmin(np.abs(mids[filled] - mids[b]))]
                          for b in range(len(mids))])
        return [remap[b] for b in self.bins]

    def _forced(self, side, n_states):
        """Override state of each frame (basis, then target, which wins),
        or -1."""
        f = np.where(self.is_b[side], n_states - 2, -1)
        return np.where(self.is_t[side], n_states - 1, f)

    def _assign(self, X, eff, C, cb, dtype):
        """Nearest center of each row's bin, the products of TF32-rounded
        operands in ``dtype`` (float32)."""
        dev = self.device
        Ct = _tf32(torch.as_tensor(C, device=dev, dtype=dtype))
        cbt = torch.as_tensor(cb, device=dev)
        c2 = (Ct * Ct).sum(1)
        out = []
        for i in range(0, len(X), ROW_BLOCK):
            x = _tf32(torch.as_tensor(X[i:i + ROW_BLOCK], device=dev, dtype=dtype))
            e = torch.as_tensor(eff[i:i + ROW_BLOCK], device=dev)
            d = c2[None, :] - 2.0 * (x @ Ct.T)
            d = torch.where(cbt[None, :] == e[:, None], d, torch.inf)
            out.append(d.argmin(1).cpu().numpy())
        return np.concatenate(out)

    def _judge_ids(self, X, eff, forced, ids, C, cb):
        """(bad frames, widest relative gap) of one side's ids."""
        dev = self.device
        f64 = torch.float64
        K = len(C)
        Ct = torch.as_tensor(C, device=dev, dtype=f64)
        cbt = torch.as_tensor(cb, device=dev)
        c2 = (Ct * Ct).sum(1)
        cn = c2.sqrt()
        bad, gap = 0, 0.0
        for i in range(0, len(X), ROW_BLOCK):
            x = torch.as_tensor(X[i:i + ROW_BLOCK], device=dev, dtype=f64)
            e = torch.as_tensor(eff[i:i + ROW_BLOCK], device=dev)
            f = torch.as_tensor(forced[i:i + ROW_BLOCK], device=dev)
            got = torch.as_tensor(ids[i:i + ROW_BLOCK], device=dev).long()
            x2 = (x * x).sum(1)
            cand = cbt[None, :] == e[:, None]
            d = torch.where(cand, x2[:, None] + c2[None, :] - 2.0 * (x @ Ct.T),
                            torch.inf)
            free = f < 0
            safe = got.clamp(0, K - 1)
            ok = torch.where(free, (got >= 0) & (got < K)
                             & cand.gather(1, safe[:, None])[:, 0], got == f)
            bad += int((~ok).sum())
            j = free & ok
            if j.any():
                scale = (x2[j] + torch.where(cand[j], c2[None, :], 0).amax(1)
                         + 2.0 * x2[j].sqrt()
                         * torch.where(cand[j], cn[None, :], 0).amax(1))
                dj = d[j]
                gap = max(gap, float(((dj.gather(1, safe[j][:, None])[:, 0]
                                       - dj.amin(1)) / scale).max()))
        return bad, gap

    def _flux(self, pidx, cidx, iters, n_states, dtype):
        """The sorted, normalized flux matrix of the ids over ``iters``, and
        the sort: clusters by mean child pcoord over every frame, empty
        clusters, basis and target last (a stable sort)."""
        sel = np.isin(self.iteration, iters)
        flat = pidx[sel].astype(np.int64) * n_states + cidx[sel]
        w = torch.as_tensor(self.w[sel], dtype=dtype)
        fm = torch.zeros(n_states * n_states, dtype=dtype).index_add_(
            0, torch.as_tensor(flat), w).reshape(n_states, n_states).numpy()
        fm = fm / len(iters)
        n = n_states - 2
        inr = cidx < n
        cnt = np.bincount(cidx[inr], minlength=n)
        sums = np.bincount(cidx[inr], weights=self.pc1[inr], minlength=n)
        key = np.full(n_states, np.nan)
        key[:n][cnt > 0] = sums[cnt > 0] / cnt[cnt > 0]
        order = np.argsort(key, kind="stable")
        fm = fm[np.ix_(order, order)]
        return fm / fm.sum()

    # ---------------------------------------------------------------- judge
    def _model_numbers(self, m, iters, comp):
        n_states = len(m["centers"]) + 2
        X = self._features(self._aligned(comp))
        eff = self._eff_bins(m["center_bin"])
        bad, gap = 0, 0.0
        for side, ids in ((0, m["parent_idx"]), (1, m["child_idx"])):
            b, g = self._judge_ids(X[side], eff[side], self._forced(side, n_states),
                                   ids, m["centers"], m["center_bin"])
            bad, gap = bad + b, max(gap, g)
        out = dict(bad_ids=bad, id_gap=gap)
        fm = np.asarray(m["flux_matrix"], np.float64)
        if bad or fm.shape != (n_states, n_states):
            nan = float("nan")
            return dict(out, bad_ids=max(bad, 1), flux_err=nan, not_connected=nan,
                        pss_err=nan, target_flux_err=nan)
        ref = self._flux(np.asarray(m["parent_idx"]), np.asarray(m["child_idx"]),
                         iters, n_states, torch.float64)
        out["flux_err"] = float(np.abs(fm - ref).max() / np.abs(ref).max())
        recycled = ref.copy()
        recycled[-1, -2] = 1.0
        out["not_connected"] = _n_strong_sets(recycled) - 1
        if out["not_connected"]:
            # No unique steady state to compare with
            return dict(out, pss_err=float("nan"), target_flux_err=float("nan"))
        p, J = _steady_state(ref, [n_states - 2], [n_states - 1], np.float64)
        J /= self.lagtime
        out["pss_err"] = float(np.abs(np.asarray(m["pss"], np.float64) - p).sum())
        out["target_flux_err"] = abs(float(m["target_flux"]) - J) / abs(J)
        return out

    def _cluster_excess(self, bank, comp, seed):
        """The build's clustering cost over the reference's, less 1 (see
        the module's ``cluster_excess``)."""
        X = self._features(self._aligned(comp))[1]
        keep = ~(self.is_b[0] | self.is_t[0]) & (self.w > 0)
        centers = np.asarray(bank["centers"])
        center_bin = np.asarray(bank["center_bin"])
        k = int(np.bincount(center_bin).max())
        ref = _stream_kmeans(X, self.bins[0], self.iteration, keep, k,
                             np.random.default_rng(seed), self.device)
        built = total = 0.0
        for b, C in ref.items():
            Cb = centers[center_bin == b]
            if not len(Cb):
                continue
            x = torch.as_tensor(X[keep & (self.bins[0] == b)], device=self.device,
                                dtype=torch.float64)
            built += _cost(x, torch.as_tensor(Cb, device=self.device, dtype=torch.float64))
            total += _cost(x, C)
        return built / max(total, 1e-300) - 1.0

    def _lloyd_gain(self, bank, comp):
        """The share of the build's clustering cost that one Lloyd step from
        its centers right after clustering takes off, over the frames the
        build trains on, summed over the WE bins (0 at a fixed point of
        k-means)."""
        X = self._features(self._aligned(comp))[1]
        keep = ~(self.is_b[0] | self.is_t[0]) & (self.w > 0)
        centers = np.asarray(bank["centers"])
        center_bin = np.asarray(bank["center_bin"])
        before = after = 0.0
        for b in np.unique(center_bin):
            rows = keep & (self.bins[0] == b)
            if not rows.any():
                continue
            x = torch.as_tensor(X[rows], device=self.device, dtype=torch.float64)
            C = torch.as_tensor(centers[center_bin == b], device=self.device,
                                dtype=torch.float64)
            sums, cnt = _means(x, C)
            moved = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None], C)
            before += _cost(x, C)
            after += _cost(x, moved)
        return (before - after) / max(before, 1e-300)

    def __call__(self, state, seed=0):
        """The numbers for one build's ``state`` (see ``drivers/build.py``)."""
        comp = np.asarray(state["pca_components"], np.float64)
        out = {}
        if comp.shape != self.comp.shape:
            out["pca_err"] = float("inf")
            comp = self.comp
        else:
            out["pca_err"] = float(np.abs(comp - self._aligned(comp)).max())
        for name, m in state["models"].items():
            for k, v in self._model_numbers(m, self.flux_iters[name], comp).items():
                out[k] = v if v != v or k not in out else max(out[k], v)
        out["cluster_excess"] = self._cluster_excess(state["post_cluster_bank"], comp, seed)
        out["lloyd_gain"] = self._lloyd_gain(state["post_cluster_bank"], comp)
        return out

    def control(self, state):
        """``state`` with what the reference works out (PCA, ids, flux,
        steady state) redone in float32 from the build's centers."""
        mean, comp = _pca(self.child_raw, self.cutoff, np.float32)
        if comp.shape == np.shape(state["pca_components"]):
            # The build's centers live in its signs of the components
            signs = np.sign((comp * state["pca_components"]).sum(1))
            comp = comp * np.where(signs == 0, 1, signs).astype(np.float32)[:, None]
        out = dict(state, pca_components=comp, models={})
        f32 = torch.float32
        for name, m in state["models"].items():
            n_states = len(m["centers"]) + 2
            X = [(np.asarray(r, np.float32) - mean) @ comp.T
                 for r in (self.parent_raw, self.child_raw)]
            eff = self._eff_bins(m["center_bin"])
            ids = []
            for side in (0, 1):
                got = self._assign(X[side], eff[side], m["centers"], m["center_bin"], f32)
                forced = self._forced(side, n_states)
                ids.append(np.where(forced >= 0, forced, got))
            fm = self._flux(ids[0], ids[1], self.flux_iters[name], n_states, f32)
            try:
                p, J = _steady_state(fm, [n_states - 2], [n_states - 1], np.float32)
            except np.linalg.LinAlgError:
                # A control that gives no number has failed
                p, J = np.full(n_states, np.nan, np.float32), float("nan")
            out["models"][name] = dict(m, parent_idx=ids[0], child_idx=ids[1],
                                       flux_matrix=fm, pss=p,
                                       target_flux=J / self.lagtime)
        return out


def _cost(x, C):
    """Summed squared distance of the rows ``x`` to their nearest center."""
    return float(torch.cdist(x, C).amin(1).square().sum())


def _kmeans_pp(x, k, rng):
    """``k`` rows of ``x`` drawn by k-means++ (each next row with chance
    proportional to its squared distance to the nearest drawn)."""
    n = len(x)
    first = int(rng.integers(n))
    C = x[first:first + 1]
    d2 = torch.cdist(x, C).square()[:, 0]
    for _ in range(1, k):
        p = d2.cpu().numpy()
        nxt = int(rng.choice(n, p=p / p.sum())) if p.sum() > 0 else int(rng.integers(n))
        C = torch.cat([C, x[nxt:nxt + 1]])
        d2 = torch.minimum(d2, torch.cdist(x, x[nxt:nxt + 1]).square()[:, 0])
    return C


def _means(x, C):
    """Per center: the sum of the rows nearest to it and their count."""
    lab = torch.cdist(x, C).argmin(1)
    sums = torch.zeros_like(C).index_add_(0, lab, x)
    cnt = torch.zeros(len(C), dtype=x.dtype, device=x.device).index_add_(
        0, lab, torch.ones_like(lab, dtype=x.dtype))
    return sums, cnt


def _stream_kmeans(X, bins, iteration, keep, k, rng, device):
    """Streaming k-means of the rows ``keep`` of ``X`` per WE bin, one
    iteration after another, as msm_we's stratified clustering runs it: a
    bin is seeded once its rows gathered so far number ``k`` or more
    (k-means++ and ``SEED_LLOYD_ITERS`` Lloyd sweeps over them); after
    that each iteration's rows of the bin move every center to the running
    mean of all rows it has taken (the rows assigned against the centers as
    they stood before the iteration). Unweighted, float64. Returns the
    centers of each seeded bin."""
    state, pending = {}, {}
    for it in np.unique(iteration[keep]):
        sel = keep & (iteration == it)
        for b in np.unique(bins[sel]):
            rows = np.flatnonzero(sel & (bins == b))
            if b in state:
                C, n = state[b]
                x = torch.as_tensor(X[rows], device=device, dtype=torch.float64)
                sums, cnt = _means(x, C)
                total = n + cnt
                C = torch.where(total[:, None] > 0,
                                (C * n[:, None] + sums) / total.clamp(min=1)[:, None], C)
                state[b] = (C, total)
                continue
            pending.setdefault(b, []).append(rows)
            gathered = np.concatenate(pending[b])
            if len(gathered) >= k:
                x = torch.as_tensor(X[gathered], device=device, dtype=torch.float64)
                C = _kmeans_pp(x, k, rng)
                for _ in range(SEED_LLOYD_ITERS):
                    sums, cnt = _means(x, C)
                    C = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1)[:, None], C)
                state[b] = (C, _means(x, C)[1])
                del pending[b]
    return {b: C for b, (C, _n) in state.items()}
