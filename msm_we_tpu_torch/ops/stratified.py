"""Stratified (per-WE-bin) k-means as one flattened center bank.

Counterpart of ``msm_we_tpu/ops/stratified.py::StratifiedKmeans``. All
bins' centers live in one ``(n_bins * k, d)`` bank with per-row validity
and owning-bin ids; prediction is one masked nearest-center pass that
returns the reference's consecutive global cluster ids directly.

Numerics families, as in the JAX package:

* the host numpy family (``_np_kmeans_pp``, ``_np_assign``,
  ``_np_masked_assign``, ``_np_lloyd``, copied unchanged) seeds every bin
  and updates batches under ``HOST_BATCH_THRESHOLD`` rows. Bin ``b`` seeds
  from ``np.random.default_rng(seed + b)``, so seeds equal the JAX
  package's;
* the device family seeds bins with ``HOST_BATCH_THRESHOLD`` or more
  members at seeding time, all of one batch's in one
  ``ops.kmeans.seed_bins_batched`` call (its k-means++ draws are the
  port's own: JAX's PRNG cannot be reproduced), keeps ``(centers,
  counts)`` as torch tensors on the model's device between batches
  (``_dev_state``) and assigns through ``ops.kmeans.masked_assign`` (the
  H4-family kernel on CUDA).

With a mesh of several ranks (``use_mesh``) predictions of
``HOST_BATCH_THRESHOLD`` rows or more run ``parallel.sharded.
build_sharded_assign`` over it: each rank scores its row block against the
compact bank, the ids are gathered. On one rank every prediction takes the
one-device route.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .._device import as_device
from .._logging import log
from .kmeans import (
    masked_assign,
    masked_minibatch_scan,
    masked_minibatch_step,
    seed_bins_batched,
)

__all__ = ["StratifiedKmeans", "HOST_BATCH_THRESHOLD"]

# Batches smaller than this run in plain numpy on the host (the streaming
# fill loop sees many small ragged batches)
HOST_BATCH_THRESHOLD = 4096


def _np_kmeans_pp(rng, X, w, k):
    """Weighted k-means++ in numpy (host fast path for small batches)."""
    p = w / max(w.sum(), 1e-30)
    first = rng.choice(len(X), p=p)
    centers = [X[first]]
    mind2 = ((X - X[first]) ** 2).sum(axis=1)
    for _ in range(1, k):
        scores = w * mind2
        tot = scores.sum()
        if tot <= 0:
            nxt = rng.choice(len(X), p=p)
        else:
            nxt = rng.choice(len(X), p=scores / tot)
        centers.append(X[nxt])
        mind2 = np.minimum(mind2, ((X - X[nxt]) ** 2).sum(axis=1))
    return np.array(centers)


def _np_assign(X, centers):
    d2 = (
        (X**2).sum(1)[:, None] - 2 * X @ centers.T + (centers**2).sum(1)[None, :]
    )
    return d2.argmin(axis=1)


def _np_masked_assign(X, seg_bins, centers, center_bin, valid):
    """Host masked assignment: nearest valid same-bin center per row,
    scored per bin block when the bank is contiguous per bin. Ties break
    to the lowest global index."""
    K = len(centers)
    n_bins = int(center_bin[-1]) + 1 if K else 0
    k = K // n_bins if n_bins else 0
    if k and K == n_bins * k and np.array_equal(
        center_bin,
        np.repeat(np.arange(n_bins, dtype=np.asarray(center_bin).dtype), k),
    ):
        out = np.zeros(len(X), np.int64)
        c2 = (centers**2).sum(1)
        for b in np.unique(seg_bins):
            rows = np.flatnonzero(seg_bins == b)
            blk = slice(b * k, (b + 1) * k)
            scores = c2[blk][None, :] - 2.0 * (X[rows] @ centers[blk].T)
            scores[:, ~valid[blk]] = np.inf
            out[rows] = b * k + scores.argmin(axis=1)
        return out
    d2 = (
        (X**2).sum(1)[:, None] - 2 * X @ centers.T + (centers**2).sum(1)[None, :]
    )
    bad = ~(valid[None, :] & (center_bin[None, :] == seg_bins[:, None]))
    d2[bad] = np.inf
    return d2.argmin(axis=1)


def _np_lloyd(X, w, centers, n_iter):
    centers = centers.copy()
    for _ in range(n_iter):
        idx = _np_assign(X, centers)
        for c in range(len(centers)):
            m = idx == c
            wm = w[m].sum()
            if wm > 0:
                centers[c] = (X[m] * w[m, None]).sum(axis=0) / wm
    # Assignments against the FINAL centers
    return centers, _np_assign(X, centers)


class StratifiedKmeans:
    """Per-WE-bin streaming k-means over a flattened center bank.

    ``seed``: bin ``b`` seeds with ``seed + b``. ``device``: where the
    device-family state and assignments live (the card by default; a CPU
    caller passes ``device="cpu"``).
    """

    mesh = None  # set by use_mesh() for predictions over a mesh of ranks

    def __init__(self, n_bins, k_per_bin, n_features, seed=0, device="cuda"):
        self.n_bins = int(n_bins)
        self.k = int(k_per_bin)
        self.d = int(n_features)
        self.seed = int(seed)
        self.device = as_device(device)

        K = self.n_bins * self.k
        self.centers = np.zeros((K, self.d), np.float32)
        self.counts = np.zeros(K, np.float32)
        # Device-family (centers, counts) between batches; the host copies
        # above are stale while this is set (see _sync_host)
        self._dev_state = None
        self.valid = np.zeros(K, bool)
        self.center_bin = np.repeat(np.arange(self.n_bins, dtype=np.int32), self.k)
        self.initialized = np.zeros(self.n_bins, bool)
        self.we_remap = np.arange(self.n_bins, dtype=np.int32)
        # Bins seeded by each numerics family (host numpy, device batch)
        self.seeded_by_family = {"host": 0, "device": 0}
        self._refresh_ids()

    # ------------------------------------------------------------ bookkeeping
    def _sync_host(self):
        """Materialize device-resident centers/counts back to host numpy."""
        if self._dev_state is not None:
            c, n = self._dev_state
            self.centers = c.cpu().numpy().copy()
            self.counts = n.cpu().numpy().copy()
            self._dev_state = None

    def _device_state(self):
        if self._dev_state is None:
            self._dev_state = (
                torch.as_tensor(self.centers, device=self.device).clone(),
                torch.as_tensor(self.counts, device=self.device).clone(),
            )
        return self._dev_state

    def __getstate__(self):
        """Pickle state on the CPU: device-resident centers/counts are
        copied to the host arrays (the live object is left as it is)."""
        state = self.__dict__.copy()
        if self._dev_state is not None:
            c, n = self._dev_state
            state["centers"] = c.cpu().numpy().copy()
            state["counts"] = n.cpu().numpy().copy()
            state["_dev_state"] = None
        state["device"] = torch.device("cpu")
        state["mesh"] = None  # a mesh belongs to its process
        return state

    def __deepcopy__(self, memo):
        """A copy on the same device, device-resident state included."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    def to(self, device):
        """Move the bank to ``device`` (the device state is re-uploaded
        from the host copies on next use)."""
        self._sync_host()
        self.device = as_device(device)
        return self

    def centers_of_bin(self, b):
        """Valid centers of bin ``b``, in global-id order (compat view)."""
        self._sync_host()
        rows = slice(b * self.k, (b + 1) * self.k)
        return self.centers[rows][self.valid[rows]]

    def _device_meta(self):
        """``center_bin``/``valid``/``initialized`` as device tensors."""
        return (
            torch.as_tensor(self.center_bin, device=self.device),
            torch.as_tensor(self.valid, device=self.device),
            torch.as_tensor(self.initialized, device=self.device),
        )

    def _refresh_ids(self):
        """Recompute consecutive global ids after any validity change:
        the valid-rank in the flat (bin-ordered) bank."""
        counts_per_bin = self.valid.reshape(self.n_bins, self.k).sum(axis=1)
        gid = np.where(self.valid, np.cumsum(self.valid) - 1, -1).astype(np.int64)
        self.global_id = gid
        self.n_centers_per_bin = counts_per_bin
        self.n_total_clusters = int(counts_per_bin.sum())

    @property
    def basis_cluster_index(self):
        return self.n_total_clusters

    @property
    def target_cluster_index(self):
        return self.n_total_clusters + 1

    def check_live_bins(self, remapped_bins):
        """Raise if any present (already remapped) WE bin has no live
        centers: assignments against it would be silent junk."""
        present = np.unique(remapped_bins)
        bad = present[
            ~self.initialized[present] | (self.n_centers_per_bin[present] == 0)
        ]
        if len(bad):
            raise RuntimeError(
                f"Bins {bad} have no live cluster centers and no remap. "
                "Cluster more data or remap these bins."
            )

    # ------------------------------------------------------------- training
    def partial_fit(self, X, seg_bins, weights=None):
        """One streaming update with a batch of features and their WE bins.

        Uninitialized bins that receive >= k members are seeded (weighted
        k-means++ plus 5 Lloyd sweeps): in the host family under
        ``HOST_BATCH_THRESHOLD`` members, else collected and seeded together
        on the device. Bins initialized before this call get the
        running-weighted-mean update (host family under
        ``HOST_BATCH_THRESHOLD`` live rows, device family above); a bin
        seeded in this call is not updated again. Returns the set of bins
        updated.
        """
        X = np.asarray(X, np.float32)
        seg_bins = np.asarray(seg_bins)
        w = (
            np.asarray(weights, np.float32)
            if weights is not None
            else np.ones(len(X), np.float32)
        )
        unique_bins = np.unique(seg_bins)

        # Snapshot BEFORE seeding: a bin seeded in this call consumed its
        # members once; the minibatch update must not count them again
        initialized_before = self.initialized.copy()
        seeded = False
        device_seeds = []
        for b in unique_bins:
            if self.initialized[b]:
                continue
            members = np.flatnonzero(seg_bins == b)
            if len(members) < self.k:
                continue
            self._sync_host()
            rows = slice(b * self.k, (b + 1) * self.k)
            if len(members) < HOST_BATCH_THRESHOLD:
                rng = np.random.default_rng(self.seed + int(b))
                init = _np_kmeans_pp(rng, X[members], w[members], self.k)
                cb, idx = _np_lloyd(X[members], w[members], init, n_iter=5)
                wsum = np.bincount(idx, weights=w[members], minlength=self.k)
                self.centers[rows] = cb
                self.counts[rows] = wsum
                self.seeded_by_family["host"] += 1
            else:
                device_seeds.append((int(b), members))
            self.valid[rows] = True
            self.initialized[b] = True
            seeded = True
        if device_seeds:
            self._seed_on_device(X, w, device_seeds)

        # Bins emptied by cleaning (initialized, no valid centers) are not
        # trainable: their members would fall through onto an invalid row
        trainable = initialized_before & (self.n_centers_per_bin > 0)
        if (initialized_before & ~trainable)[unique_bins].any():
            log.debug(
                "partial_fit batch contains members of emptied bins; "
                "their contribution is skipped (bins have no valid centers)"
            )
        live = np.flatnonzero(trainable[seg_bins])
        if len(live):
            if len(live) < HOST_BATCH_THRESHOLD:
                self._sync_host()
                Xl, wl, bl = X[live], w[live], seg_bins[live]
                idx = _np_masked_assign(
                    Xl, bl, self.centers, self.center_bin, self.valid
                )
                wsum = np.bincount(idx, weights=wl, minlength=len(self.counts))
                xsum = np.zeros_like(self.centers, dtype=np.float64)
                np.add.at(xsum, idx, Xl * wl[:, None])
                new_counts = self.counts + wsum
                upd = new_counts > 0
                self.centers[upd] = (
                    (self.centers[upd] * self.counts[upd, None] + xsum[upd])
                    / new_counts[upd, None]
                ).astype(np.float32)
                self.counts = new_counts.astype(np.float32)
            else:
                centers_d, counts_d = self._device_state()
                cb_d, valid_d, _init = self._device_meta()
                dev = self.device
                self._dev_state = masked_minibatch_step(
                    centers_d, counts_d,
                    torch.as_tensor(X[live], device=dev),
                    torch.as_tensor(w[live], device=dev),
                    torch.as_tensor(seg_bins[live].astype(np.int32), device=dev),
                    cb_d, valid_d, n_bins=self.n_bins,
                )

        if seeded:
            self._refresh_ids()
        return set(int(b) for b in unique_bins if self.initialized[b])

    def _seed_on_device(self, X, w, device_seeds):
        """Seed the ``(bin, member rows)`` of ``device_seeds`` in one
        ``seed_bins_batched`` call on the bank's device, the members
        zero-weight padded to the largest count; bin ``b`` seeds with
        ``seed + b``."""
        P = max(len(m) for _b, m in device_seeds)
        Xs = np.zeros((len(device_seeds), P, X.shape[1]), np.float32)
        ws = np.zeros((len(device_seeds), P), np.float32)
        for i, (_b, m) in enumerate(device_seeds):
            Xs[i, : len(m)] = X[m]
            ws[i, : len(m)] = w[m]
        packed = seed_bins_batched(
            [self.seed + b for b, _m in device_seeds],
            torch.as_tensor(Xs, device=self.device),
            torch.as_tensor(ws, device=self.device), self.k,
        ).cpu().numpy()
        for i, (b, _m) in enumerate(device_seeds):
            rows = slice(b * self.k, (b + 1) * self.k)
            self.centers[rows] = packed[i, :, :-1]
            self.counts[rows] = packed[i, :, -1]
        self.seeded_by_family["device"] += len(device_seeds)

    def minibatch_scan_run(self, X_dev, eff_bin_dev, w_dev, starts, lengths):
        """A run of no-seeding streaming batches over row windows of the
        device feature array (``ops.kmeans.masked_minibatch_scan``); only
        the device center/count state advances. The caller guarantees no
        batch in the run seeds a bin."""
        centers_d, counts_d = self._device_state()
        cb_d, valid_d, init_d = self._device_meta()
        self._dev_state = masked_minibatch_scan(
            centers_d, counts_d, X_dev, eff_bin_dev, w_dev, init_d,
            starts, lengths, cb_d, valid_d, n_bins=self.n_bins,
        )

    # ------------------------------------------------------------ prediction
    @staticmethod
    def scores_on_host(n_rows):
        """The scoring family of a batch of ``n_rows``: the host numpy
        formula under ``HOST_BATCH_THRESHOLD`` rows, else the masked
        assignment on the bank's device (H4 on CUDA). The two families can
        round near-ties differently."""
        return n_rows < HOST_BATCH_THRESHOLD

    def assign_flat(self, X, eff_bins, on_host):
        """Flat bank index of the nearest valid same-bin center per row of
        ``X`` (``eff_bins`` already remapped), in the family ``on_host``
        names (:meth:`scores_on_host`)."""
        X = np.asarray(X, np.float32)
        eff_bins = np.asarray(eff_bins)
        if on_host:
            self._sync_host()
            return _np_masked_assign(
                X, eff_bins, self.centers, self.center_bin, self.valid
            )
        centers_d, _counts_d = self._device_state()
        cb_d, valid_d, _init = self._device_meta()
        return masked_assign(
            torch.as_tensor(X, device=self.device),
            torch.as_tensor(eff_bins.astype(np.int32), device=self.device),
            centers_d, cb_d, valid_d, n_bins=self.n_bins,
        ).cpu().numpy()

    def predict(self, X, seg_bins, is_basis=None, is_target=None):
        """Global cluster indices for features X in WE bins ``seg_bins``.
        Applies ``we_remap`` first; basis then target rows short-circuit to
        the two extra indices (target wins)."""
        seg_bins = self.we_remap[np.asarray(seg_bins)]
        self.check_live_bins(seg_bins)
        if (self.mesh is not None and self.mesh.world_size > 1
                and len(X) >= HOST_BATCH_THRESHOLD):
            out = self._predict_sharded(X, seg_bins)
        else:
            flat = self.assign_flat(X, seg_bins, self.scores_on_host(len(X)))
            out = self.global_id[flat]
        if is_basis is not None:
            out = np.where(np.asarray(is_basis), self.basis_cluster_index, out)
        if is_target is not None:
            out = np.where(np.asarray(is_target), self.target_cluster_index, out)
        return out

    def use_mesh(self, mesh):
        """Route large predictions through ``mesh`` when it has several
        ranks (None or one rank: the one-device route)."""
        self.mesh = mesh

    def _predict_sharded(self, X, seg_bins):
        """Global ids of ``X`` (bins already remapped) over the mesh: each
        rank scores its row block against the compact bank
        (``build_sharded_assign``), the blocks are gathered over 'data'.
        The ids equal the one-device ``assign_flat`` route's."""
        from ..parallel.sharded import build_sharded_assign

        mesh = self.mesh
        X = np.asarray(X, np.float32)
        gid = build_sharded_assign(mesh)(
            mesh.rows(X, 0.0), mesh.rows(np.asarray(seg_bins, np.int32), -1),
            *self.compact_bank_device(),
        )
        return mesh.gather_rows(gid, len(X)).cpu().numpy().astype(np.int64)

    def compact_bank(self):
        """``(centers, center_bin, valid)`` host arrays with the valid
        centers first, in global-id order: the layout the kernels need, so
        the winning row index IS the global cluster id."""
        self._sync_host()
        rows = np.flatnonzero(self.valid)
        return (
            self.centers[rows].copy(),
            self.center_bin[rows].copy(),
            np.ones(len(rows), bool),
        )

    def compact_bank_device(self):
        """:meth:`compact_bank` as device tensors, gathered on the device
        from the device-resident state when a fill loop left it there (no
        host round trip)."""
        dev = self.device
        rows = np.flatnonzero(self.valid)
        center_bin = torch.as_tensor(self.center_bin[rows], device=dev)
        valid = torch.ones(len(rows), dtype=torch.bool, device=dev)
        if self._dev_state is None:
            centers = torch.as_tensor(self.centers[rows], device=dev)
        else:
            centers = self._dev_state[0].index_select(
                0, torch.as_tensor(rows, device=dev)
            )
        return centers.contiguous(), center_bin.contiguous(), valid

    # -------------------------------------------------------------- cleaning
    def remove_global_clusters(self, global_ids_to_remove):
        """Invalidate the centers with the given global ids; returns the
        initialized bins left with no centers. Global ids are recomputed so
        the survivors are consecutive."""
        global_ids_to_remove = np.asarray(global_ids_to_remove, dtype=np.int64)
        if len(global_ids_to_remove):
            inverse = {g: i for i, g in enumerate(self.global_id) if g >= 0}
            rows = np.array([inverse[g] for g in global_ids_to_remove])
            self.valid[rows] = False
        self._refresh_ids()
        return {
            b for b in range(self.n_bins)
            if self.initialized[b] and self.n_centers_per_bin[b] == 0
        }

    def set_remap(self, bin_idx, target_bin):
        log.debug(f"Remapping WE bin {bin_idx} -> {target_bin}")
        self.we_remap[bin_idx] = target_bin
        # Path-compress chains (B -> C after A -> B resolves A -> C)
        for _ in range(self.n_bins):
            chained = self.we_remap[self.we_remap]
            if np.array_equal(chained, self.we_remap):
                break
            self.we_remap = chained
