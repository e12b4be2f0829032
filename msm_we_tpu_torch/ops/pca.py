"""Streaming dimensionality reduction: PCA, weighted TICA, VAMP.

Counterpart of ``MomentAccumulator``, ``PCAModel``,
``PairMomentAccumulator``, ``TICAModel`` and ``IdentityCoordinates`` in
``msm_we_tpu/ops/pca.py``. Moments are accumulated per batch and combined
across batches with Chan's pairwise update (and its lagged-pair form) in
float64. The default per-batch path is float64 numpy, a copy of the JAX
package's (bitwise parity). ``dtype=np.float32`` runs the d x d products
as IEEE f32 products on a torch device (``_device.py`` pins out TF32):
``MomentAccumulator`` keeps its running sums there, centering each batch
in f64 and combining it in f64 on the device, so the host reads M2 once,
at ``finalize``; ``PairMomentAccumulator`` centers and combines on the
host. The eigenproblems are host f64. A fitted PCA transform picks its
projection once, from its width and device: on CUDA, from
``_KERNEL_MIN_ROW_FLOPS`` a row, the streaming features kernel
(``stratified_assign.transform_features``), whose features of a row do
not depend on the other rows of the call; else host numpy. A TICA/VAMP
transform projects in host numpy below
``_DEVICE_TRANSFORM_MIN_FLOPS`` and with an f32 ``torch.matmul`` on its
device above it.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_device
from .._logging import log
from ..tracing import count, span
from .stratified_assign import transform_features

__all__ = [
    "IdentityCoordinates",
    "PCAModel",
    "TICAModel",
    "MomentAccumulator",
    "PairMomentAccumulator",
]

# Below this many flops a projection runs in host numpy: a device round
# trip dwarfs the product for small chunks
_DEVICE_TRANSFORM_MIN_FLOPS = 5e7
# From this many flops a row (2 d F) a fitted PCA transform on CUDA
# projects with the features kernel: a featurization chunk of 8,192 such
# rows is ~5e7 flops, where the device beats host numpy
_KERNEL_MIN_ROW_FLOPS = 6e3


def _center_f64(X, w, ws):
    """(weighted batch mean, centered-then-f32 data), computed in f64: the
    subtraction happens before the f32 cast, so the precision left tracks
    the data's spread, not its offset from the origin."""
    X = np.asarray(X, np.float64)
    mean = (X * w[:, None]).sum(axis=0) / ws
    return mean, (X - mean[None, :]).astype(np.float32)


def _weighted_gram_f32(A, B, w, device):
    """``(A * w)^T B`` of pre-centered f32 blocks as an IEEE f32 product on
    ``device``, returned as host f64."""
    a = torch.as_tensor(A, device=device)
    b = a if B is A else torch.as_tensor(B, device=device)
    wt = torch.as_tensor(w.astype(np.float32), device=device)
    return ((a * wt[:, None]).T @ b).double().cpu().numpy()


class IdentityCoordinates:
    """Identity transform (the reference's ``Coordinates`` stub)."""

    def transform(self, coords):
        return coords


# Reference import-path parity (``from ... import Coordinates``)
Coordinates = IdentityCoordinates


class MomentAccumulator:
    """Streaming first/second moments for PCA, combined across batches in
    float64. ``dtype=np.float32`` keeps ``mean`` and ``M2`` as f64 tensors
    on ``device``: each batch is uploaded once as f64, centered there in
    f64 before the f32 cast, its second moment is an f32 product, and
    Chan's update runs there in f64. ``mean`` and ``M2`` read them to the
    host on access (each read of ``M2`` counts ``moments_readbacks``; each
    batch combined on the device counts ``moments_device_batches``)."""

    def __init__(self, n_features, dtype=np.float64, device="cpu"):
        self.n = 0.0  # total weight (== sample count when unweighted)
        self.n_samples = 0
        self.dtype = np.dtype(dtype)
        self.device = as_device(device)
        if self.dtype == np.float64:
            self._mean = np.zeros(n_features, dtype=np.float64)
            self._M2 = np.zeros((n_features, n_features), dtype=np.float64)
        else:
            self._mean = torch.zeros(n_features, dtype=torch.float64,
                                     device=self.device)
            self._M2 = torch.zeros((n_features, n_features),
                                   dtype=torch.float64, device=self.device)

    @property
    def mean(self):
        if isinstance(self._mean, np.ndarray):
            return self._mean
        return self._mean.to("cpu", copy=True).numpy()

    @property
    def M2(self):
        if isinstance(self._M2, np.ndarray):
            return self._M2
        count("moments_readbacks")
        return self._M2.to("cpu", copy=True).numpy()

    def add(self, X, weights=None):
        X = np.asarray(X, np.float64)
        w = (
            np.asarray(weights, np.float64)
            if weights is not None
            else np.ones(X.shape[0])
        )
        ws = float(w.sum())
        if ws == 0.0:
            return
        n_new = self.n + ws
        if self.dtype == np.float64:
            mean_b = (X * w[:, None]).sum(axis=0) / ws
            Xc = X - mean_b[None, :]
            M2_b = (Xc * w[:, None]).T @ Xc
            delta = mean_b - self._mean
            self._M2 += M2_b + np.outer(delta, delta) * (self.n * ws / n_new)
        else:
            x = torch.as_tensor(np.ascontiguousarray(X), device=self.device)
            wt = torch.as_tensor(w, device=self.device)
            mean_b = (wt @ x) / ws
            # Center in f64 before the f32 cast, as _center_f64 does
            xc = (x - mean_b).float()
            M2_b = ((xc * wt.float()[:, None]).T @ xc).double()
            delta = mean_b - self._mean
            self._M2 += M2_b.addr_(delta, delta, alpha=self.n * ws / n_new)
            count("moments_device_batches")
        self._mean += delta * (ws / n_new)
        self.n = n_new
        self.n_samples += len(X)

    def finalize(self, variance_cutoff=0.95, n_components=None):
        """Eigendecompose the covariance and return a :class:`PCAModel`
        projecting on the accumulator's device.
        Unweighted accumulation divides by ``n_samples - 1``, weighted by
        the total weight."""
        weighted = self.n != self.n_samples
        if weighted:
            if not (self.n > 0 and self.n_samples > 1):
                raise ValueError("Need more than one sample for PCA")
            denom = self.n
        else:
            if not self.n > 1:
                raise ValueError("Need more than one sample for PCA")
            denom = self.n - 1
        M2, mean = self.M2, self.mean
        cov = M2 / denom
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        evals, evecs = np.maximum(evals[order], 0.0), evecs[:, order]
        if n_components is None:
            if variance_cutoff >= 1.0:
                n_components = len(evals)
            else:
                ratio = np.cumsum(evals) / np.maximum(evals.sum(), 1e-300)
                crossed = ratio >= variance_cutoff
                n_components = (
                    int(np.argmax(crossed) + 1) if crossed.any() else len(ratio)
                )
        log.debug(f"PCA keeping {n_components} components")
        return PCAModel(
            mean, evecs[:, :n_components].T, evals[:n_components], cov,
            device=self.device,
        )


class PCAModel:
    """Fitted PCA transform: ``(x - mean) @ components.T``.

    ``route`` is decided once, here: ``"kernel"`` on a CUDA device where a
    row costs ``_KERNEL_MIN_ROW_FLOPS`` or more (the features kernel: one
    ascending fmaf chain over d a feature, so a row's features are bitwise
    the same whatever rows share the call, which the gathered parent
    features of ``features.featurize_dedup`` need), else ``"host"`` (numpy).
    Each ``transform`` is the span ``project``."""

    def __init__(self, mean, components, explained_variance, covariance=None,
                 device="cpu"):
        self.mean_ = np.asarray(mean)
        self.components_ = np.asarray(components)  # (n_components, d)
        self.explained_variance_ = np.asarray(explained_variance)
        self.covariance_ = covariance
        self.n_components = self.components_.shape[0]
        self.device = as_device(device)
        self._f32comp = self.components_.T.astype(np.float32)
        # (x - mu) C == x C - mu C: the fold saves a pass over the raw rows,
        # but cancels catastrophically in f32 for far-from-origin data, so
        # it is used only when the mean is modest against the spread
        self._offset = (
            self.mean_ @ self.components_.T.astype(np.float64)
        ).astype(np.float32)
        total_var = float(np.sum(self.explained_variance_)) or 1.0
        self._fold_ok = float(self.mean_ @ self.mean_) <= 1e6 * total_var
        wide = 2.0 * self._f32comp.size >= _KERNEL_MIN_ROW_FLOPS
        self.route = "kernel" if self.device.type == "cuda" and wide else "host"

    def _project(self, flat):
        if self.route == "host":
            return flat @ self._f32comp
        x = torch.as_tensor(flat, device=self.device).contiguous()
        c = torch.as_tensor(np.ascontiguousarray(self._f32comp), device=self.device)
        return transform_features(x, None, c)[0].cpu().numpy()

    @span("project")
    def transform(self, coords):
        if not self._fold_ok:
            # Center in f64 before the f32 cast
            flat = np.asarray(coords, np.float64).reshape(len(coords), -1)
            return self._project((flat - self.mean_).astype(np.float32))
        flat = np.asarray(coords, np.float32).reshape(len(coords), -1)
        return self._project(flat) - self._offset


class PairMomentAccumulator:
    """Streaming lagged moments for TICA/VAMP from (start, end) pairs.

    Both dtype paths store moment sums centered at the running means and
    combine batches with the lagged-pair form of Chan's update in float64.
    ``dtype=np.float32`` centers each batch in f64 on the host and runs the
    three d x d products in f32 on ``device``; the values entering them are
    centered and small, so the path is safe far from the origin."""

    def __init__(self, n_features, dtype=np.float64, device="cpu"):
        self.n = 0.0
        self.dtype = np.dtype(dtype)
        self.device = as_device(device)
        self.mu0 = np.zeros(n_features, dtype=np.float64)
        self.mut = np.zeros(n_features, dtype=np.float64)
        self.C00 = np.zeros((n_features, n_features), dtype=np.float64)
        self.C0t = np.zeros((n_features, n_features), dtype=np.float64)
        self.Ctt = np.zeros((n_features, n_features), dtype=np.float64)

    def add(self, X0, Xt, weights=None):
        if self.dtype == np.float64:
            X0 = np.asarray(X0, np.float64)
            Xt = np.asarray(Xt, np.float64)
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(X0.shape[0])
            )
            ws = w.sum()
            if ws == 0.0:
                return
            mu0b = (X0 * w[:, None]).sum(axis=0) / ws
            mutb = (Xt * w[:, None]).sum(axis=0) / ws
            X0c = X0 - mu0b[None, :]
            Xtc = Xt - mutb[None, :]
            m00 = (X0c * w[:, None]).T @ X0c
            m0t = (X0c * w[:, None]).T @ Xtc
            mtt = (Xtc * w[:, None]).T @ Xtc
        else:
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(len(X0), np.float64)
            )
            ws = float(w.sum())
            if ws == 0.0:
                return
            mu0b, X0c = _center_f64(X0, w, ws)
            mutb, Xtc = _center_f64(Xt, w, ws)
            m00 = _weighted_gram_f32(X0c, X0c, w, self.device)
            m0t = _weighted_gram_f32(X0c, Xtc, w, self.device)
            mtt = _weighted_gram_f32(Xtc, Xtc, w, self.device)

        n_new = self.n + ws
        d0 = mu0b - self.mu0
        dt = mutb - self.mut
        f = self.n * ws / n_new
        self.C00 += m00 + f * np.outer(d0, d0)
        self.C0t += m0t + f * np.outer(d0, dt)
        self.Ctt += mtt + f * np.outer(dt, dt)
        self.mu0 += d0 * (ws / n_new)
        self.mut += dt * (ws / n_new)
        self.n = n_new

    def finalize(self, method="tica", var_cutoff=0.95, epsilon=1e-10):
        """Solve the (generalized) eigenproblem in host f64 and return a
        :class:`TICAModel` projecting on the accumulator's device.

        ``tica``: reversible (symmetrized) estimation, kinetic-map scaling.
        ``vamp``: non-reversible singular-value problem, kinetic-map
        scaling."""
        n = self.n
        mu0 = self.mu0
        mut = self.mut
        C00 = self.C00 / n
        C0t = self.C0t / n
        Ctt = self.Ctt / n

        def inv_sqrt(C):
            evals, evecs = np.linalg.eigh(C)
            emax = float(evals.max()) if len(evals) else 0.0
            if emax <= 0.0:
                raise ValueError(
                    "Covariance has no positive eigenvalues (constant "
                    "features?); cannot whiten for TICA/VAMP."
                )
            # Relative rank threshold only (the deeptime convention)
            keep = evals > epsilon * emax
            return evecs[:, keep] @ np.diag(evals[keep] ** -0.5) @ evecs[:, keep].T

        if method == "tica":
            # Symmetrized estimator centered at mu = (mu0 + mut) / 2; the
            # own-mean covariances re-centered there add +-delta delta^T / 4
            mu = 0.5 * (mu0 + mut)
            delta = mu0 - mut
            dd4 = 0.25 * np.outer(delta, delta)
            C00s = 0.5 * (C00 + Ctt) + dd4
            C0ts = 0.5 * (C0t + C0t.T) - dd4
            W = inv_sqrt(C00s)
            K = W @ C0ts @ W
            evals, evecs = np.linalg.eigh(0.5 * (K + K.T))
            order = np.argsort(np.abs(evals))[::-1]
            evals, evecs = evals[order], evecs[:, order]
            components = W @ evecs
            scales = evals  # kinetic map
            mean = mu
            kinetic_var = evals**2
        elif method == "vamp":
            W0 = inv_sqrt(C00)
            Wt = inv_sqrt(Ctt)
            K = W0 @ C0t @ Wt
            U, S, _Vt = np.linalg.svd(K)
            components = W0 @ U
            scales = S
            mean = mu0
            kinetic_var = S**2
        else:
            raise ValueError(f"Unknown method {method}")

        if var_cutoff >= 1.0:
            n_comp = len(kinetic_var)
        else:
            ratio = np.cumsum(kinetic_var) / np.maximum(kinetic_var.sum(), 1e-300)
            crossed = ratio >= var_cutoff
            n_comp = int(np.argmax(crossed) + 1) if crossed.any() else len(ratio)
        n_comp = max(n_comp, 1)
        log.debug(f"{method} keeping {n_comp} components")
        return TICAModel(mean, components[:, :n_comp], scales[:n_comp],
                         device=self.device)


class TICAModel:
    """Fitted TICA/VAMP transform with kinetic-map scaling:
    ``(x - mean) @ (components * scales)``."""

    def __init__(self, mean, components, scales, device="cpu"):
        self.mean_ = np.asarray(mean)
        self.components_ = np.asarray(components)  # (d, n_components)
        self.scales_ = np.asarray(scales)
        self.output_dimension = self.components_.shape[1]
        self.device = as_device(device)
        self._f32comp = (self.components_ * self.scales_[None, :]).astype(np.float32)

    def transform(self, coords):
        # Center in f64 before the f32 cast: casting far-from-origin raw
        # coordinates first would quantize away their spread
        flat = np.asarray(coords, np.float64).reshape(len(coords), -1)
        flat = (flat - self.mean_).astype(np.float32)
        if 2.0 * flat.size * self.output_dimension < _DEVICE_TRANSFORM_MIN_FLOPS:
            return flat @ self._f32comp
        x = torch.as_tensor(flat, device=self.device)
        c = torch.as_tensor(self._f32comp, device=self.device)
        return (x @ c).cpu().numpy()
