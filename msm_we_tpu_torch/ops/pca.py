"""Streaming PCA (counterpart of ``MomentAccumulator``, ``PCAModel`` and
``IdentityCoordinates`` in ``msm_we_tpu/ops/pca.py``).

Moments are accumulated per batch and combined across batches with Chan's
pairwise update in float64. The default per-batch path is float64 numpy
(exact covariance parity with the JAX package); ``dtype=np.float32`` runs
the d x d second-moment product in f32 on a torch device. The fitted
transform projects in host numpy below ``_DEVICE_TRANSFORM_MIN_FLOPS`` and
with an f32 ``torch.matmul`` on the model's device above it. TICA/VAMP
(``PairMomentAccumulator``, ``TICAModel``) are not ported yet (ROADMAP,
queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_device
from .._logging import log

__all__ = ["IdentityCoordinates", "PCAModel", "MomentAccumulator"]

# Below this many flops a projection runs in host numpy: a device round
# trip dwarfs the product for small chunks
_DEVICE_TRANSFORM_MIN_FLOPS = 5e7


class IdentityCoordinates:
    """Identity transform (the reference's ``Coordinates`` stub)."""

    def transform(self, coords):
        return coords


class MomentAccumulator:
    """Streaming first/second moments for PCA, combined across batches in
    float64. ``dtype=np.float32`` computes each batch's second moment as an
    f32 product on ``device`` (after f64 centering on the host)."""

    def __init__(self, n_features, dtype=np.float64, device="cpu"):
        self.n = 0.0  # total weight (== sample count when unweighted)
        self.n_samples = 0
        self.dtype = np.dtype(dtype)
        self.device = as_device(device)
        self.mean = np.zeros(n_features, dtype=np.float64)
        self.M2 = np.zeros((n_features, n_features), dtype=np.float64)

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
        mean_b = (X * w[:, None]).sum(axis=0) / ws
        Xc = X - mean_b[None, :]
        if self.dtype == np.float64:
            M2_b = (Xc * w[:, None]).T @ Xc
        else:
            Xt = torch.as_tensor(Xc.astype(np.float32), device=self.device)
            wt = torch.as_tensor(w.astype(np.float32), device=self.device)
            M2_b = ((Xt * wt[:, None]).T @ Xt).double().cpu().numpy()
        n_new = self.n + ws
        delta = mean_b - self.mean
        self.M2 += M2_b + np.outer(delta, delta) * (self.n * ws / n_new)
        self.mean += delta * (ws / n_new)
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
        cov = self.M2 / denom
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
            self.mean, evecs[:, :n_components].T, evals[:n_components], cov,
            device=self.device,
        )


class PCAModel:
    """Fitted PCA transform: ``(x - mean) @ components.T``."""

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

    def _project(self, flat):
        if 2.0 * flat.size * self.n_components < _DEVICE_TRANSFORM_MIN_FLOPS:
            return flat @ self._f32comp
        x = torch.as_tensor(flat, device=self.device)
        c = torch.as_tensor(self._f32comp, device=self.device)
        return (x @ c).cpu().numpy()

    def transform(self, coords):
        if not self._fold_ok:
            # Center in f64 before the f32 cast
            flat = np.asarray(coords, np.float64).reshape(len(coords), -1)
            return self._project((flat - self.mean_).astype(np.float32))
        flat = np.asarray(coords, np.float32).reshape(len(coords), -1)
        return self._project(flat) - self._offset
