"""The judge of the builds at NTL9 widths: ``reference/build.py``'s
``Judge``, the same numbers from the same float64 reference, with a
control one precision below the configuration's reduction.

``westpa_ntl9`` states the PCA's second moments as f32 products (on the
card, from 256 features), summed in f64. ``build.py``'s control takes the
whole PCA in float32, which at 900 raw coordinates lands within a few
times the build's own ``pca_err``; so here the control takes the moments'
products in TF32 (operands rounded to 10 mantissa bits, products summed
in f32), as the hot-step cells' control takes TF32 products, and keeps as
many components as the build (a TF32 variance may cross the cutoff at
another count, and the control's features have to meet the build's
centers). The rest of the control is ``build.py``'s: f32 features, TF32
scores, f32 flux and steady state.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import build
from benchmark.reference.hot_step import _tf32

__all__ = ["Judge"]


def _pca_tf32(X, n):
    """``(mean, components (n, d))`` of ``X`` in float32, the covariance's
    products of TF32-rounded operands."""
    X = np.asarray(X, np.float32)
    mean = X.mean(0)
    Xc = _tf32(torch.as_tensor(X - mean))
    cov = (Xc.T @ Xc).numpy() / np.float32(len(X) - 1)
    evals, evecs = np.linalg.eigh(cov)
    return mean, evecs[:, np.argsort(evals)[::-1][:n]].T


class Judge(build.Judge):
    def control(self, state):
        """``state`` with what the reference works out (PCA, ids, flux,
        steady state) redone one precision below the configuration, from the
        build's centers."""
        mean, comp = _pca_tf32(self.child_raw, len(state["pca_components"]))
        # The build's centers live in its signs of the components
        signs = np.sign((comp * state["pca_components"]).sum(1))
        comp = comp * np.where(signs == 0, 1, signs).astype(np.float32)[:, None]
        out = dict(state, pca_components=comp, models={})
        X = [(np.asarray(r, np.float32) - mean) @ comp.T
             for r in (self.parent_raw, self.child_raw)]
        for name, m in state["models"].items():
            n_states = len(m["centers"]) + 2
            eff = self._eff_bins(m["center_bin"])
            ids = []
            for side in (0, 1):
                got = self._assign(X[side], eff[side], m["centers"], m["center_bin"],
                                   torch.float32)
                forced = self._forced(side, n_states)
                ids.append(np.where(forced >= 0, forced, got))
            fm = self._flux(ids[0], ids[1], self.flux_iters[name], n_states, torch.float32)
            try:
                p, J = build._steady_state(fm, [n_states - 2], [n_states - 1], np.float32)
            except np.linalg.LinAlgError:
                # A control that gives no number has failed
                p, J = np.full(n_states, np.nan, np.float32), float("nan")
            out["models"][name] = dict(m, parent_idx=ids[0], child_idx=ids[1],
                                       flux_matrix=fm, pss=p, target_flux=J / self.lagtime)
        return out
