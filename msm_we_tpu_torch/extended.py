"""Extended analysis: h-function relaxation, Aristoffian kh binning/allocation,
1-D pcoord flux matrices, direct-flux windows, probability evolution.

Counterpart of ``msm_we_tpu/extended.py`` over the port's ``modelWE``. The
analysis is host float64 numpy, as in the JAX package. Two places reach the
model's device: the ``adaptive`` kh bins run the port's k-means
(``ops.kmeans.kmeans_fit(..., device=model.device)``), and
``_model_cluster_assign`` predicts through the model's stratified bank
(the H4 kernel on a CUDA model for batches of ``HOST_BATCH_THRESHOLD`` rows
or more) or its aggregated clusters (H4 on one bin). ``write_iter_kh_pcoord``
imports h5py when it runs.

Like the JAX module, a working re-implementation of the reference's
quarantined legacy module (``_hamsm/_untested.py`` -- "kept for legacy
purposes", pyemma-dependent, unexported). Capabilities preserved;
modernized:

* pyemma ``AssignCenters`` replaced by plain nearest-center assignment;
* the h-flux and occupancy double/quadruple loops vectorized
  (``_untested.py:238-272,406-418``);
* the ``evolve_probability*`` functions -- dead code in the reference due to
  an indentation bug nesting them inside ``get_direct_target_flux``
  (``_untested.py:903-1076``) -- are proper methods here;
* side-channel h5 caching files dropped.
"""
from __future__ import annotations

import numpy as np

from ._logging import log
from .data.arrays import ArrayWEDataset
from .model import modelWE

__all__ = ["ExtendedModelWE"]


def _assign_nearest(values, centers):
    """Nearest-center assignment for 1-D values (pyemma AssignCenters stand-in)."""
    values = np.asarray(values).reshape(-1)
    centers = np.asarray(centers).reshape(-1)
    return np.argmin(np.abs(values[:, None] - centers[None, :]), axis=1)


class ExtendedModelWE(modelWE):
    """modelWE with the legacy extended-analysis surface (reference C22)."""

    nB = 10
    nW = 100
    min_walkers = 1
    binMethod = "adaptive"
    allocationMethod = "adaptive"

    # ------------------------------------------------- 1-D pcoord flux matrix
    def get_iter_pcoord1D_fluxMatrix_lag0(self, n_iter, binbounds):
        """Flux matrix in 1-D pcoord space for one iteration
        (reference ``_untested.py:113-177``), vectorized."""
        self.load_iter_data(n_iter)
        nBins = np.asarray(binbounds).size - 1
        bins0 = np.digitize(self.pcoord0List[:, 0], binbounds) - 1
        bins1 = np.digitize(self.pcoord1List[:, 0], binbounds) - 1
        flat = bins0.astype(np.int64) * nBins + bins1
        ok = (bins0 >= 0) & (bins0 < nBins) & (bins1 >= 0) & (bins1 < nBins)
        fm = np.bincount(
            flat[ok], weights=self.weightList[ok], minlength=nBins * nBins
        ).reshape(nBins, nBins)
        return fm

    def get_pcoord1D_fluxMatrix(self, n_lag, first_iter, last_iter, binbounds):
        """Average 1-D pcoord flux matrix over iterations
        (reference ``_untested.py:50-111``, without the side h5 cache)."""
        assert n_lag == 0, "Only lag-0 is supported"
        if last_iter <= first_iter:
            raise ValueError(
                f"Need last_iter > first_iter ({first_iter}, {last_iter}): "
                "no iterations to average would yield an all-NaN matrix"
            )
        self.n_lag = n_lag
        nBins = np.asarray(binbounds).size - 1
        fluxMatrix = np.zeros((nBins, nBins))
        nI = 0
        for iS in range(first_iter + 1, last_iter + 1):
            fmI = self.get_iter_pcoord1D_fluxMatrix_lag0(iS, binbounds)
            fluxMatrix += fmI / self.weightList.sum()  # correct for multiple trees
            nI += 1
        self.pcoord1D_fluxMatrix = fluxMatrix / nI
        return self.pcoord1D_fluxMatrix

    # ------------------------------------------------------ h-function flux
    def get_hflux(self, conv, max_iters=50000):
        """h-function flux relaxation (reference ``_untested.py:225-272``).

        Iterates matrix powers, accumulating the per-state target flux and the
        h function ``h = sum_N (f_N - f_SS)``; converges when both h and the
        running steady flux stabilize. Sets ``self.h``.
        """
        ind_not_targets = np.setdiff1d(range(self.nBins), self.indTargets)
        T = np.asarray(self.Tmatrix)
        Mt = T.copy()
        fTotal = np.zeros((self.nBins, 1))
        fSSp = 0.0
        hp = np.zeros_like(fTotal)
        dconvh = dconvf = np.inf
        N = 1
        while (dconvh > conv or dconvf > conv) and N < max_iters:
            # f[i] = sum_{targets jj} sum_{j not target} Mt[i, j] Mt[j, jj] / tau
            inner = Mt[np.ix_(ind_not_targets, np.asarray(self.indTargets))].sum(axis=1)
            f = (Mt[:, ind_not_targets] @ inner)[:, None] / self.tau
            fTotal += f
            fSS = np.mean(f[ind_not_targets, 0])
            ht = fTotal - N * fSS
            dconvh = np.max(np.abs(hp - ht)) / max(np.max(ht), 1e-300)
            dconvf = np.abs(fSS - fSSp) / max(abs(fSS), 1e-300)
            log.debug(f"N={N} dh={dconvh:.2e} df={dconvf:.2e} Jss={fSS:.3e}")
            hp = ht.copy()
            fSSp = fSS
            self.h = ht.copy()
            Mt = Mt @ T
            N += 1
        return self.h

    def get_model_aristoffian(self):
        """kh = K h and its per-state variance (reference ``_untested.py:274-282``)."""
        T = np.asarray(self.Tmatrix)
        h = np.asarray(self.h).reshape(-1, 1)
        kh = T @ h
        varh = T @ (h**2) - kh**2
        self.kh = kh
        self.varh = varh
        return kh, varh

    # ---------------------------------------------------------- kh binning
    def _kh_bin_centers(self, nB):
        """Bin centers for the current binMethod (reference dispatch,
        ``_untested.py:284-360``)."""
        kh = self.kh.reshape(-1)
        if self.binMethod == "adaptive":
            from .ops.kmeans import kmeans_fit

            centers, _ = kmeans_fit(kh[:, None], None, min(nB, len(kh)), seed=0,
                                    device=self.device)
            centers = np.unique(centers[:, 0])
            if centers.size != nB:
                khbins = np.linspace(kh.min(), kh.max(), nB + 1)
                centers = 0.5 * (khbins[1:] + khbins[:-1])
        elif self.binMethod == "uniform":
            khbins = np.linspace(kh.min(), kh.max(), nB + 1)
            centers = 0.5 * (khbins[1:] + khbins[:-1])
        elif self.binMethod == "log_uniform":
            shift = 2.0 * np.abs(kh.min())
            transformed = np.geomspace(
                np.abs(kh.min()) / kh.max(),
                1.0 + shift / kh.max(),
                nB + 1,
            )
            khbins = transformed * kh.max() - shift
            centers = 0.5 * (khbins[1:] + khbins[:-1])
        elif self.binMethod == "optimized":
            centers = getattr(self, "khbins_binCenters", None)
            if centers is None:
                try:
                    centers = np.loadtxt("khbins_binCenters.dat")
                except OSError:
                    log.warning("khbins_binCenters.dat not found; initializing")
                    self.get_initial_khbins_equalAlloc()
                    centers = self.khbins_binCenters
        else:
            raise ValueError(f"Unknown binMethod {self.binMethod}")
        return np.asarray(centers).reshape(-1)

    def get_bin_total_var(self, x):
        """Total-variance objective for external kh-bin-center optimizers
        (reference ``_untested.py:572-579``): evaluate the Aristoffian
        allocation at the candidate centers ``x`` and return
        ``binObjective``."""
        self.binMethod = "optimized"
        self.khbins_binCenters = np.asarray(x).reshape(-1)
        self.get_model_steady_state_aristoffian()
        return self.binObjective

    def get_model_steady_state_aristoffian(self):
        """Aristoffian bin allocation and objective (reference
        ``_untested.py:284-469``), with the occupancy double sums vectorized.

        Sets ``alloc`` (per-bin walker allocation weights), ``walkers_per_bin``,
        ``binObjective`` (total mutation+selection variance), ``khbins_*``.

        Ordering quirk kept for reference parity: ``walkers_per_bin``,
        ``bin_kh_var``, ``bin_mutV``, ``bin_selV``, ``nOccupancySS`` and
        ``rhomutation`` are reindexed into sorted-``khbins_binCenters`` order,
        but ``alloc`` and ``value`` stay in raw cluster order
        (``_untested.py:382,470`` never applies ``ind`` to them) -- pair them
        with the unsorted centers, not with ``khbins_binCenters``.
        """
        nB = int(self.nB)
        centers = self._kh_bin_centers(nB)
        kh = self.kh.reshape(-1)
        varh = self.varh.reshape(-1)
        pSS = np.asarray(self.pSS).reshape(-1)
        T = np.asarray(self.Tmatrix)

        dtraj = _assign_nearest(kh, centers)
        nB_eff = len(centers)

        # Per-bin allocation: w_bin * sqrt(weighted mean varh)
        alloc = np.zeros(nB_eff)
        value = np.zeros(nB_eff)
        bin_kh_var = np.zeros(nB_eff)
        for i in range(nB_eff):
            members = dtraj == i
            if not members.any():
                continue
            bin_kh_var[i] = np.var(kh[members])
            wt = pSS[members].sum()
            vw = np.sum(pSS[members] / wt * varh[members])
            alloc[i] = wt * vw**0.5
            value[i] = vw**0.5
        if self.allocationMethod == "uniform":
            alloc = np.ones_like(alloc)
        alloc = alloc / alloc.sum()
        self.alloc = alloc

        # Occupancy after mutation: rho[u] = sum_v alloc[v] * P(v -> u)
        # (vectorized form of the reference's quadruple loop,
        # _untested.py:406-418). B[v, p] = 1 if state p in bin v.
        B = np.zeros((nB_eff, len(pSS)))
        B[dtraj, np.arange(len(pSS))] = 1.0
        w_bin = B @ pSS
        with np.errstate(invalid="ignore", divide="ignore"):
            source = (B * pSS[None, :]) / np.where(w_bin[:, None] > 0, w_bin[:, None], 1.0)
        rhov = (alloc[:, None] * source) @ T @ B.T  # (v, u)
        rho = rhov.sum(axis=0)

        pOccupied = 1.0 - np.power(1.0 - rho, self.nW)
        nOccupied = nB_eff - np.sum(np.power(1.0 - rho, self.nW))
        nAdditional = (self.nW - nOccupied) * alloc
        nT = nAdditional + pOccupied

        bin_mutV = np.zeros(nB_eff)
        bin_selV = np.zeros(nB_eff)
        for i in range(nB_eff):
            members = dtraj == i
            if not members.any() or nT[i] <= 0:
                continue
            wi = pSS[members].sum()
            bin_mutV[i] = (wi**2 / nT[i]) * np.sum(pSS[members] / wi * varh[members])
            bin_selV[i] = (wi**2 / nT[i]) * np.sum(
                pSS[members] / wi * kh[members] ** 2
                - (pSS[members] / wi * kh[members]) ** 2
            )
        self.binObjective = np.sum(bin_mutV + bin_selV)

        ind = np.argsort(centers)
        self.khbins_binCenters = centers[ind]
        binEdges = np.zeros(nB_eff + 1)
        binEdges[0], binEdges[-1] = -np.inf, np.inf
        binEdges[1:-1] = 0.5 * (
            self.khbins_binCenters[1:] + self.khbins_binCenters[:-1]
        )
        self.khbins_binEdges = binEdges
        self.bin_kh_var = bin_kh_var[ind]

        base_walkers = self.min_walkers * np.ones_like(alloc)
        nAdapt = max(self.nW - nOccupied, 0)
        walkers = np.round(alloc * nAdapt) + base_walkers
        walkers[walkers == 0.0] = 1.0
        self.walkers_per_bin = walkers[ind].astype(int)
        self.bin_mutV = bin_mutV[ind]
        self.bin_selV = bin_selV[ind]
        self.nOccupancySS = nT[ind]
        self.nOccupied = nOccupied
        self.nAdapt = nAdapt
        self.rhomutation = rho[ind]
        self.value = value

    def get_initial_khbins(self):
        """Log-uniform kh bin edges (reference ``_untested.py:471-500``)."""
        kh = self.kh.reshape(-1)
        shift = 2.0 * np.abs(kh.min())
        transformed = np.geomspace(
            np.abs(kh.min()) / kh.max(), 1.0 + shift / kh.max(), self.nB + 1
        )
        khbins = transformed * kh.max() - shift
        centers = 0.5 * (khbins[1:] + khbins[:-1])
        ind = np.argsort(centers)
        self.khbins_binCenters = centers[ind]
        binEdges = np.zeros(self.nB + 1)
        binEdges[0], binEdges[-1] = -np.inf, np.inf
        binEdges[1:-1] = 0.5 * (
            self.khbins_binCenters[1:] + self.khbins_binCenters[:-1]
        )
        self.khbins_binEdges = binEdges
        np.savetxt("khbins_binCenters.dat", self.khbins_binCenters)

    def get_initial_khbins_equalAlloc(self):
        """kh bins of approximately equal allocation value (reference
        ``_untested.py:502-547``)."""
        if not hasattr(self, "kh"):
            self.get_model_aristoffian()
        saved = (self.binMethod, self.allocationMethod, self.nB)
        self.binMethod, self.allocationMethod = "uniform", "adaptive"
        points = np.linspace(0, 1, saved[2])
        self.nB = 10000
        self.get_model_steady_state_aristoffian()
        dist = np.cumsum(self.alloc / self.alloc.sum())
        dist_unique, ind_unique = np.unique(dist, return_index=True)
        kh_unique = self.khbins_binCenters[ind_unique]
        xB = np.zeros_like(points)
        for i in range(xB.size):
            indm = np.argmin(np.abs(dist_unique - points[i]))
            xB[i] = kh_unique[indm]
            dist_unique[indm] = np.inf
        self.binMethod, self.allocationMethod, self.nB = saved
        centers = np.sort(xB)
        self.khbins_binCenters = centers
        binEdges = np.zeros(self.nB + 1)
        binEdges[0], binEdges[-1] = -np.inf, np.inf
        binEdges[1:-1] = 0.5 * (centers[1:] + centers[:-1])
        self.khbins_binEdges = binEdges
        np.savetxt("khbins_binCenters.dat", centers)

    def get_bin_kh_var(self, x):
        """Total within-bin kh variance for candidate centers ``x``
        (reference ``_untested.py:549-570``)."""
        dtraj = _assign_nearest(self.kh, x)
        kh = self.kh.reshape(-1)
        total = 0.0
        bin_kh_var = np.zeros(len(np.asarray(x).reshape(-1)))
        for i in range(len(bin_kh_var)):
            members = dtraj == i
            if members.any():
                bin_kh_var[i] = np.var(kh[members])
        self.bin_kh_var = bin_kh_var
        self.total_bin_kh_var = bin_kh_var.sum()
        return self.total_bin_kh_var

    # ------------------------------------------------------- direct fluxes
    def get_warps_from_parent(self, first_iter, last_iter):
        """Weights of recycled walkers per iteration, via parent ids
        (reference ``_untested.py:798-822``)."""
        warped_weights = []
        # iS + 1 must be a usable iteration; the dataset excludes the final
        # incomplete one, so clamp (the reference reads the raw h5 directly)
        usable_last = min(last_iter, self.maxIter - 1)
        if usable_last < last_iter:
            log.warning(
                f"Clamping last_iter to {usable_last}: iteration "
                f"{last_iter + 1} is not usable."
            )
        for iS in range(first_iter + 1, usable_last + 1):
            self.load_iter_data(iS + 1)
            self.get_seg_histories(2)
            parent_list = self.seg_histories[:, 1]
            warped = parent_list < 0
            warped_weights.append(self.weightList[warped])
        return warped_weights

    def get_warps_from_pcoord(self, first_iter, last_iter):
        """Weights of target-reaching walkers per iteration, via pcoords
        (reference ``_untested.py:824-838``)."""
        warped_weights = []
        for iS in range(first_iter, last_iter + 1):
            self.load_iter_data(iS)
            warped = self.is_WE_target(self.pcoord1List)
            warped_weights.append(self.weightList[warped])
        return warped_weights

    def get_direct_target_flux(self, first_iter, last_iter, window):
        """Windowed direct (recycled-weight) target flux estimate
        (reference ``_untested.py:840-901``, without the side h5 cache)."""
        n_iterations = last_iter - first_iter
        warped_weights = self.get_warps_from_pcoord(first_iter, last_iter)
        self.warpedWeights = warped_weights

        Jdirect = np.zeros(n_iterations - 1)
        JdirectTimes = np.zeros(n_iterations - 1)
        for iS in range(n_iterations - 1):
            start = max(iS - window, 0)
            end = iS + 1
            nI = end - start
            ws = np.concatenate(warped_weights[start:end]) if end > start else np.array([])
            if ws.size:
                particles = ws.size * ws / nI
                Jdirect[iS] = particles.mean()
            JdirectTimes[iS] = (first_iter + iS) * self.tau
        self.Jdirect = Jdirect / self.tau / self.n_data_files
        self.JdirectTimes = JdirectTimes
        return self.Jdirect, self.JdirectTimes

    # -------------------------------------------------- probability evolution
    def _evolve(self, p0, nEvolve, nStore):
        n_iterations = int(np.ceil(nEvolve / nStore)) + 1
        self.nEvolve = nEvolve
        self.nStore = nStore
        T = np.asarray(self.Tmatrix)
        p = np.asarray(p0, dtype=float).reshape(1, -1)
        prob_transient = np.zeros((n_iterations, self.nBins))
        prob_transient[0] = p
        iT = 1
        for i in range(nEvolve):
            p = p @ T
            if i % nStore == 0:
                prob_transient[iT] = p
                iT += 1
        self.probTransient = prob_transient[:iT]
        p = np.squeeze(np.asarray(p))
        # Final relaxed distribution exposed WITHOUT clobbering self.pSS:
        # the reference version assigns it to pSS, silently corrupting any
        # later steady-state-dependent analysis (target flux, committors)
        # run after a diagnostic relaxation. That side effect lived only in
        # unreachable code there; making the methods live means dropping it.
        self.pEvolved = p / p.sum()
        return self.probTransient

    def evolve_probability(self, nEvolve, nStore):
        """Relax probability started in the basis (reference
        ``_untested.py:903-957``; a *method* here -- the reference
        accidentally nests it inside ``get_direct_target_flux``)."""
        p0 = np.zeros(self.nBins)
        p0[np.asarray(self.indBasis)] = 1.0
        return self._evolve(p0, nEvolve, nStore)

    def evolve_probability2(self, nEvolve, nStore):
        """Relax probability spread uniformly over everything at/above the
        basis index (reference ``_untested.py:959-1018``)."""
        p0 = np.zeros(self.nBins)
        p0[int(self.indBasis[0]):] = 1.0
        p0 /= p0.sum()
        return self._evolve(p0, nEvolve, nStore)

    def evolve_probability_from_initial(self, p0, nEvolve, nStore):
        """Relax a user-provided initial distribution (reference
        ``_untested.py:1020-1076``)."""
        return self._evolve(np.asarray(p0), nEvolve, nStore)

    def load_clusters(self, clusterFile):
        raise NotImplementedError(
            "pyemma cluster files are not supported; rebuild clusters with "
            "cluster_coordinates() (the reference's loader was legacy pyemma "
            "code, _untested.py:27-48)."
        )

    # ------------------------------------------ per-iteration kh machinery
    def _model_cluster_assign(self, coords, pcoords):
        """Assign structures to the cleaned model's clusters in the flux
        matrix's (pcoord-sorted) numbering.

        The working replacement for the reference's pyemma
        ``get_model_clusters``/``AssignCenters`` flow
        (``_untested.py:179-223``): assignment runs through the model's own
        discretization (aggregated bank or stratified per-bin bank), then
        the raw global-id indices map through the sort permutation recorded
        by ``organize_fluxMatrix`` (basis/target land on their pinned last
        two positions either way).
        """
        assert getattr(self, "pcoord_sort_indices", None) is not None, (
            "Run organize_fluxMatrix() first"
        )
        feats = self.reduceCoordinates(np.nan_to_num(np.asarray(coords)))
        if self._strat is not None:
            # predict applies we_remap internally; remapping here too would
            # double-apply it (harmless only while remaps stay idempotent)
            bins = self._bin_mapper.assign(np.nan_to_num(np.asarray(pcoords)))
            raw = self._strat.predict(
                feats, bins,
                is_basis=self.is_WE_basis(pcoords),
                is_target=self.is_WE_target(pcoords),
            )
        else:
            raw = self.clusters.predict(feats)
        inv = np.empty(self.nBins, dtype=int)
        inv[np.asarray(self.pcoord_sort_indices)] = np.arange(self.nBins)
        return inv[np.clip(raw, 0, self.nBins - 1)]

    def get_iter_aristoffian(self, iteration):
        """Per-segment kh values for one iteration's final structures
        (reference ``get_iter_aristoffian``, ``_untested.py:581-729``,
        which is unreachable there -- it depends on the broken pyemma
        loader). Requires ``get_model_aristoffian()``.
        Populates and returns ``self.khList`` (n_segs, 1)."""
        assert getattr(self, "kh", None) is not None, (
            "Run get_model_aristoffian() first"
        )
        self.load_iter_data(iteration)
        _parent, child, _w = self._dataset.iter_coord_pairs(iteration)
        idx = self._model_cluster_assign(child, self.pcoord1List)
        kh = np.asarray(self.kh).reshape(-1)
        self.khList = kh[idx][:, None]
        return self.khList

    def write_iter_kh_pcoord(self):
        """Extend the current iteration's pcoord dataset with kh values.

        Writes a (n_segs, 2, 2) pcoord per west.h5 file: dim 0 keeps the
        original progress coordinate, dim 1 carries kh of the pre/post
        structures -- the Aristoffian-WE extended pcoord (reference
        ``write_iter_kh_pcoord``, ``_untested.py:731-800``, which re-reads
        trajectory files with mdtraj; here the already-augmented auxdata
        coordinates are used).
        """
        import h5py

        assert getattr(self, "kh", None) is not None, (
            "Run get_model_aristoffian() first"
        )
        if isinstance(self._dataset, ArrayWEDataset):
            raise ValueError("write_iter_kh_pcoord writes west.h5 files; the "
                             "model reads an in-memory ArrayWEDataset")
        n_iter = self.n_iter
        parent, child, _w = self._dataset.iter_coord_pairs(n_iter)
        kh = np.asarray(self.kh).reshape(-1)
        idx0 = self._model_cluster_assign(parent, self.pcoord0List)
        idx1 = self._model_cluster_assign(child, self.pcoord1List)

        d = self._dataset.iter_data(n_iter)
        pcoords = np.zeros((d["n_segs"], 2, 2))
        pcoords[:, 0, 0] = self.pcoord0List[:, 0]
        pcoords[:, 1, 0] = self.pcoord1List[:, 0]
        pcoords[:, 0, 1] = kh[idx0]
        pcoords[:, 1, 1] = kh[idx1]

        # Release cached read handles: an "a" open conflicts with a live
        # "r" open of the same file in-process (HDF5 locking)
        self._dataset.close()
        for f_idx in np.unique(d["west_idx"]):
            rows = d["west_idx"] == f_idx
            with h5py.File(self.fileList[int(f_idx)], "a") as h5:
                grp = h5[f"iterations/iter_{int(n_iter):08d}"]
                del grp["pcoord"]
                grp.create_dataset("pcoord", data=pcoords[rows])
        # Cached index data for this iteration is now stale
        self._dataset._iter_data.pop(n_iter, None)
        return pcoords
