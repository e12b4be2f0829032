"""modelWE facade of the port: the haMSM build on one device.

Counterpart of ``msm_we_tpu/model.py::modelWE``: the build
``build_analyze_model`` (ingest -> PCA, TICA, VAMP or batch PCA ->
stratified k-means per WE bin, or aggregated k-means -> discretize parent
and child frames -> f64 flux matrix -> cleaning -> transition matrix ->
steady state -> JtargetSS -> block cross-validation),
lagged flux matrices, the analysis a user runs on a built model
(committors, flux profiles, implied timescales, the Chapman-Kolmogorov
test, the bootstrap confidence interval) and checkpointing. The attribute
names are the JAX package's (``fluxMatrixRaw``, ``fluxMatrix``, ``pSS``,
``JtargetSS``, ``stage_timings``, ``dtrajs``, ``pair_dtrajs``,
``validation_models``, ...).

A model runs on one device, ``modelWE(device="cuda")``, the default; a
caller asks for the CPU with ``device="cpu"`` (the tests do), and nothing
falls back to the CPU when no card is present. Several cards build one
model as one process each (``torchrun --nproc_per_node=N``, every rank
running the same script on the same inputs) after ``model.enable_mesh()``:
the discretization, the device flux and the device cluster statistics then
split their rows over the mesh's 'data' axis and the center bank over its
'model' axis (``parallel/``), and every rank ends with the same model and
its dtrajs, which one rank may then read alone; a later call that takes a
device route (cluster statistics, flux) is collective, so every rank makes
it. With
CUDA the discretization, the streaming clustering scan, the device-family
seeding, the aggregated k-means and the cleaning re-assignments launch the
hand-written kernels of ``ops/stratified_assign.py``; with the CPU they
run the plain versions.
``device_pipeline`` picks the discretization route: the pair route
(``True``, parent and child rows in one pair launch) or the predict route
(``False``, the default of ``build_analyze_model``: the 2N concatenated
rows through ``StratifiedKmeans.predict``). ``build_analyze_model(
device_pipeline=True)`` enables a mesh when none is set (the (1, 1) mesh
without a process group: every route is then the one-device route). Where
the JAX package asks whether a mesh is enabled, the port asks
``device_pipeline``; ``model._mesh`` says over which ranks. With it a
stratified build without cross-validation defers its discretization to the
flux stage, and the opt-in device routes open (the fused H3 flux,
``fluxmatrix.device_flux_lag0``, and the device cluster statistics,
``structures._get_cluster_centers_device``; switched on by
``MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS``, ``MSM_WE_TPU_DEVICE_STATS_MIN_ROWS``
or ``_force_device_flux``). With the knobs unset a build materializes its
ids once and sums the flux on the host. The analysis tail stays in host
float64.

The data come from a list of west.h5 paths, read by
:class:`~msm_we_tpu_torch.data.WEDataset` (this needs h5py), or in memory as
an :class:`~msm_we_tpu_torch.data.ArrayWEDataset` passed in their place.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import bootstrap as _bootstrap
from . import cleaning as _cleaning
from . import discretization as _discretization
from . import fluxmatrix as _fluxmatrix
from ._device import as_device
from ._logging import ProgressBar, log  # noqa: F401  (re-exported, as the JAX package does)
from .binning import find_nearest_bin
from .data.arrays import ArrayWEDataset
from .data.westh5 import WEDataset
from .features import device_row_feats, featurize_all
from .parallel.mesh import Mesh, bank_digest, make_mesh
from .ops import linalg
from .ops.kmeans import assign_flat, kmeans_fit
from .ops.pca import IdentityCoordinates, MomentAccumulator, PairMomentAccumulator
from .ops.stratified import StratifiedKmeans
from .tracing import span

SUPPORTED_DIMREDUCE = ["none", "pca", "tica", "vamp", "batch-pca"]


def default_process_coordinates(coords):
    """Default featurization: flatten (n, atoms, 3) -> (n, atoms*3)."""
    coords = np.asarray(coords)
    return coords.reshape(coords.shape[0], -1)


class _BinModelView:
    """Per-bin compatibility view with a ``cluster_centers_`` attribute."""

    def __init__(self, strat, bin_idx):
        self._strat = strat
        self._bin = bin_idx

    @property
    def cluster_centers_(self):
        return self._strat.centers_of_bin(self._bin)


class StratifiedClustersShim:
    """Stand-in for the reference's ``StratifiedClusters``: ``cluster_models``
    (per-bin views), ``we_remap``, ``bin_mapper`` and ``predict`` with the
    reference's ``toggle``/``processing_from`` flip-flop
    (``stratified_clustering.py:101-212``), backed by the flat
    :class:`~msm_we_tpu_torch.ops.stratified.StratifiedKmeans` bank."""

    def __init__(self, bin_mapper, model, strat):
        self.bin_mapper = bin_mapper
        self.model = model
        self.strat = strat
        self.n_clusters_per_bin = strat.k
        self.processing_from = False
        self.toggle = False
        self.target_bins = set()
        self.basis_bins = set()

    @property
    def cluster_models(self):
        return [
            _BinModelView(self.strat, b) if self.strat.initialized[b] else object()
            for b in range(self.strat.n_bins)
        ]

    @property
    def we_remap(self):
        return {i: int(v) for i, v in enumerate(self.strat.we_remap)}

    @property
    def n_total_clusters(self):
        return self.strat.n_total_clusters

    def predict(self, coords):
        """Ids of ``coords`` with WE bins from the model's current pcoord
        lists: ``processing_from`` picks ``pcoord0List`` (parents) or
        ``pcoord1List`` (children); ``toggle`` alternates it after each
        call."""
        model = self.model
        pcoords = model.pcoord0List if self.processing_from else model.pcoord1List
        we_bins = self.bin_mapper.assign(pcoords)
        is_target = model.is_WE_target(pcoords)
        is_basis = model.is_WE_basis(pcoords)
        # The reference records remapped bins (stratified_clustering.py:135,
        # 163-169)
        remapped = self.strat.we_remap[we_bins]
        self.target_bins.update(np.unique(remapped[is_target]).tolist())
        self.basis_bins.update(np.unique(remapped[is_basis]).tolist())
        result = self.strat.predict(
            np.asarray(coords), we_bins, is_basis=is_basis, is_target=is_target
        )
        if self.toggle:
            self.processing_from = not self.processing_from
        return result


class _AggregateClustersShim:
    """Aggregate (non-stratified) k-means bank: ``cluster_centers_`` and an
    sklearn-style ``predict`` through ``ops.kmeans.assign_flat`` on
    ``device`` (the H4 kernel on CUDA)."""

    def __init__(self, centers, device="cpu"):
        self.cluster_centers_ = np.asarray(centers)
        self.device = as_device(device)

    def predict(self, X):
        dev = self.device
        ids = assign_flat(
            torch.as_tensor(np.asarray(X, np.float32), device=dev),
            torch.as_tensor(self.cluster_centers_.astype(np.float32), device=dev),
            torch.ones(len(self.cluster_centers_), dtype=torch.bool, device=dev),
        )
        return ids.cpu().numpy().astype(np.int64)


class modelWE:
    """History-augmented Markov state model estimation from WE data, on
    ``device`` ("cuda", the default, runs the kernels; "cpu" the plain
    PyTorch versions). Without a CUDA device the default raises."""

    class BlockValidationError(Exception):
        pass

    # Testing/diagnostic switch: take the fused device flux route
    # (fluxmatrix.device_flux_lag0) wherever it is open, whatever the row
    # count and whether or not the ids are stored
    _force_device_flux = False
    # The mesh of ranks the device routes run over (enable_mesh); None: one
    # device
    _mesh = None

    def __init__(self, device="cuda"):
        self.device = as_device(device)
        # The discretization route: pair launches (True) or the predict
        # route over the 2N concatenated rows (False);
        # build_analyze_model sets it from its argument
        self.device_pipeline = True
        self.modelName = None
        self.pcoord_ndim = None
        self.pcoord_len = None
        self.tau = None
        self.n_lag = 0

        self._basis_pcoord_bounds = None
        self._target_pcoord_bounds = None
        self.basis_bin_centers = None
        self.target_bin_centers = None

        self.basis_coords = None
        self.coordinates = None
        self.ndim = None
        self.dimReduceMethod = None
        self.dedup_coordinates = "auto"

        self.n_clusters = None
        self.clusters = None
        self.clustering_method = None
        self.dtrajs = None
        self.pair_dtrajs = None
        self._parent_idx = None
        self._child_idx = None
        self._scored_on_host = None

        self.fluxMatrixRaw = None
        self.fluxMatrix = None
        self.Tmatrix = None
        self.pSS = None
        self.JtargetSS = None
        self.lagtime = None
        self.indBasis = None
        self.indTargets = None
        self.nBins = None

        self.q = None
        self.Jq = None
        self.J = None
        self.fit_parameters = {}

        self.targetRMSD_centers = None
        self.targetRMSD_minmax = None
        self.all_centers = None
        self.sorted_centers = None
        self.use_weights_in_clustering = False
        self.processCoordinates = default_process_coordinates

        self._dataset = None
        self._features = None
        self._strat = None
        self._bin_mapper = None
        self._fluxMatrixParams = None
        self._cluster_seed = 0
        self.post_cluster_model = None
        # The JAX package's defaults for what later stages fill in
        self.reference_structure = None
        self.reference_coord = None
        self.nAtoms = None
        self.coord_ndim = 3
        self.target_bin_center = None
        self.basis_bin_center = None
        self.slope_overcorrected = None
        self.targetRMSD_all = None
        self.removed_clusters = []
        self.cluster_structures = None
        self.cluster_structure_weights = None
        self.structure_iteration_segments = None
        self.pcoord_cache = None
        self.validation_models = []
        self.validation_iterations = []
        self.pre_discretization_model = None

    # ------------------------------------------------------------------ init
    def initialize(self, fileSpecifier, refPDBfile, modelName,
                   basis_pcoord_bounds=None, target_pcoord_bounds=None,
                   dim_reduce_method="none", tau=None, pcoord_ndim=1,
                   auxpath="coord", _suppress_boundary_warning=False,
                   use_weights_in_clustering=False, processCoordinates=None,
                   dedup_coordinates="auto"):
        """Set up the model (reference ``initialize``, ``msm_we.py:143-277``).

        ``fileSpecifier`` is a list of west.h5 paths (a space-separated
        string is deprecated), read through a :class:`WEDataset` with
        ``pcoord_ndim`` and ``auxpath``, or an :class:`ArrayWEDataset`
        holding the same data in memory. ``dedup_coordinates``
        ("auto", True, False) gathers parent features from the previous
        iteration's child features under WE continuity.
        """
        in_memory = isinstance(fileSpecifier, ArrayWEDataset)
        if in_memory and auxpath != "coord":
            raise ValueError("an ArrayWEDataset holds its coordinates as 'coord'")
        if dedup_coordinates not in (True, False, "auto"):
            raise ValueError(
                "dedup_coordinates must be True, False, or 'auto', got "
                f"{dedup_coordinates!r}"
            )
        if dedup_coordinates != "auto":
            dedup_coordinates = bool(dedup_coordinates)
        self.dedup_coordinates = dedup_coordinates
        self.modelName = modelName
        if in_memory:
            if fileSpecifier.pcoord_ndim != pcoord_ndim:
                raise ValueError(
                    f"dataset has pcoord_ndim={fileSpecifier.pcoord_ndim}, "
                    f"initialize was given {pcoord_ndim}"
                )
            fileList = ["<in-memory>"]
        elif isinstance(fileSpecifier, str):
            fileList = fileSpecifier.split(" ")
            log.warning("HDF5 file paths provided as a string is deprecated; pass a list.")
        else:
            fileList = list(fileSpecifier)
        self.fileList = fileList
        self.n_data_files = len(fileList)
        self.pcoord_ndim = pcoord_ndim
        # Provisional; replaced by the file's actual frames per segment on
        # the first load_iter_data (reference ``_data.py:843``)
        self.pcoord_len = 2
        self.auxpath = auxpath

        if basis_pcoord_bounds is not None:
            self.basis_pcoord_bounds = basis_pcoord_bounds
        elif not _suppress_boundary_warning:
            log.warning("No basis coord bounds provided to initialize().")
        if target_pcoord_bounds is not None:
            self.target_pcoord_bounds = target_pcoord_bounds
        elif not _suppress_boundary_warning:
            log.warning("No target coord bounds provided to initialize().")

        if tau is None:
            log.warning("No tau provided, defaulting to 1.")
            tau = 1.0
        self.tau = float(tau)

        self.refPDBfile = refPDBfile
        self.set_topology(refPDBfile)

        if dim_reduce_method is None:
            dim_reduce_method = "pca"
        if dim_reduce_method not in SUPPORTED_DIMREDUCE:
            raise ValueError(f"dim_reduce_method must be one of {SUPPORTED_DIMREDUCE}")
        self.dimReduceMethod = dim_reduce_method
        if processCoordinates is not None:
            self.processCoordinates = processCoordinates
        self.use_weights_in_clustering = use_weights_in_clustering

        self._dataset = fileSpecifier if in_memory else WEDataset(
            fileList, pcoord_ndim=pcoord_ndim, auxpath=auxpath
        )
        # Re-initialization drops every cache derived from a previous
        # dataset: stale features or cluster banks would describe old data
        self._features = None
        self._raw_bins_cache = None
        self._pc_masks_cache = None
        self._dev_feats_cache = None
        self._device_flux_row_cache = None
        self._device_p1_cache = None
        self._strat = None
        self._bin_mapper = None
        self._fluxMatrixParams = None
        self.clusters = None
        self.dtrajs = None
        try:
            self.load_iter_data(1)
            # Probe the augmented coordinates too: the flag must reflect
            # auxdata presence, not just seg_index (reference
            # msm_we.py:265-273 calls load_iter_coordinates0 here)
            self._dataset.iter_coord_pairs(1)
            self.coordsExist = True
        except KeyError:
            # Only the coords-not-written-yet case is benign (reference
            # msm_we.py:270); anything else surfaces loudly
            if not _suppress_boundary_warning:
                log.warning("Model initialized, but coordinates do not exist yet.")
            self.coordsExist = False

    # ------------------------------------------------------- bounds & states
    @property
    def basis_pcoord_bounds(self):
        return self._basis_pcoord_bounds

    @basis_pcoord_bounds.setter
    def basis_pcoord_bounds(self, bounds):
        self._basis_pcoord_bounds = self._check_bounds(bounds)
        self.basis_bin_centers = self._bin_centers_of_bounds(self._basis_pcoord_bounds)
        self._invalidate_pcoord_caches()

    @property
    def target_pcoord_bounds(self):
        return self._target_pcoord_bounds

    @target_pcoord_bounds.setter
    def target_pcoord_bounds(self, bounds):
        self._target_pcoord_bounds = self._check_bounds(bounds)
        self.target_bin_centers = self._bin_centers_of_bounds(self._target_pcoord_bounds)
        self._invalidate_pcoord_caches()

    # Deprecated 1-D aliases (reference msm_we.py:279-298, 365-387)
    @property
    def WEbasisp1_bounds(self):
        return self.basis_pcoord_bounds

    @WEbasisp1_bounds.setter
    def WEbasisp1_bounds(self, bounds):
        self.basis_pcoord_bounds = bounds

    @property
    def WEtargetp1_bounds(self):
        return self.target_pcoord_bounds

    @WEtargetp1_bounds.setter
    def WEtargetp1_bounds(self, bounds):
        self.target_pcoord_bounds = bounds

    def _check_bounds(self, bounds):
        bounds = np.array(bounds, dtype=float)
        if bounds.ndim == 1:
            log.warning("1-D boundaries should be [[lower, upper]]; converting.")
            bounds = bounds.reshape(1, 2)
        if bounds.shape != (self.pcoord_ndim, 2):
            raise ValueError(
                f"Shape of bounds was {bounds.shape}, should've been "
                f"({self.pcoord_ndim}, 2)"
            )
        if not np.all(bounds[:, 0] < bounds[:, 1]):
            raise ValueError("A boundary has a lower bound larger than its upper bound")
        return bounds

    @staticmethod
    def _bin_centers_of_bounds(bounds):
        """Per-dim bin center: mean of finite bounds, else the finite one."""
        centers = np.full(len(bounds), np.nan)
        for i, (lo, hi) in enumerate(bounds):
            if np.isfinite(lo) and np.isfinite(hi):
                centers[i] = 0.5 * (lo + hi)
            else:
                centers[i] = lo if np.isfinite(lo) else hi
        return centers

    def is_WE_basis(self, pcoords):
        """Segments whose pcoords lie inside the basis bounds (open)."""
        from .utils import pcoord_in_bounds

        return pcoord_in_bounds(pcoords, self.basis_pcoord_bounds[: self.pcoord_ndim])

    def is_WE_target(self, pcoords):
        from .utils import pcoord_in_bounds

        return pcoord_in_bounds(pcoords, self.target_pcoord_bounds[: self.pcoord_ndim])

    def _pc_masks(self):
        """Basis/target membership of every segment's parent/child pcoord,
        cached on the current feature arrays; ``overlap_p``/``overlap_c``
        flag rows inside both regions (None when there are none)."""
        feats = self._featurize_all()
        cache = getattr(self, "_pc_masks_cache", None)
        if cache is not None and cache[0] is feats:
            return cache[1]
        masks = dict(
            basis_p=np.asarray(self.is_WE_basis(feats["pcoord0"]), dtype=bool),
            basis_c=np.asarray(self.is_WE_basis(feats["pcoord1"]), dtype=bool),
            target_p=np.asarray(self.is_WE_target(feats["pcoord0"]), dtype=bool),
            target_c=np.asarray(self.is_WE_target(feats["pcoord1"]), dtype=bool),
        )
        for ov, a, b in (("overlap_p", "basis_p", "target_p"),
                         ("overlap_c", "basis_c", "target_c")):
            o = masks[a] & masks[b]
            masks[ov] = o if o.any() else None
        self._pc_masks_cache = (feats, masks)
        return masks

    def set_topology(self, topology):
        """Reference ``set_topology`` (``msm_we.py:1011-1078``): a dict of
        ``coords``/``nAtoms``/``coord_ndim``; a ``.dat`` path (read with
        numpy, no mdtraj); a ``.prmtop`` or any other path, loaded with
        mdtraj (imported here); or an mdtraj object (anything with
        ``_xyz``)."""
        if isinstance(topology, dict):
            self.reference_coord = topology.get("coords")
            self.nAtoms = topology["nAtoms"]
            self.coord_ndim = topology["coord_ndim"]
            return
        if isinstance(topology, str):
            if topology.endswith("dat"):
                self.reference_coord = np.loadtxt(topology)
                self.nAtoms = 1
                self.coord_ndim = 3
                return
            import mdtraj as md

            if topology.endswith("prmtop"):
                struct = md.load_prmtop(topology)
                self.reference_structure = struct
                self.nAtoms = struct.n_atoms
                self.coord_ndim = 3
                return
            struct = md.load(topology)
            self.reference_structure = struct
            self.reference_coord = np.squeeze(struct._xyz)
            self.nAtoms = struct.topology.n_atoms
            self.coord_ndim = 3
            return
        if hasattr(topology, "_xyz"):
            self.reference_structure = topology
            self.reference_coord = np.squeeze(topology._xyz)
            self.nAtoms = topology.topology.n_atoms
            self.coord_ndim = 3
            return
        raise NotImplementedError("Unsupported topology")

    def set_basis(self, basis):
        """The start structure that lagged transitions substitute for
        lineages recycled inside the window: a dict with ``coords``, a
        ``.dat`` path (numpy), another path (mdtraj) or an mdtraj object."""
        if isinstance(basis, dict):
            self.basis_coords = basis["coords"]
            return
        if isinstance(basis, str):
            if basis.endswith("dat"):
                self.basis_coords = np.loadtxt(basis)
                return
            import mdtraj as md

            self.basis_coords = np.squeeze(md.load(basis)._xyz)
            return
        if hasattr(basis, "_xyz"):
            self.basis_coords = np.squeeze(basis._xyz)
            return
        raise NotImplementedError("Unsupported basis")

    @property
    def n_lag(self):
        return self._n_lag

    @n_lag.setter
    def n_lag(self, lag):
        """Any lag >= 0 (the reference gates this to 0, ``msm_we.py:353-359``;
        lag > 0 is the JAX package's extension)."""
        lag = int(lag)
        if lag < 0:
            raise ValueError(f"n_lag must be >= 0, got {lag}")
        if lag > 0:
            log.info(
                f"Using lag n_lag={lag} ({lag + 1} tau transitions); this "
                "extends the reference, which only supports n_lag=0."
            )
        self._n_lag = lag

    # ----------------------------------------------------------------- data
    def get_iterations(self):
        """Populate maxIter / numSegments (reference ``_data.py:934-993``)."""
        self.numSegments = self._dataset.numSegments
        self.maxIter = self._dataset.maxIter

    def load_iter_data(self, n_iter):
        """Expose the reference's per-iteration attributes."""
        d = self._dataset.iter_data(n_iter)
        if self._dataset.pcoord_len is not None:
            # Read from the data, as the reference does (``_data.py:843``)
            self.pcoord_len = self._dataset.pcoord_len
        self.n_iter = n_iter
        self.westList = d["west_idx"]
        self.segindList = d["seg_idx"]
        self.weightList = d["weights"]
        self.nSeg = d["n_segs"]
        self.pcoord0List = d["pcoord0"]
        self.pcoord1List = d["pcoord1"]

    def get_iter_coordinates(self, iteration):
        """Final-frame coordinates of an iteration's segments (NaN dropped)."""
        self.load_iter_data(iteration)
        return self._dataset.iter_child_coords(iteration)

    def load_iter_coordinates(self):
        """Set ``cur_iter_coords`` to the current iteration's final-frame
        coordinates (reference ``_data.py:557-618``); NaN rows preserved."""
        self.cur_iter_coords = self._dataset._iter_frame_block(self.n_iter, -1)

    def load_iter_coordinates0(self):
        """Set ``cur_iter_coords`` to the iteration's *initial* coordinates
        (reference ``_data.py:620-645``)."""
        self.cur_iter_coords = self._dataset._iter_frame_block(self.n_iter, 0)

    def get_iterations_iters(self, first_iter, last_iter):
        """Segment counts over an iteration range (reference
        ``_data.py:995-1040``). Metadata only: the counts come from the scan
        index, with no per-iteration I/O."""
        index = self._dataset._iter_index
        self.numSegments = np.array(
            [
                float(sum(n for _f, n in index[i]))
                for i in range(first_iter, last_iter + 1)
                if i in index
            ]
        )
        self.maxIter = last_iter

    def get_coordinates(self, first_iter, last_iter):
        """Reference ``_data.py:647-675`` (it warns 'not tested or supported')."""
        log.warning("This function is not tested or supported, use at your own risk!")
        self.first_iter = first_iter
        self.last_iter = last_iter
        blocks = []
        for i in range(first_iter, last_iter + 1):
            blocks.append(self._dataset._iter_frame_block(i, -1))
        self.all_coords = np.concatenate(blocks)

    def get_seg_histories(self, n_hist):
        """Walk each current segment's ancestry ``n_hist`` iterations back.

        Populates ``seg_histories`` (segment indices; negative once a walker
        was recycled) and ``weight_histories``, as the reference does by
        re-reading seg_index chains (``_data.py:322-421``).
        """
        if n_hist > self.n_iter:
            log.warning(f"Too much history requested; reducing n_hist to {self.n_iter}")
            n_hist = self.n_iter
        self.n_hist = n_hist

        n_seg = self.nSeg
        seg_histories = np.zeros((n_seg, n_hist + 1), dtype=int)
        weight_histories = np.zeros((n_seg, n_hist))

        # Indices are positions in the *concatenated* per-iteration arrays
        # (globalized parent ids), so multi-file datasets walk correctly.
        # Each history step is one gather over all segments.
        seg_histories[:, 0] = np.arange(n_seg)
        warped = np.zeros(n_seg, dtype=bool)
        for iH in range(1, n_hist + 1):
            iter_back = self.n_iter - iH + 1
            d = self._dataset.iter_data(iter_back)
            cur = seg_histories[:, iH - 1]
            # Recycled: the ancestry ends permanently here (the reference's
            # 'warped' latch, _data.py:392-398); without it the walk would
            # resume from segment 0's data
            warped |= cur < 0
            active = ~warped
            idx = cur[active]
            seg_histories[active, iH] = d["parent_ids_global"][idx]
            weight_histories[active, iH - 1] = d["weights"][idx]
        self.seg_histories = seg_histories[:, :-1].astype(int)
        self.weight_histories = weight_histories

    def get_traj_coordinates(self, from_iter, traj_length):
        """Reconstruct each current walker's continuous coordinate history.

        Walks ``traj_length`` iterations of ancestry back from ``from_iter``
        and collects each ancestor's final-frame coordinates; histories are
        truncated where a walker was recycled (parent id < 0). Populates
        ``self.trajSet`` with one (n_steps, n_atoms, 3) array per current
        segment (reference ``_data.py:761-806``).
        """
        if traj_length > from_iter:
            traj_length = from_iter - 1
            log.warning(f"Trajectory length too long: set to {traj_length}")
        self.load_iter_data(from_iter)
        self.get_seg_histories(traj_length)

        n_seg = self.nSeg
        # seg_histories[:, h] = segment index h iterations back (<0 = recycled)
        coords_by_iter = {}
        for h in range(traj_length):
            it = from_iter - h
            coords_by_iter[it] = self._dataset._iter_frame_block(it, -1)

        traj_set = []
        for iS in range(n_seg):
            frames = []
            for h in range(traj_length - 1, -1, -1):
                idx = self.seg_histories[iS, h] if h < self.seg_histories.shape[1] else -1
                if idx < 0:
                    frames = []  # recycled: history ends here
                    continue
                frames.append(coords_by_iter[from_iter - h][idx])
            traj_set.append(np.array(frames))
        self.trajSet = traj_set
        return traj_set

    def get_transition_data_lag0(self):
        """``coordPairList``/``transitionWeights``/``departureWeights`` of
        the loaded iteration (reference ``_data.py:254-320``)."""
        parent, child, weights = self._dataset.iter_coord_pairs(self.n_iter)
        self.coordPairList = np.stack([parent, child], axis=-1)
        self.transitionWeights = weights.copy()
        self.departureWeights = weights.copy()

    def get_transition_data(self, n_lag):
        """``coordPairList``/``transitionWeights``/``departureWeights`` at
        lag ``n_lag`` for the loaded iteration: starts come from the
        segment's ancestor ``n_lag`` iterations back, lineages recycled in
        the window start from ``basis_coords`` (``set_basis``)."""
        if n_lag == 0:
            self.n_lag = 0
            return self.get_transition_data_lag0()
        tp = self._dataset.iter_transition_pairs(
            self.n_iter, n_lag, basis_coords=self.basis_coords
        )
        self.n_lag = n_lag
        self.coordPairList = np.stack([tp["start"], tp["end"]], axis=-1)
        self.transitionWeights = tp["weights"]
        self.departureWeights = tp["departure_weights"]

    def get_coordSet(self, last_iter, streaming=None, progress_bar=None):
        """Build ``pcoordSet`` (reference ``_data.py:677-759``, streaming)."""
        self.pcoordSet = np.concatenate(
            [self._dataset.iter_data(i)["pcoord1"].copy()
             for i in range(1, last_iter + 1)],
            axis=0,
        )
        self.first_iter = 1
        self.last_iter = last_iter

    # ------------------------------------------------- dimensionality reduce
    DEVICE_MOMENTS_MIN_DIM = 256
    """Feature dimensionality from which the second moments (PCA) and pair
    moments (TICA/VAMP) are f32 products on the device (combined across
    batches in f64)."""

    def dimReduce(self, first_iter=1, first_rough_iter=None, last_iter=None,
                  rough_stride=10, fine_stride=1, variance_cutoff=0.95,
                  use_weights=True, progress_bar=None, device_moments=None):
        """Fit the dimensionality-reduction transform (reference
        ``_dimensionality.py:110-345``). ``pca`` from streamed exact moments
        of the child frames; ``tica``/``vamp`` from (parent, child) pairs,
        WE-weighted for ``tica`` only; ``batch-pca`` from the moments of
        both frames, keeping every component. ``device_moments`` None picks
        the device f32 moments from ``DEVICE_MOMENTS_MIN_DIM`` features."""
        if last_iter is None:
            last_iter = self.maxIter
        method = self.dimReduceMethod
        if method == "none":
            self.ndim = int(self.coord_ndim * self.nAtoms)
            self.coordinates = IdentityCoordinates()
            return

        def moment_dtype(n_features):
            on_device = (n_features >= self.DEVICE_MOMENTS_MIN_DIM
                         if device_moments is None else bool(device_moments))
            return np.float32 if on_device else np.float64

        acc = None
        if method == "pca":
            for i in range(first_iter, last_iter, fine_stride):
                c = self._dataset.iter_child_coords(i)
                if not c.shape[0]:
                    continue
                feats = np.asarray(self.processCoordinates(c))
                if acc is None:
                    acc = MomentAccumulator(feats.shape[1],
                                            dtype=moment_dtype(feats.shape[1]),
                                            device=self.device)
                acc.add(feats)
        else:
            for i in range(first_iter, last_iter, fine_stride):
                parent, child, weights = self._dataset.iter_coord_pairs(i)
                good = np.flatnonzero(~(
                    np.isnan(parent).any(axis=tuple(range(1, parent.ndim)))
                    | np.isnan(child).any(axis=tuple(range(1, child.ndim)))
                ))
                if not len(good):
                    continue
                f0 = np.asarray(self.processCoordinates(parent[good]))
                f1 = np.asarray(self.processCoordinates(child[good]))
                if acc is None:
                    cls = MomentAccumulator if method == "batch-pca" else PairMomentAccumulator
                    acc = cls(f0.shape[1], dtype=moment_dtype(f0.shape[1]),
                              device=self.device)
                if method == "batch-pca":
                    acc.add(f0)
                    acc.add(f1)
                else:
                    acc.add(f0, f1, weights[good] if use_weights and method == "tica"
                            else None)
        if acc is None:
            raise ValueError(
                f"No usable coordinates in iterations [{first_iter}, "
                f"{last_iter}) at stride {fine_stride}; cannot fit the "
                "dimensionality reduction."
            )
        if method in ("tica", "vamp"):
            self.coordinates = acc.finalize(method=method, var_cutoff=variance_cutoff)
            self.ndim = self.coordinates.output_dimension
        else:
            self.coordinates = acc.finalize(
                variance_cutoff=1.0 if method == "batch-pca" else variance_cutoff)
            self.ndim = self.coordinates.n_components

    def reduceCoordinates(self, coords):
        """processCoordinates then the fitted transform."""
        return self.coordinates.transform(self.processCoordinates(coords))

    # ------------------------------------------------------------- features
    FEATURE_CHUNK = 8192
    """Frames per featurization chunk (last chunk zero-padded)."""

    def _featurize_all(self, force=False):
        return featurize_all(self, force=force)

    def _device_row_feats(self, need_parent=True):
        return device_row_feats(self, need_parent=need_parent)

    # ------------------------------------------------------------ clustering
    def cluster_coordinates(self, n_clusters, streaming=False,
                            first_cluster_iter=None, use_ray=False,
                            stratified=True, iters_to_use=None,
                            store_validation_model=False, progress_bar=None,
                            random_state=None, **_cluster_args):
        """Stratified clustering per WE bin, or with ``stratified=False``
        aggregated k-means over all rows (reference
        ``_clustering.py:142-195``). ``store_validation_model`` keeps a deep
        copy of the clustered model as ``post_cluster_model`` for block
        validation."""
        if random_state is not None:
            self._cluster_seed = int(random_state)
        if stratified:
            self.clustering_method = "stratified"
            self.cluster_stratified(
                n_clusters=n_clusters, first_cluster_iter=first_cluster_iter,
                iters_to_use=iters_to_use, **_cluster_args,
            )
        else:
            self.clustering_method = "aggregated"
            self.cluster_aggregated(
                n_clusters=n_clusters, first_cluster_iter=first_cluster_iter,
                iters_to_use=iters_to_use, **_cluster_args,
            )
        if store_validation_model:
            self.post_cluster_model = copy.deepcopy(self)

    def _resolve_iters(self, iters_to_use, first_cluster_iter):
        if iters_to_use is not None and first_cluster_iter is not None:
            log.error(
                "Conflicting parameters -- iters_to_use OR first_cluster_iter, not both."
            )
        if iters_to_use is None:
            first = first_cluster_iter if first_cluster_iter is not None else 1
            iters_to_use = range(first, self.maxIter)
        return list(iters_to_use)

    def cluster_aggregated(self, n_clusters, first_cluster_iter=None,
                           iters_to_use=None, **_cluster_args):
        """Whole-dataset weighted k-means (reference ``cluster_aggregated``,
        ``_clustering.py:197-523``) on the model's device: rows with zero
        weight (bad coordinates) are excluded from training, weights are
        used with ``use_weights_in_clustering``. Drops any stratified bank
        and bin mapper, then discretizes every row."""
        iters_to_use = self._resolve_iters(iters_to_use, first_cluster_iter)
        self.n_clusters = n_clusters
        self.first_cluster_iter = iters_to_use[0]
        feats = self._featurize_all()
        sel = np.isin(feats["iteration"], iters_to_use) & (feats["weights"] > 0)
        w = (feats["weights"][sel] if self.use_weights_in_clustering
             else np.ones(int(sel.sum())))
        centers, _ids, init = kmeans_fit(
            feats["child"][sel], w, n_clusters, seed=self._cluster_seed,
            device=self.device, return_init=True,
        )
        self.clusters = _AggregateClustersShim(centers, device=self.device)
        # The k-means++ rows of the training set: equal on every device
        self.kmeans_init_index = init
        self._strat = None
        self._bin_mapper = None
        self._check_bank_replicated()
        self._discretize_all_aggregated()

    def _discretize_all_aggregated(self):
        """Ids of every parent and child row against the aggregate bank
        (one assignment per row set on the model's device)."""
        feats = self._featurize_all()
        child_idx = self.clusters.predict(feats["child"])
        parent_idx = self.clusters.predict(feats["parent"])
        self._store_dtrajs(parent_idx, child_idx)

    def cluster_stratified(self, n_clusters, streaming=True,
                           first_cluster_iter=None, use_ray=True,
                           bin_iteration=2, iters_to_use=None,
                           user_bin_mapper=None, progress_bar=None,
                           defer_discretization=False,
                           scan_small_batches=False, **_cluster_args):
        """Per-WE-bin stratified clustering (reference ``_clustering.py:525-918``).

        Accumulates iterations until every seen WE bin has >= n_clusters
        segments (basis/target segments excluded), seeds and updates each
        bin's centers, remaps never-filled bins to the nearest filled bin,
        then discretizes every row. ``scan_small_batches=True`` runs every
        non-seeding fill batch through the device scan (the device numerics
        family) instead of host numpy updates for small batches.
        ``defer_discretization=True`` (with ``device_pipeline`` only) skips
        the final discretization: the next ``get_fluxMatrix(0)`` or any
        other dtrajs consumer materializes the ids
        (``_ensure_discretized``), or the device flux route runs without
        them.
        """
        bin_mapper = user_bin_mapper
        if bin_mapper is None:
            bin_mapper = self._load_bin_mapper_from_h5(bin_iteration)
        self._bin_mapper = bin_mapper
        self._raw_bins_cache = None
        iters_to_use = self._resolve_iters(iters_to_use, first_cluster_iter)
        feats = self._featurize_all()
        strat = StratifiedKmeans(
            n_bins=bin_mapper.nbins, k_per_bin=n_clusters,
            n_features=feats["child"].shape[1], seed=self._cluster_seed,
            device=self.device,
        )
        all_filled = set()

        # Training bins come from parent pcoords; basis/target and
        # bad-coordinate (weight 0) segments are excluded
        masks = self._pc_masks()
        keep_all = ~(masks["target_p"] | masks["basis_p"])
        keep_all &= feats["weights"] > 0
        kept_rows_all = np.flatnonzero(keep_all)
        kept_bins_all = self._raw_we_bins()[0][kept_rows_all]

        batches, delegated = _discretization.build_batch_plan(
            bin_mapper, iters_to_use, n_clusters, kept_rows_all, kept_bins_all,
            feats["offsets"],
        )
        _discretization.run_streaming_batches(
            self, strat, feats, batches, delegated, bin_mapper, all_filled,
            iters_to_use, scan_small_batches=scan_small_batches,
        )
        for ub in np.setdiff1d(np.arange(bin_mapper.nbins), sorted(all_filled)):
            remap = find_nearest_bin(bin_mapper, int(ub), sorted(all_filled))
            strat.set_remap(int(ub), remap)
            log.debug(f"Remapped {ub} to {remap}")

        self._strat = strat
        self.clusters = StratifiedClustersShim(bin_mapper, self, strat)
        if self._mesh is not None:
            strat.use_mesh(self._mesh)
            self._check_bank_replicated()
        # The nominal total (reference ``_clustering.py:742``); never-visited
        # clusters are cleaned away in organize_fluxMatrix
        self.n_clusters = n_clusters * bin_mapper.nbins
        if defer_discretization and self.device_pipeline:
            # Clear any earlier clustering's ids: the deferral guards key on
            # ``_parent_idx is None``, and stale ids in the old numbering
            # would be read as current
            self.dtrajs = None
            self.pair_dtrajs = None
            self._parent_idx = None
            self._child_idx = None
            return
        self.launch_discretization()

    def _load_bin_mapper_from_h5(self, bin_iteration):
        """Load a WESTPA bin mapper from the h5 (requires westpa); otherwise
        instruct the user to pass ``user_bin_mapper``."""
        try:
            import westpa.tools.binning  # noqa: F401

            from .data.westh5 import h5py_modules

            with h5py_modules()[0].File(self.fileList[0], "r") as h5:
                mapper, _, _ = westpa.tools.binning.mapper_from_hdf5(
                    h5["bin_topologies"],
                    h5[f"iterations/iter_{bin_iteration:08d}"].attrs["binhash"],
                )
            return mapper
        except Exception as e:
            raise RuntimeError(
                "Could not load a bin mapper from the H5 file (westpa not "
                "installed, in-memory data, or no bin_topologies group). Pass "
                "user_bin_mapper= with a "
                "msm_we_tpu_torch.binning.RectilinearBinMapper."
            ) from e

    # --------------------------------------------------------- discretization
    def launch_discretization(self, progress_bar=None):
        """Discretize every parent and child row on the model's device,
        by the route ``device_pipeline`` picks (aggregated clustering has
        one route)."""
        if self.clustering_method == "aggregated":
            return self._discretize_all_aggregated()
        return _discretization.launch_discretization(self)

    def launch_ray_discretization(self, progress_bar=None):
        """Compat alias: discretization is one batched device call."""
        return self.launch_discretization(progress_bar=progress_bar)

    def _ensure_discretized(self):
        """Materialize the dtrajs if a ``defer_discretization=True``
        clustering (or a deferred cleaning) left them pending; every dtrajs
        consumer calls this."""
        if self._parent_idx is None and self.clusters is not None:
            self.launch_discretization()

    def _invalidate_pcoord_caches(self):
        """Drop the caches derived from the pcoords or the bounds: WE bins,
        basis/target masks, and the device tensors made from them (the flux
        row cache holds the masks, the p1 cache the child pcoords)."""
        self._raw_bins_cache = None
        self._pc_masks_cache = None
        self._device_flux_row_cache = None
        self._device_p1_cache = None

    def _raw_we_bins(self):
        """Un-remapped WE bin of every segment's parent/child pcoord."""
        if getattr(self, "_raw_bins_cache", None) is None:
            feats = self._featurize_all()
            self._raw_bins_cache = (
                self._bin_mapper.assign(np.nan_to_num(feats["pcoord0"])),
                self._bin_mapper.assign(np.nan_to_num(feats["pcoord1"])),
            )
        return self._raw_bins_cache

    def _store_dtrajs(self, parent_idx, child_idx):
        offsets = self._features["offsets"]
        spans = [(offsets[i], offsets[i + 1]) for i in range(len(offsets) - 1)]
        self.dtrajs = [child_idx[a:b] for a, b in spans]
        self.pair_dtrajs = [
            np.stack([parent_idx[a:b], child_idx[a:b]], axis=1) for a, b in spans
        ]
        self._parent_idx = parent_idx
        self._child_idx = child_idx

    # ------------------------------------------------------------ flux matrix
    def get_fluxMatrix(self, n_lag, first_iter=1, last_iter=None,
                       iters_to_use=None, use_ray=False, result_batch_size=5,
                       progress_bar=None):
        """Weighted flux matrix at lag ``n_lag`` (reference
        ``_fluxmatrix.py:166-345``; engine: :func:`fluxmatrix.get_flux_matrix`)."""
        return _fluxmatrix.get_flux_matrix(
            self, n_lag, first_iter=first_iter, last_iter=last_iter,
            iters_to_use=iters_to_use,
        )

    def _device_f64_weights_ok(self, weights):
        """Whether the device accumulates these weights in genuine f64
        (engine: :func:`fluxmatrix.device_f64_weights_ok`; always true)."""
        return _fluxmatrix.device_f64_weights_ok(self, weights)

    def _device_flux_lag0(self, iters_to_use):
        """Fused device flux matrix, one H3 launch (engine:
        :func:`fluxmatrix.device_flux_lag0`)."""
        return _fluxmatrix.device_flux_lag0(self, iters_to_use)

    def get_iter_fluxMatrix(self, n_iter):
        """Single-iteration flux matrix (engine:
        :func:`fluxmatrix.get_iter_flux_matrix`; reference
        ``_fluxmatrix.py:21-72``)."""
        return _fluxmatrix.get_iter_flux_matrix(self, n_iter)

    def organize_fluxMatrix(self, use_ray=False, progress_bar=None,
                            incremental=True, max_passes=10, **args):
        """Clean the flux matrix (reference ``_fluxmatrix.py:347-415``)."""
        if args:
            log.warning(f"organize_fluxMatrix ignoring unknown options {sorted(args)}")
        if self.clustering_method == "aggregated":
            return self.organize_aggregated_simple(
                max_passes=max_passes, incremental=incremental
            )
        return self.organize_stratified(
            max_passes=max_passes, incremental=incremental
        )

    def organize_stratified(self, use_ray=False, progress_bar=None,
                            max_passes=10, incremental=True):
        """Stratified cleaning (engine: :func:`cleaning.organize_stratified`;
        reference ``_clustering.py:920-1142``)."""
        return _cleaning.organize_stratified(
            self, max_passes=max_passes, incremental=incremental
        )

    def organize_aggregated_simple(self, max_passes=10, incremental=True):
        """Aggregate-path cleaning (engine:
        :func:`cleaning.organize_aggregated_simple`)."""
        return _cleaning.organize_aggregated_simple(
            self, max_passes=max_passes, incremental=incremental
        )

    def organize_aggregated(self, use_ray=False, **args):
        """The reference's ``organize_aggregated`` is deprecated and raises
        (``_fluxmatrix.py:452-454``); this delegates to the working
        SCC-based equivalent."""
        return self.organize_aggregated_simple()

    # ------------------------------------------------------- cluster centers
    def get_cluster_centers(self):
        """Mean/min/max child-pcoord per cluster; returns the pcoord-sort
        permutation (reference ``_clustering.py:1528-1599``)."""
        from .structures import get_cluster_centers

        return get_cluster_centers(self)

    def update_sorted_cluster_centers(self):
        """Reference ``_clustering.py:1601-1611``."""
        bin_centers = self.targetRMSD_centers[:, 0].copy()
        bin_centers[self.indTargets] = self.target_bin_centers[0]
        bin_centers[self.indBasis] = self.basis_bin_centers[0]
        self.all_centers = bin_centers
        self.sorted_centers = np.argsort(bin_centers)

    def update_cluster_structures(self, build_pcoord_cache=False):
        """Map each cluster to its member structures, weights and provenance
        (reference ``_clustering.py:1398-1526``)."""
        from .structures import update_cluster_structures

        return update_cluster_structures(self, build_pcoord_cache=build_pcoord_cache)

    # -------------------------------------------------------------- analysis
    def get_Tmatrix(self):
        self.Tmatrix = linalg.tmatrix_from_flux(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins
        )

    def get_steady_state(self, flux_fractional_convergence=1e-4, max_iters=10):
        self.pSS, _flux = linalg.steady_state_refined(
            self.Tmatrix, self.indTargets, self.indBasis, self.nBins,
            self.tau * (self.n_lag + 1),
            flux_fractional_convergence=flux_fractional_convergence,
            max_iters=max_iters,
        )

    def get_steady_state_target_flux(self, pSS=None, _set=True):
        import scipy.sparse as sparse

        from .utils import is_connected

        if not is_connected(sparse.csr_matrix(self.Tmatrix), self.indBasis,
                            self.indTargets, directed=True):
            log.critical(
                "There is no path from the basis to the target, so no MFPT can "
                "be calculated."
            )
            return -1
        if pSS is None:
            pSS = np.squeeze(np.asarray(self.pSS))
        lagtime = self.tau * (self.n_lag + 1)
        J = linalg.target_flux(
            np.asarray(self.Tmatrix), pSS, self.indTargets, self.nBins, lagtime
        )
        if not _set:
            return J
        self.lagtime = lagtime
        self.JtargetSS = J

    def get_eqTmatrix(self):
        """Equilibrium transition matrix: basis/target dropped, then
        row-normalized (reference ``_analysis.py:81-95``)."""
        self.Tmatrix = linalg.equilibrium_tmatrix_from_flux(
            self.fluxMatrix, self.indTargets, self.indBasis
        )

    def get_steady_state_algebraic(self, max_iters=1000, check_negative=True,
                                   set=True):
        pSS = linalg.steady_state_algebraic(
            self.Tmatrix, max_iters=max_iters, check_negative=check_negative
        )
        if not set:
            return pSS
        self.pSS = pSS

    def get_steady_state_matrixpowers(self, conv):
        """Matrix-power steady state (reference ``_analysis.py:284-315``)."""
        max_iters = 10000
        Mt = self.Tmatrix.copy()
        dconv = 1.0e100
        N = 1
        pSS = np.mean(Mt, 0)
        pSSp = np.ones_like(pSS)
        while dconv > conv and N < max_iters:
            Mt = self.Tmatrix @ Mt
            N += 1
            if N % 10 == 0:
                pSS = np.mean(Mt, 0)
                pSS = pSS / pSS.sum()
                dconv = np.abs(pSS - pSSp).sum()
                pSSp = pSS.copy()
                self.pSS = pSS.copy()

    def get_committor(self, conv=1e-5, max_iters=100_000):
        log.info(
            "Note: for steady-state WE data this is a 'pseudocommittor', not a "
            "true committor, as it comes from a one-way ensemble."
        )
        self.q = linalg.committor(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins,
            conv=conv, max_iters=max_iters,
        )

    def get_backwards_committor(self, conv, max_iters=100_000):
        self.qm = linalg.backwards_committor(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins, conv,
            max_iters=max_iters,
        )
        self.q = self.qm.copy()

    def bootstrap_target_flux(self, n_boot=200, seed=0, alpha=0.05,
                              block_size=1, iters_to_use=None,
                              flux_fractional_convergence=1e-4, max_iters=10,
                              observables=("flux",)):
        """Block-bootstrap confidence interval for ``JtargetSS`` over WE
        iterations (engine: :func:`msm_we_tpu_torch.bootstrap.bootstrap_target_flux`)."""
        return _bootstrap.bootstrap_target_flux(
            self, n_boot=n_boot, seed=seed, alpha=alpha,
            block_size=block_size, iters_to_use=iters_to_use,
            flux_fractional_convergence=flux_fractional_convergence,
            max_iters=max_iters, observables=observables,
        )

    def get_flux(self):
        """Net flux profile over pcoord-sorted states and the
        overcorrection check (reference ``_analysis.py:386-466``)."""
        from scipy.stats import linregress

        centers = self.targetRMSD_centers[:, 0].copy()
        centers[self.indBasis] = self.basis_bin_centers[0]
        centers[self.indTargets] = self.target_bin_centers[0]
        order = np.argsort(centers)
        self.J = linalg.net_flux_profile(self.fluxMatrix, order)
        if self.all_centers is None:
            self.update_sorted_cluster_centers()
        slope, intercept, r_value, p_value, std_err = linregress(
            self.all_centers, self.J / self.tau
        )
        self.fit_parameters = {
            "slope": slope, "intercept": intercept, "r_value": r_value,
            "p_value": p_value, "std_err": std_err,
        }
        target_before_basis = bool(
            np.any(self.target_bin_centers < self.basis_bin_centers)
        )
        self.slope_overcorrected = (slope < 0) if target_before_basis else (slope > 0)
        if self.slope_overcorrected:
            log.warning(
                "Flux profile appears to be overcorrected: flux is higher near "
                "the target than the basis. Restarting may have driven the "
                "system past its true steady state; continue this WE run "
                "without restarting and let it relax."
            )

    def get_flux_committor(self):
        """Net flux profile over committor-sorted states (reference
        ``_analysis.py:468-501``)."""
        order = np.argsort(np.squeeze(1.0 - self.q))
        self.Jq = linalg.net_flux_profile(self.fluxMatrix, order) / self.tau

    def evolve_target_flux(self):
        """Target flux of each stored transient distribution
        ``probTransient`` (reference ``_analysis.py:503-525``)."""
        Mss = self.Tmatrix
        probTransient = self.probTransient
        nT = np.shape(probTransient)[0]
        Jtarget = np.zeros(nT)
        self.lagtime = self.tau * (self.n_lag + 1)
        ind_not_targets = np.setdiff1d(range(self.nBins), self.indTargets)
        JtargetTimes = np.zeros(nT)
        for iT in range(nT):
            Jtarget[iT] = float(np.sum(
                probTransient[iT, ind_not_targets][:, None]
                * Mss[np.ix_(ind_not_targets, np.asarray(self.indTargets))]
            ))
            JtargetTimes[iT] = iT * self.nStore * self.lagtime
        self.Jtarget = Jtarget / self.lagtime
        self.JtargetTimes = JtargetTimes

    def get_implied_timescales(self, lags=(0, 1, 2), n_timescales=3,
                               iters_to_use=None, drop_basis_target=True):
        """Implied-timescale lag test over WE lag windows: the raw flux
        matrix at each ``n_lag`` in ``lags`` (physical lag
        ``(n_lag + 1) * tau``), basis/target dropped, the leading
        eigenvalues of the largest connected component as timescales.
        Returns ``(lag_times, timescales)``, also stored as
        ``self.implied_timescales``; the model's flux state is restored."""
        fms, lag_times = self._lagged_flux_matrices(
            lags, iters_to_use, drop_basis_target
        )
        self.implied_timescales = linalg.implied_timescales_from_flux(
            fms, lag_times, n_timescales=n_timescales
        )
        return lag_times, self.implied_timescales

    def _lagged_flux_matrices(self, lags, iters_to_use, drop_basis_target):
        """Raw flux matrices at each ``n_lag`` in ``lags``, with the model's
        flux-matrix state saved and restored around the rebuilds."""
        saved = (
            getattr(self, "fluxMatrixRaw", None),
            self.n_lag,
            getattr(self, "_fluxMatrixParams", None),
            getattr(self, "errorWeight", None),
            getattr(self, "errorCount", None),
        )
        fms, lag_times = [], []
        try:
            for lag in lags:
                self.get_fluxMatrix(int(lag), iters_to_use=iters_to_use)
                fm = np.asarray(self.fluxMatrixRaw)
                if drop_basis_target:
                    n = self.n_clusters
                    fm = fm[:n, :n]
                fms.append(fm)
                lag_times.append((int(lag) + 1) * self.tau)
        finally:
            (self.fluxMatrixRaw, self.n_lag, self._fluxMatrixParams,
             self.errorWeight, self.errorCount) = saved
        return fms, np.asarray(lag_times, dtype=np.float64)

    def get_ck_test(self, lags=(0, 1, 2, 3), sets=None, iters_to_use=None):
        """Chapman-Kolmogorov test over WE lag windows: set-residence
        probabilities of the directly estimated lagged models against the
        ``lags[0]`` model propagated. ``sets=None`` splits by the slowest
        mode's sign; an integer coarse-grains with PCCA+. Returns
        ``(lag_times, sets, predicted, estimated)``, stored as
        ``self.ck_test``."""
        fms, lag_times = self._lagged_flux_matrices(
            lags, iters_to_use, drop_basis_target=True
        )
        if isinstance(sets, bool):
            raise ValueError(
                "sets must be None (slowest-mode split), an integer PCCA+ "
                "set count, or explicit state-index arrays -- not a bool"
            )
        if isinstance(sets, (int, np.integer)):
            sets = linalg.pcca_sets(fms[0], int(sets))
        factors = lag_times / lag_times[0]
        int_factors = np.rint(factors).astype(int)
        if not np.allclose(factors, int_factors):
            raise ValueError(
                f"CK test needs integer lag multiples of the base window; "
                f"got physical lags {lag_times} (base {lag_times[0]})"
            )
        sets, predicted, estimated = linalg.chapman_kolmogorov_from_flux(
            fms, int_factors, sets=sets
        )
        self.ck_test = (lag_times, sets, predicted, estimated)
        return self.ck_test

    # ------------------------------------------------------- block validation
    def do_block_validation(self, cross_validation_groups,
                            cross_validation_blocks, use_ray=False,
                            progress_bar=None):
        """Split the iterations into blocks, deal the blocks round-robin to
        ``cross_validation_groups`` groups, and build one model per group
        from a copy of ``post_cluster_model`` (reference
        ``msm_we.py:884-1009``). Sets ``validation_iterations`` and
        ``validation_models``."""
        if self.post_cluster_model is None:
            raise RuntimeError(
                "Perform clustering with cluster_coordinates("
                "store_validation_model=True) before block validation -- "
                "self.post_cluster_model is not set."
            )
        base = self.post_cluster_model
        validation_models = [
            copy.deepcopy(base) for _ in range(cross_validation_groups)
        ]
        iters_per_block = base.maxIter // cross_validation_blocks
        block_iterations = [
            [start, start + iters_per_block]
            for start in range(1, base.maxIter, iters_per_block)
        ]
        block_iterations[-1][-1] -= 1
        group_blocks = [
            range(start_idx, cross_validation_blocks, cross_validation_groups)
            for start_idx in range(cross_validation_groups)
        ]
        validation_iterations = []
        for group in range(cross_validation_groups):
            group_iterations = []
            for block in group_blocks[group]:
                group_iterations.extend(range(*block_iterations[block]))
            validation_iterations.append(group_iterations)
            try:
                _model = validation_models[group]
                _model.get_fluxMatrix(0, iters_to_use=validation_iterations[group])
                _model.organize_fluxMatrix()
                _model.get_Tmatrix()
                _model.get_steady_state()
                _model.get_steady_state_target_flux()
            except Exception as e:
                log.error("Error during block validation!")
                log.exception(e)
                raise modelWE.BlockValidationError(e) from e
        self.validation_iterations = validation_iterations
        self.validation_models = validation_models

    # ------------------------------------------------------------- pipeline
    def build_analyze_model(self, file_paths, ref_struct, modelName,
                            basis_pcoord_bounds, target_pcoord_bounds,
                            dimreduce_method, tau, n_clusters, ray_kwargs={},
                            max_coord_iter=-1, stratified=True, streaming=True,
                            use_ray=False, fluxmatrix_iters=[1, -1],
                            fluxmatrix_iters_to_use=None,
                            cross_validation_groups=2,
                            cross_validation_blocks=4, show_live_display=True,
                            allow_validation_failure=False, step_kwargs={},
                            progress_bar=None, profile_dir=None,
                            device_pipeline=False, dedup_coordinates="auto"):
        """One-shot build + analysis (reference ``msm_we.py:588-882``).

        ``file_paths`` is a list of west.h5 paths or an
        :class:`ArrayWEDataset`. ``device_pipeline``
        picks the discretization route (pair launches, or the predict route
        over the 2N concatenated rows); both give the same dtrajs.
        ``stratified=False`` clusters with aggregated k-means.
        ``cross_validation_groups > 0`` ends the build with block
        cross-validation over ``cross_validation_blocks`` blocks; a failure
        there raises unless ``allow_validation_failure``. ``profile_dir``
        wraps the whole build in a ``torch.profiler`` trace and writes one
        Chrome trace file there (the profiler is kept as
        ``self.build_profile``). Stage wall-clocks land in
        ``self.stage_timings``; the file handles are closed at the end.
        """
        from .tracing import StageTimer, live_stage_display, profile_trace

        timer = StageTimer()
        self.stage_timings = timer
        self.device_pipeline = bool(device_pipeline)
        if self.device_pipeline and self._mesh is None:
            self.enable_mesh()
        self.build_profile = None
        try:
            with profile_trace(profile_dir) as prof, live_stage_display(
                timer, enabled=show_live_display
            ):
                self._run_build_pipeline(
                    timer, file_paths=file_paths, ref_struct=ref_struct,
                    modelName=modelName, basis_pcoord_bounds=basis_pcoord_bounds,
                    target_pcoord_bounds=target_pcoord_bounds,
                    dimreduce_method=dimreduce_method, tau=tau,
                    n_clusters=n_clusters, streaming=streaming,
                    stratified=stratified, fluxmatrix_iters=fluxmatrix_iters,
                    fluxmatrix_iters_to_use=fluxmatrix_iters_to_use,
                    step_kwargs=step_kwargs, max_coord_iter=max_coord_iter,
                    dedup_coordinates=dedup_coordinates,
                    cross_validation_groups=cross_validation_groups,
                    cross_validation_blocks=cross_validation_blocks,
                    allow_validation_failure=allow_validation_failure,
                )
                if self._mesh is not None and self._mesh.distributed:
                    # Gathering deferred ids is collective: every rank mints
                    # them now, so that one rank alone may read the dtrajs
                    self._ensure_discretized()
            self.build_profile = prof
        finally:
            # Release cached read handles even when a stage raises: WESTPA
            # reopens the same west.h5 read-write after a plugin builds a
            # model, and an in-process 'r' handle makes that reopen fail.
            # Later model reads lazily reopen.
            self.close_files()
        log.info("\n" + timer.report())
        return self

    def _run_build_pipeline(self, timer, *, file_paths, ref_struct, modelName,
                            basis_pcoord_bounds, target_pcoord_bounds,
                            dimreduce_method, tau, n_clusters, streaming,
                            stratified, fluxmatrix_iters, fluxmatrix_iters_to_use,
                            step_kwargs, max_coord_iter, dedup_coordinates,
                            cross_validation_groups, cross_validation_blocks,
                            allow_validation_failure):
        with timer.stage("Model initialization"):
            self.initialize(
                file_paths, ref_struct, modelName,
                basis_pcoord_bounds=basis_pcoord_bounds,
                target_pcoord_bounds=target_pcoord_bounds,
                dim_reduce_method=dimreduce_method, tau=tau,
                **{"dedup_coordinates": dedup_coordinates,
                   **step_kwargs.get("initialize", {})},
            )
        with timer.stage("Loading iterations"):
            self.get_iterations()
            timer.set_note(f"{self.maxIter} iterations")
        coord_iter = self.maxIter if max_coord_iter == -1 else max_coord_iter
        # Read ahead on a daemon thread: per-iteration index data and the
        # frame blocks the featurizer consumes land in the (budget-bounded)
        # caches while the stages below do numpy and device work. The
        # finally stops the reader thread and releases its blocks even when
        # a stage raises. An in-memory dataset has both as no-ops.
        self._dataset.start_prefetch(coord_iter)
        try:
            with timer.stage("Loading coordinates"):
                self.get_coordSet(coord_iter)
            with timer.stage("Dimensionality reduction"):
                self.dimReduce(**step_kwargs.get("dimReduce", {}))
                timer.set_note(f"method={self.dimReduceMethod}, ndim={self.ndim}")
            with timer.stage("Clustering"):
                cluster_kwargs = dict(step_kwargs.get("clustering", {}))
                if (self.device_pipeline and stratified
                        and cross_validation_groups == 0):
                    # The flux stage materializes the ids (or its device
                    # route runs without them). With validation on,
                    # post_cluster_model must snapshot materialized dtrajs,
                    # so that build discretizes here.
                    cluster_kwargs.setdefault("defer_discretization", True)
                self.cluster_coordinates(
                    n_clusters=n_clusters, streaming=streaming,
                    stratified=stratified,
                    store_validation_model=cross_validation_groups > 0,
                    **cluster_kwargs,
                )
        finally:
            self._dataset.drop_block_cache()
        fm_iters = list(fluxmatrix_iters)
        if fm_iters[1] == -1:
            fm_iters[1] = self.maxIter
        with timer.stage("Flux matrix"):
            self.get_fluxMatrix(
                0, first_iter=fm_iters[0], last_iter=fm_iters[1],
                iters_to_use=fluxmatrix_iters_to_use,
                **step_kwargs.get("fluxmatrix", {}),
            )
        original_clusters = self.fluxMatrixRaw.shape[0]
        with timer.stage("Cleaning"):
            self.organize_fluxMatrix(**step_kwargs.get("organize", {}))
            timer.set_note(
                f"{original_clusters} -> {self.fluxMatrix.shape[0]} clusters"
            )
        with timer.stage("Transition matrix"):
            self.get_Tmatrix()
        with timer.stage("Steady-state distribution"):
            self.get_steady_state()
        with timer.stage("Steady-state target flux"):
            self.get_steady_state_target_flux()
            timer.set_note(f"JtargetSS={self.JtargetSS:.2e}")
        if cross_validation_groups > 0:
            with timer.stage("Cross-validation"):
                try:
                    self.do_block_validation(
                        cross_validation_groups=cross_validation_groups,
                        cross_validation_blocks=cross_validation_blocks,
                        **step_kwargs.get("block_validation", {}),
                    )
                except modelWE.BlockValidationError as e:
                    log.error(e)
                    if not allow_validation_failure:
                        raise

    def close_files(self):
        """Close any cached read-only h5 handles (they reopen lazily on the
        next read). Call before another writer opens the same west.h5 files
        in this process -- WESTPA's data manager, augmentation scripts."""
        if self._dataset is not None:
            self._dataset.drop_block_cache()
            self._dataset.close()

    # ---------------------------------------------------------- checkpointing
    _DEVICE_CACHES = ("_dev_feats_cache", "_pc_masks_cache",
                      "_device_flux_row_cache", "_device_p1_cache",
                      "_mesh_feats_cache")

    def _state(self):
        """The instance state without the caches derived from it (device
        copies of the features, basis/target masks, the device flux route's
        row tensors and child pcoords); they are rebuilt on demand."""
        state = self.__dict__.copy()
        for key in self._DEVICE_CACHES:
            state[key] = None
        state["build_profile"] = None  # a profiler belongs to its process
        return state

    def __getstate__(self):
        """Pickle state on the CPU: a model saved from CUDA loads on a
        machine without a GPU (``load`` moves it to a device)."""
        state = self._state()
        state["device"] = torch.device("cpu")
        state["_mesh"] = None  # a mesh belongs to its process: enable it again
        for key in ("coordinates", "clusters"):
            if hasattr(state[key], "device"):
                obj = copy.copy(state[key])
                obj.device = torch.device("cpu")
                state[key] = obj
        return state

    @span("model_copy")
    def __deepcopy__(self, memo):
        """A copy on the same device (``post_cluster_model`` and the
        validation models keep their CUDA bank) and the same live mesh;
        only the caches are dropped."""
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self._state(), memo))
        return new

    def to(self, device):
        """Move the model (its center bank, transform and the models it
        holds for validation) to ``device``; returns ``self``."""
        device = as_device(device)
        if self._mesh is not None and self._mesh.device.type != device.type:
            if self._mesh.distributed:
                raise ValueError(
                    f"the model runs on a mesh of ranks on {self._mesh.device}; "
                    "it cannot move to another device")
            self._mesh = Mesh.single(device)  # the (1, 1) mesh follows the model
            if self._strat is not None:
                self._strat.use_mesh(self._mesh)
        self.device = device
        for key in self._DEVICE_CACHES:
            setattr(self, key, None)
        for obj in (self.coordinates, self.clusters):
            if hasattr(obj, "device"):
                obj.device = device
        if self._strat is not None:
            self._strat.to(device)
        for m in [self.post_cluster_model, *getattr(self, "validation_models", [])]:
            if m is not None:
                m.to(device)
        return self

    def save(self, path):
        """Pickle the full model (the reference's checkpoint format,
        ``restart_driver.py:1139-1143``); tensors are stored on the CPU."""
        import pickle

        with open(path, "wb") as fp:
            pickle.dump(self, fp, protocol=4)
        log.info(f"Model saved to {path}")

    @classmethod
    def load(cls, path, h5_paths=None, device="cuda"):
        """Unpickle a model saved by :meth:`save` onto ``device``; optionally
        re-anchor its west.h5 paths: ``h5_paths`` replaces ``fileList`` and
        re-opens the dataset (the files were moved since the model was
        saved). Unpickle only files this program wrote: unpickling can run
        arbitrary code."""
        import pickle

        with open(path, "rb") as fp:
            model = pickle.load(fp)
        if h5_paths is not None:
            model.fileList = list(h5_paths)
            model.n_data_files = len(model.fileList)
            model._dataset = WEDataset(
                model.fileList,
                pcoord_ndim=model.pcoord_ndim,
                auxpath=model.auxpath,
            )
            model._features = None  # cached features refer to the old files
            model._raw_bins_cache = None
        return model.to(device)

    # -------------------------------------------------------------- plotting
    def plot_flux(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux(self, *args, **kwargs)

    def plot_flux_committor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux_committor(self, *args, **kwargs)

    def plot_flux_committor_pcoordcolor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux_committor_pcoordcolor(self, *args, **kwargs)

    def plot_committor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_committor(self, *args, **kwargs)

    def get_coarse_flux_profile(self, *args, **kwargs):
        from . import plotting

        return plotting.get_coarse_flux_profile(self, *args, **kwargs)

    def plot_coarse_flux_profile(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_coarse_flux_profile(self, *args, **kwargs)

    def draw_basis_target_boundaries(self, ax, pcoord_to_use=0):
        from . import plotting

        return plotting.draw_basis_target_boundaries(self, ax, pcoord_to_use)

    def plot_implied_timescales(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_implied_timescales(self, *args, **kwargs)

    def plot_ck_test(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_ck_test(self, *args, **kwargs)

    def check_display_overcorrection_warning(self, ax):
        from . import plotting

        return plotting._check_display_overcorrection_warning(self, ax)

    @staticmethod
    def print_pseudocommittor_warning():
        log.info(
            "Note: for steady-state WE data this is a 'pseudocommittor', not "
            "a true committor, as it comes from a one-way ensemble."
        )

    # ---------------------------------------------- reference-API compat shims
    @staticmethod
    def find_nearest_bin(bin_mapper, bin_idx, filled_bins):
        """Reference ``_clustering.py:1331-1396``; delegates to binning."""
        return find_nearest_bin(bin_mapper, bin_idx, filled_bins)

    @staticmethod
    def check_connect_ray():
        """No-op: the reference's Ray fan-out is one batched call on the
        model's device here."""
        log.debug("Ray not required: the work runs as batched calls on one device.")

    def progress_disable(self):
        pass

    def progress_enable(self):
        pass

    def collect_iter_coordinates(self, **kwargs):
        """Augment the model's west.h5 files with segment coordinates
        through :func:`msm_we_tpu_torch.scripts.augment_west_h5` (mdtraj and
        h5py, imported there). The topology defaults to the model's
        ``refPDBfile`` (``topology_path=`` overrides it); ``seg_dir_format``,
        ``parent_filename``, ``child_filename``, ``auxpath`` (default the
        model's) and ``overwrite`` pass through. Every complete iteration
        is augmented. Returns the total number of iterations augmented
        across files."""
        import os

        from .scripts.collect_coordinates import augment_west_h5

        log.warning(
            "collect_iter_coordinates assumes a WESTPA traj_segs/ directory "
            "layout -- be sure it matches your simulation output "
            "(reference `_data.py:441-444`)."
        )
        topology = kwargs.pop("topology_path", getattr(self, "refPDBfile", None))
        if isinstance(topology, os.PathLike):
            topology = os.fspath(topology)
        if not isinstance(topology, str):
            raise ValueError(
                "collect_iter_coordinates needs a topology file path; the "
                "model was initialized with a non-path topology. Pass "
                "topology_path=..."
            )
        kwargs.setdefault("auxpath", self.auxpath)
        if self._dataset is not None:
            # Release cached read handles before the append opens
            self._dataset.close()
        return sum(augment_west_h5(west_file, topology, **kwargs)
                   for west_file in self.fileList)

    def enable_mesh(self, mesh=None):
        """Run the device routes over a ('data', 'model') mesh of ranks.

        With no argument, ``parallel.make_mesh(device=self.device)``: over
        the ranks of the initialized default process group (launch the
        build script with ``torchrun --nproc_per_node=N``; every rank runs
        it on the same inputs), else the (1, 1) mesh, on which every route
        is the one-device route. Segments split over 'data', the compact
        center bank over 'model'; ids are bitwise the one-device ids and
        every rank ends with the same model. Call before or after
        clustering: the mesh attaches to the stratified bank, and with a
        process group the ranks' banks are checked equal. Returns the
        mesh."""
        self._mesh = mesh if mesh is not None else make_mesh(device=self.device)
        for key in self._DEVICE_CACHES:  # device tensors are mesh-specific
            if key != "_pc_masks_cache":
                setattr(self, key, None)
        if self._strat is not None:
            self._strat.use_mesh(self._mesh)
        if self.clusters is not None:
            self._check_bank_replicated()
        return self._mesh

    def _active_mesh(self):
        """The mesh the device routes run over: ``enable_mesh``'s, else the
        (1, 1) mesh on the model's device."""
        return self._mesh if self._mesh is not None else Mesh.single(self.device)

    def _check_bank_replicated(self):
        """Raise unless every rank of the mesh holds the same center bank
        (clustering is not sharded: each rank fits the whole bank, and the
        fits are bitwise reproducible). A no-op without a process group."""
        mesh = self._mesh
        if mesh is None or not mesh.distributed:
            return
        if self._strat is not None:
            strat = self._strat
            digest = bank_digest(
                *(t.cpu().numpy() for t in strat.compact_bank_device()),
                strat.we_remap, strat.valid)
        else:
            digest = bank_digest(np.asarray(self.clusters.cluster_centers_))
        mesh.check_same(digest, "center banks after the fit")

    # Manual live-table helpers (reference msm_we.py:529-586). The display
    # of build_analyze_model is driven by StageTimer; these statics keep the
    # reference's hand-driven table API for users who compose their own
    # pipelines.
    _TABLE_STEPS = (
        "Ray initialization",
        "Model initialization",
        "Loading iterations",
        "Loading coordinates",
        "Computing dimensionality reduction",
        "Clustering",
        "Flux matrix",
        "Cleaning",
        "Transition matrix",
        "Steady-state distribution",
        "Steady-state target flux",
        "Cross-validation",
    )

    @staticmethod
    def new_table():
        """A rich progress table with one row per pipeline step (reference
        ``msm_we.py:561-586``)."""
        from rich.table import Table

        table = Table(title="haMSM Progress")
        for column in ("Status", "Step", "Notes"):
            table.add_column(column)
        for step in modelWE._TABLE_STEPS:
            table.add_row(" [ ]", step, "")
        return table

    @staticmethod
    def set_note(table, row, text):
        """Set the Notes cell of a step row (reference ``msm_we.py:558-560``)."""
        table.columns[2]._cells[row] = text

    @staticmethod
    def do_step(table, row, step, args=(), kwargs=None, in_subprocess=False):
        """Run one pipeline step, updating its table row to running, done
        or failed (reference ``msm_we.py:529-556``). ``in_subprocess`` is
        accepted for API parity and ignored."""
        del in_subprocess
        step_text = table.columns[1]._cells[row]
        status, name = table.columns[0], table.columns[1]
        status._cells[row] = "[bold black][ [bold yellow]* [bold black]]"
        name._cells[row] = f"[bold black]{step_text}"
        try:
            result = step(*args, **(kwargs or {}))
        except Exception as e:
            status._cells[row] = "[bold black] [[bold red]x[bold black]]"
            name._cells[row] = f"[black]{step_text}"
            table.columns[2]._cells[row] = f"{getattr(e, 'message', repr(e))}"
            raise
        status._cells[row] = "[bold black] [[bold green]\u2713[bold black]]"
        name._cells[row] = f"[black]{step_text}"
        return result


# The reference defines BlockValidationError at module scope
# (msm_we.py:60-61); keep both import paths
BlockValidationError = modelWE.BlockValidationError
