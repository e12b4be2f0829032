"""Host-side WESTPA ``west.h5`` ingest.

Counterpart of ``msm_we_tpu/data/westh5.py::WEDataset``, with the members of
:class:`~msm_we_tpu_torch.data.ArrayWEDataset` plus the file machinery:
multi-file datasets, per-iteration ``seg_index`` (weights, parent ids),
``pcoord``, and augmented coordinates under ``auxdata/<auxpath>``; parent and
child coordinate pairs from frames 0 and -1 (reference
``get_transition_data_lag0``, ``_data.py:254-320``); NaN coordinates zero the
segment's transition weight (``_data.py:303-313``). An iteration is usable
only when the *next* iteration also exists in the same file (the last
iteration is incomplete, ``_data.py:859-866``).

The reader scans once, caches per-iteration index data (tiny), and streams
coordinate blocks on demand. A block cache and a prefetch thread overlap the
file reads with the build's numpy and device work.

h5py is imported by :func:`h5py_modules` when a file is first touched, never
when this module is imported: the package loads on machines without h5py.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np

from .._logging import log
from .common import WEDataAccess

__all__ = ["WEDataset", "h5py_modules"]

def h5py_modules():
    """``(h5py, h5o, h5s)``, imported here and not with this module. Raises
    an ``ImportError`` that names h5py when it is not installed."""
    try:
        import h5py
        from h5py import h5o, h5s
    except ImportError as e:
        raise ImportError(
            "reading or writing a west.h5 file needs h5py, which is not "
            "installed; install h5py, or pass the data in memory as an "
            "msm_we_tpu_torch.data.ArrayWEDataset"
        ) from e
    return h5py, h5o, h5s


def _iter_name(n):
    return f"iterations/iter_{int(n):08d}"


def _ll_read_full(did, dtype, shape=None):
    """Full-extent dataset read through h5py's low-level API.

    ``Dataset.__getitem__`` spends most of its time in Python-layer machinery
    (path and selection objects, compound-dtype reconstruction);
    ``DatasetID.read`` with the dtype memoized skips it. h5py's internal lock
    still serializes the actual HDF5 call, so this stays safe under the
    prefetch thread."""
    h5s = h5py_modules()[2]
    out = np.empty(did.shape if shape is None else shape, dtype=dtype)
    if out.size:
        did.read(h5s.ALL, h5s.ALL, out)
    return out


# Continuity verdicts memoized across WEDataset instances, keyed by file
# identity (realpath, inode, mtime_ns, size) + check parameters: restart
# marathons and repeated analyses rebuild models over unchanged files, and the
# sampled continuity check is pure re-verification there.
_continuity_memo = {}


class WEDataset(WEDataAccess):
    """Immutable view over one or more west.h5 files.

    Parameters
    ----------
    file_list: list of paths to west.h5 files (segments of an iteration may be
        spread over several files; reference ``_data.py:271-277``).
    pcoord_ndim: number of progress-coordinate dimensions to load (extra dims
        in the file are ignored, matching ``_data.py:878-889``).
    auxpath: name of the augmented-coordinate dataset under ``auxdata/``.
    """

    def __init__(self, file_list, pcoord_ndim=1, auxpath="coord"):
        if isinstance(file_list, str):
            file_list = file_list.split(" ")
        self.file_list = list(file_list)
        self.pcoord_ndim = int(pcoord_ndim)
        self.auxpath = auxpath

        self._iter_index = {}  # n_iter -> list of (file_idx, n_segs)
        self._scan()

        # Per-iteration caches populated lazily
        self._iter_data = {}
        self._pcoord_shape_warned = False
        # Number of pcoord frames per segment, read from the file on the
        # first pcoord load (reference ``_data.py:843``); None until then.
        self.pcoord_len = None
        # Read-only h5py handles, opened lazily and kept open: a build reads
        # the same file hundreds of times
        self._open_handles = {}
        self._coord_shape = None
        self._coord_itemsize = None
        # h5py Dataset objects for auxdata/<auxpath>, keyed (file_idx,
        # n_iter), and the numpy dtype each was opened with
        self._dset_cache = {}
        self._aux_dtype_memo = {}
        # (seg_index, pcoord) numpy dtypes, one pair a file
        self._index_dtype_memo = {}
        # Optional whole-block read cache (enable_block_cache); None = off
        self._block_cache = None
        self._block_budget = 0
        self._block_used = 0
        # Prefetch machinery (start_prefetch): a daemon reader thread fills
        # the iter_data/block caches ahead of the consumer. h5py serializes
        # actual HDF5 calls internally; this lock only guards OUR dict
        # caches and lazy handle creation (RLock: _read_frame_block ->
        # iter_data nests)
        self._io_lock = threading.RLock()
        self._prefetch_thread = None
        self._prefetch_stop = None
        self._block_consumed = set()
        self._block_shared = set()

    def _h5(self, file_idx):
        """Persistent read-only handle for ``file_list[file_idx]``.

        Tradeoff: a cached handle holds the HDF5 shared read lock for the
        dataset's lifetime, so a WRITER -- another process's ``w_run`` or an
        augmentation script -- cannot open the same west.h5 read-write
        until :meth:`close` runs (``modelWE.close_files``). Opening with
        ``locking=False`` instead conflicts with every default-locking open
        of the same file in this process, which is worse.
        """
        with self._io_lock:
            h5 = self._open_handles.get(file_idx)
            if h5 is None or not h5.id.valid:
                h5 = h5py_modules()[0].File(self.file_list[file_idx], "r")
                self._open_handles[file_idx] = h5
            return h5

    def close(self):
        """Close any cached file handles (call before re-writing the files,
        e.g. augmentation scripts opening them in append mode). The next
        read reopens them."""
        self.stop_prefetch()
        with self._io_lock:
            self._dset_cache = {}
            for h5 in self._open_handles.values():
                try:
                    h5.close()
                except Exception:
                    pass
            self._open_handles = {}

    def enable_block_cache(self, budget_bytes=None):
        """Cache whole-iteration frame blocks read by :meth:`_iter_frame_block`
        so back-to-back passes over the same frames (dimReduce's moment pass
        followed by featurization) hit memory instead of re-reading HDF5.

        Plain hits return a shared read-only view of the cached array; a
        consumer that will mutate the block in place (the featurizer's
        ``nan_to_num(copy=False)``) must pass ``consume=True`` to
        :meth:`_iter_frame_block`, which pops the entry (ownership
        transfer) so no other holder aliases it. Consumed pops are what
        bound peak memory to one pipeline's worth of blocks. Reads stop
        being cached once ``budget_bytes`` (default 512 MB, env
        ``MSM_WE_TPU_BLOCK_CACHE_MB``) is reached -- large datasets simply
        keep the streaming behavior.
        """
        if budget_bytes is None:
            budget_bytes = (
                int(os.environ.get("MSM_WE_TPU_BLOCK_CACHE_MB", 512)) << 20
            )
        with self._io_lock:
            self._block_cache = {}
            self._block_budget = int(budget_bytes)
            self._block_used = 0
            self._block_consumed = set()
            self._block_shared = set()

    def drop_block_cache(self):
        self.stop_prefetch()
        with self._io_lock:
            self._block_cache = None
            self._block_used = 0
            self._block_consumed = set()
            self._block_shared = set()

    def start_prefetch(self, last_iter, frames=(-1,)):
        """Read ahead on a daemon thread: per-iteration index data
        (:meth:`iter_data`) for iterations ``1..last_iter`` plus the frame
        blocks the dedup featurizer consumes (``1..last_iter-1``), landing
        in the (budget-bounded) caches before the pipeline asks for them.

        h5py serializes HDF5 calls through its own global lock, so the
        reads interleave safely with the consumer thread's; the win is that
        they overlap the consumer's *numpy/device* work (featurization,
        moment accumulation, fill dispatches) instead of serializing whole
        build stages behind hundreds of small h5py calls. When the block
        budget fills, the reader idles until the consumer pops entries
        (``consume=True`` hand-over), bounding memory; blocks the consumer
        already took are never re-read. No-op if a prefetch is running."""
        if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
            return
        if self._block_cache is None:
            self.enable_block_cache()
        stop = threading.Event()

        def run():
            try:
                # Phase 1: per-iteration index data only. get_coordSet (the
                # pipeline's first consumer) reads exactly this, in this
                # order -- interleaving the (much larger) block reads here
                # would make that stage wait behind reads it doesn't need
                # yet (h5py's global lock serializes the two threads).
                for i in range(1, last_iter + 1):
                    if stop.is_set():
                        return
                    self.iter_data(i)
                # Phase 2: frame blocks for the featurizer passes.
                for i in range(1, last_iter):
                    if stop.is_set():
                        return
                    for f in frames:
                        key = (i, f)
                        with self._io_lock:
                            cache = self._block_cache
                            if (
                                cache is None
                                or key in cache
                                or key in self._block_consumed
                            ):
                                continue
                        # Backpressure: wait for a consumer pop instead of
                        # reading into a full cache (the read would be
                        # discarded and re-done by the consumer anyway)
                        est = self._block_nbytes_estimate()
                        if est > self._block_budget:
                            # A block that can never fit (even into an empty
                            # cache) must not stall the loop: skip caching it
                            # and keep going -- the consumer streams such
                            # blocks itself, as without a cache
                            continue
                        skip = False
                        while not stop.is_set():
                            with self._io_lock:
                                if self._block_cache is None:
                                    return
                                # Re-check the key while waiting: the
                                # consumer may have read it directly (or
                                # consumed it) in the meantime -- keep
                                # moving rather than spinning on a block
                                # nobody needs anymore
                                if (
                                    key in self._block_cache
                                    or key in self._block_consumed
                                ):
                                    skip = True
                                    break
                                if self._block_used + est <= self._block_budget:
                                    break
                            time.sleep(0.002)
                        if skip:
                            continue
                        if stop.is_set():
                            return
                        block = self._read_frame_block(i, f)
                        with self._io_lock:
                            cache = self._block_cache
                            if (
                                cache is not None
                                and key not in cache
                                and key not in self._block_consumed
                                and self._block_used + block.nbytes
                                <= self._block_budget
                            ):
                                cache[key] = block
                                self._block_used += block.nbytes
            except Exception as e:  # reader failures surface at consume time
                log.debug(f"prefetch thread stopped early: {e}")

        self._prefetch_stop = stop
        self._prefetch_thread = threading.Thread(
            target=run, name="westh5-prefetch", daemon=True
        )
        self._prefetch_thread.start()

    def stop_prefetch(self):
        t, stop = self._prefetch_thread, self._prefetch_stop
        if stop is not None:
            stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=10)
        self._prefetch_thread = None
        self._prefetch_stop = None

    def _block_nbytes_estimate(self):
        """Upper-bound size of one frame block (for prefetch backpressure),
        from the auxdata dataset's real itemsize (memoized): assuming 8
        bytes an element would double the estimate for f32 coordinates and
        make the prefetcher refuse blocks that fit the budget."""
        n_atoms, coord_ndim = self.n_atoms_coord_ndim()
        if self._coord_itemsize is None:
            first = next(iter(self._iter_index))
            file_idx, _ = self._iter_index[first][0]
            self._aux_dset(file_idx, first)  # records the itemsize
        return (int(self.max_segs) * int(n_atoms) * int(coord_ndim)
                * self._coord_itemsize)

    def _index_dtypes(self, file_idx, si_id, pc_id):
        """Memoized (seg_index, pcoord) numpy dtypes for one file.

        Reconstructing a compound dtype from HDF5 type metadata is slow
        next to the read itself; one WESTPA run writes every iteration with
        the same dtypes, so resolve them once per file."""
        pair = self._index_dtype_memo.get(file_idx)
        if pair is None:
            h5py = h5py_modules()[0]
            pair = (h5py.Dataset(si_id).dtype, h5py.Dataset(pc_id).dtype)
            self._index_dtype_memo[file_idx] = pair
        return pair

    def _aux_full(self, file_idx, n_iter):
        """Full-extent read of one iteration's ``auxdata/<auxpath>`` block
        through the low-level API.

        The read dtype is the one resolved for THIS (file, iteration) at
        ``_aux_dset`` cache-insert time -- a per-file memo would silently
        down-convert later iterations written with a wider dtype (f64 after
        f32, the mixed-dtype case ``_read_frame_block``'s multi-file path
        explicitly promotes for)."""
        dset = self._aux_dset(file_idx, n_iter)
        return _ll_read_full(dset.id, self._aux_dtype_memo[(file_idx, n_iter)])

    def _aux_dset(self, file_idx, n_iter):
        """Cached ``auxdata/<auxpath>`` Dataset for one (file, iteration).
        The numpy dtype is resolved once here, at insert time, keyed by the
        same (file, iteration) pair so mixed-dtype files stay exact."""
        key = (file_idx, n_iter)
        with self._io_lock:
            dset = self._dset_cache.get(key)
            if dset is None or not dset.id.valid:
                dset = self._h5(file_idx)[
                    f"{_iter_name(n_iter)}/auxdata/{self.auxpath}"
                ]
                assert dset.shape[1] > 1, (
                    "Augmented coords need at least start & end frames"
                )
                self._dset_cache[key] = dset
                self._aux_dtype_memo[key] = dset.dtype
                if self._coord_itemsize is None:
                    self._coord_itemsize = int(dset.dtype.itemsize)
            return dset

    def __getstate__(self):
        """Pickle and deepcopy state: file handles, locks, threads and raw
        coordinate blocks are process-local and never copied, so a model
        copy (``post_cluster_model``, the validation models) opens its own
        handles on its first read and starts no thread."""
        state = self.__dict__.copy()
        state["_open_handles"] = {}
        state["_dset_cache"] = {}
        state["_block_cache"] = None
        state["_block_used"] = 0
        state["_block_consumed"] = set()
        state["_block_shared"] = set()
        state["_io_lock"] = None
        state["_prefetch_thread"] = None
        state["_prefetch_stop"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._io_lock = threading.RLock()

    # ------------------------------------------------------------------ scan
    def _scan(self):
        """Find every usable iteration and its segment counts per file.

        Opens each file exactly once and enumerates its iteration groups
        (the reference re-opens every file for every iteration,
        ``_data.py:955-989``).
        """
        h5py = h5py_modules()[0]
        # Per file: {n_iter: n_segs} for iterations whose successor also
        # exists in the same file (the last iteration is incomplete)
        per_file_counts = []
        for path in self.file_list:
            with h5py.File(path, "r") as h5:
                counts = {}
                if "iterations" in h5:
                    present = {}
                    for key in h5["iterations"]:
                        grp = h5["iterations"][key]
                        if "seg_index" in grp:
                            present[int(key.split("_")[1])] = grp["seg_index"].shape[0]
                    for n, count in present.items():
                        if n + 1 in present:
                            counts[n] = count
                per_file_counts.append(counts)

        num_segments = []
        n_iter = 1
        while True:
            per_file = [
                (file_idx, counts[n_iter])
                for file_idx, counts in enumerate(per_file_counts)
                if n_iter in counts
            ]
            total = sum(n for _idx, n in per_file)
            if total == 0:
                break
            self._iter_index[n_iter] = per_file
            num_segments.append(total)
            n_iter += 1

        self.numSegments = np.array(num_segments, dtype=float)
        self.maxIter = len(num_segments)
        if self.maxIter == 0:
            log.warning(f"No usable iterations found in {self.file_list}")
        self.max_segs = int(self.numSegments.max()) if self.maxIter else 0

    # ------------------------------------------------------- per-iteration IO
    def iter_data(self, n_iter):
        """Index data for one iteration (cached; no coordinates).

        Returns a dict with ``weights``, ``parent_ids``, ``pcoord0``,
        ``pcoord1`` (clipped to pcoord_ndim), ``west_idx``, ``seg_idx``,
        ``n_segs``, ``parent_ids_global``.
        """
        if n_iter in self._iter_data:
            return self._iter_data[n_iter]
        if n_iter not in self._iter_index:
            raise KeyError(f"Iteration {n_iter} not present/usable")
        with self._io_lock:
            return self._iter_data_uncached(n_iter)

    def _iter_data_uncached(self, n_iter):
        # Re-check under the lock: the prefetch thread may have landed it
        # between the lock-free fast path above and acquisition
        if n_iter in self._iter_data:
            return self._iter_data[n_iter]
        h5o = h5py_modules()[1]
        weights, parents, p0, p1, west_idx, seg_idx = [], [], [], [], [], []
        for file_idx, _n in self._iter_index[n_iter]:
            h5 = self._h5(file_idx)
            gid = h5o.open(h5.id, _iter_name(n_iter).encode())
            si_id = h5o.open(gid, b"seg_index")
            pc_id = h5o.open(gid, b"pcoord")
            si_dtype, pc_dtype = self._index_dtypes(file_idx, si_id, pc_id)
            seg_index = _ll_read_full(si_id, si_dtype)
            pcoord = _ll_read_full(pc_id, pc_dtype)
            n = len(seg_index)
            weights.append(seg_index["weight"])
            try:
                parents.append(seg_index["parent_id"])
            except (KeyError, ValueError):
                # Positional field 1, as the reference indexes it
                parents.append(np.array([row[1] for row in seg_index]))
            if pcoord.shape[2] < self.pcoord_ndim:
                raise ValueError(
                    f"pcoord in {self.file_list[file_idx]} has only "
                    f"{pcoord.shape[2]} dims but pcoord_ndim="
                    f"{self.pcoord_ndim} was requested"
                )
            if pcoord.shape[2] > self.pcoord_ndim and not self._pcoord_shape_warned:
                # Expected when pcoords were extended by the optimization
                # flow; warn once (reference ``_data.py:878-889``)
                log.warning(
                    f"pcoord in {self.file_list[file_idx]} has "
                    f"{pcoord.shape[2]} dims; loading only the first "
                    f"{self.pcoord_ndim}. This is expected if you're "
                    "extending your pcoord (e.g. in an optimization flow)."
                )
                self._pcoord_shape_warned = True
            self.pcoord_len = int(pcoord.shape[1])
            p0.append(pcoord[:, 0, : self.pcoord_ndim])
            p1.append(pcoord[:, -1, : self.pcoord_ndim])
            west_idx.append(np.full(n, file_idx, dtype=int))
            seg_idx.append(np.arange(n))

        data = dict(
            weights=np.concatenate(weights),
            parent_ids=np.concatenate(parents),
            pcoord0=np.concatenate(p0),
            pcoord1=np.concatenate(p1),
            west_idx=np.concatenate(west_idx),
            seg_idx=np.concatenate(seg_idx),
        )
        data["n_segs"] = len(data["weights"])

        # Parent ids in seg_index are local to each file's previous
        # iteration; offset them into the *concatenated* previous-iteration
        # ordering so ancestry walks work on multi-file datasets (the
        # reference instead re-matches (segind, westfile) pairs,
        # ``_data.py:785-795``). Negative ids (recycled) stay negative.
        prev = self._iter_index.get(n_iter - 1, [])
        offsets_prev = {}
        running = 0
        for f_idx, n in prev:
            offsets_prev[f_idx] = running
            running += n
        global_parents = data["parent_ids"].copy()
        for f_idx in np.unique(data["west_idx"]):
            rows = data["west_idx"] == f_idx
            pos = rows & (global_parents >= 0)
            if pos.any() and n_iter > 1 and int(f_idx) not in offsets_prev:
                raise ValueError(
                    f"{self.file_list[int(f_idx)]} has segments in iteration "
                    f"{n_iter} with parents, but no usable iteration "
                    f"{n_iter - 1} -- cannot globalize its parent ids "
                    "(truncated or mid-run file?)"
                )
            global_parents[pos] += offsets_prev.get(int(f_idx), 0)
        data["parent_ids_global"] = global_parents

        self._iter_data[n_iter] = data
        return data

    def iter_coord_pairs(self, n_iter):
        """(parent_coords, child_coords, weights) for one iteration.

        Coordinates are frames 0 and -1 of ``auxdata/<auxpath>``; segments with
        NaN coordinates keep their (NaN) coords but get weight 0, the
        reference's convention for bad augmentation data
        (``_data.py:303-313``).
        """
        data = self.iter_data(n_iter)
        n = data["n_segs"]
        per_file = self._iter_index[n_iter]
        if len(per_file) == 1:
            # Single-file iteration (the common case): the h5 reads ARE the
            # concatenated blocks -- no NaN-filled f64 staging copy, which
            # would upcast f32 coords to f64 and double every downstream
            # featurization pass (same fast path as _iter_frame_block)
            dset = self._aux_dset(per_file[0][0], n_iter)
            if dset.shape[1] <= 4 and dset.nbytes <= 256 << 20:
                # One contiguous read serves both endpoint frames
                full = self._aux_full(per_file[0][0], n_iter)
                parent = np.ascontiguousarray(full[:, 0])
                child = np.ascontiguousarray(full[:, -1])
            else:
                parent = dset[:, 0]
                child = dset[:, -1]
            if len(parent) != n:
                raise ValueError(
                    f"iteration {n_iter}: auxdata has {len(parent)} segments "
                    f"but seg_index has {n} (truncated augmentation write?)"
                )
        else:
            # Multi-file: stage into arrays whose dtype promotes over ALL
            # blocks (mixed f32/f64 augmentation versions)
            blocks = [
                (file_idx, self._aux_dset(file_idx, n_iter))
                for file_idx, _n in per_file
            ]
            dtype = np.result_type(np.float32, *(d.dtype for _, d in blocks))
            shape = (n,) + blocks[0][1].shape[2:]
            parent = np.full(shape, np.nan, dtype=dtype)
            child = np.full(shape, np.nan, dtype=dtype)
            for file_idx, dset in blocks:
                mask = data["west_idx"] == file_idx
                parent[mask] = dset[:, 0]
                child[mask] = dset[:, -1]

        weights = data["weights"].copy()
        flat_axes = tuple(range(1, parent.ndim))
        bad = np.isnan(parent).any(axis=flat_axes) | np.isnan(child).any(axis=flat_axes)
        if bad.any():
            log.warning(
                f"Bad coordinates for segments {np.flatnonzero(bad)} in iteration "
                f"{n_iter}, setting weights to 0"
            )
            weights[bad] = 0.0
        return parent, child, weights

    def _iter_frame_block(self, n_iter, frame, consume=False, transient=False):
        """One frame's coordinates for every segment of an iteration (NaN
        kept), reading only that frame from ``auxdata`` -- half the I/O of
        :meth:`iter_coord_pairs` when only one endpoint is needed.

        With :meth:`enable_block_cache` active, a block read once is kept
        (within budget) for later readers of the same (iteration, frame).
        Cached blocks are shared read-only views of the same array; a caller
        that will mutate the block in place must pass ``consume=True``, which
        takes the entry out of the cache (ownership transfer) -- and never
        stores its own read.

        ``transient=True`` is for callers that only *gather-copy* from the
        block (``iter_frame_subset``, continuity checks): a miss is read
        WITHOUT storing (continuity touches frame 0 of every usable
        iteration; caching those would fill the budget with blocks the
        featurizer never consumes, starving phase-2 prefetch), and a hit is
        returned WITHOUT the ``_block_shared`` mark (fancy indexing copies,
        so a later ``consume=True`` owner may still mutate the original).
        """
        key = (n_iter, frame)
        with self._io_lock:
            cache = self._block_cache
            if cache is not None and key in cache:
                if consume:
                    block = cache.pop(key)
                    self._block_used -= block.nbytes
                    self._block_consumed.add(key)
                    if key in self._block_shared:
                        # An earlier plain hit handed out a view of this
                        # array; the consumer is about to mutate it in
                        # place, so it must get its own copy
                        block = block.copy()
                else:
                    block = cache[key]
                    if not transient:
                        self._block_shared.add(key)
                return block
            if consume and cache is not None:
                # Mark before reading: the prefetch thread must not re-read
                # a block the consumer is already fetching for itself
                self._block_consumed.add(key)
        block = self._read_frame_block(n_iter, frame)
        with self._io_lock:
            cache = self._block_cache
            if (
                cache is not None
                and not consume
                and not transient
                and key not in cache
                and self._block_used + block.nbytes <= self._block_budget
            ):
                cache[key] = block
                self._block_used += block.nbytes
        return block

    def _read_frame_block(self, n_iter, frame):
        data = self.iter_data(n_iter)
        per_file = self._iter_index[n_iter]
        n = data["n_segs"]
        if len(per_file) == 1:
            # Single-file iteration (the common case): the h5 read IS the
            # concatenated block, in the file's own dtype
            dset = self._aux_dset(per_file[0][0], n_iter)
            if dset.shape[1] <= 4 and dset.nbytes <= (4 << 20):
                # Few stored frames (the lag-0 WE norm is 2) and a small
                # block: one contiguous full read + numpy slice beats HDF5's
                # strided single-frame hyperslab. For blocks of many MB the
                # strided read wins and skips the copy of the full-read
                # slice, so large iterations take the strided path.
                block = np.ascontiguousarray(
                    self._aux_full(per_file[0][0], n_iter)[:, frame]
                )
            else:
                block = dset[:, frame]
            if len(block) != n:
                # A loud failure for truncated/partial auxdata writes
                raise ValueError(
                    f"iteration {n_iter}: auxdata has {len(block)} segments "
                    f"but seg_index has {n} (truncated augmentation write?)"
                )
            return block
        # Read every file's block first so the output dtype promotes over
        # ALL of them (files written by different augmentation versions may
        # mix f32/f64; fixing the dtype from the first block would silently
        # truncate wider later blocks)
        blocks = [
            (file_idx, self._aux_dset(file_idx, n_iter)[:, frame])
            for file_idx, _n in per_file
        ]
        dtype = np.result_type(np.float32, *(b.dtype for _, b in blocks))
        out = np.full((n,) + blocks[0][1].shape[1:], np.nan, dtype=dtype)
        for file_idx, block in blocks:
            out[data["west_idx"] == file_idx] = block
        return out

    def iter_frame_subset(self, n_iter, rows, frame):
        """One frame's coordinates for a subset of segments (concatenated-
        order ``rows``).

        Small iterations are served by one whole-block read (hitting the
        block cache when present) plus a numpy gather: HDF5's point/fancy
        selection machinery has a fixed cost per call that exceeds the full
        contiguous read of a small WE iteration. LARGE uncached blocks with
        SPARSE rows take the row-selective read, which costs a few
        microseconds a row instead of the whole block's read. Dense row
        sets keep the whole-block read: HDF5 fancy selection of nearly all
        rows is far slower than the contiguous read of the same bytes."""
        data = self.iter_data(n_iter)
        rows = np.asarray(rows, dtype=np.int64)
        key = (n_iter, frame)
        with self._io_lock:
            cache = self._block_cache
            cached = cache is not None and key in cache
        if (
            cached
            or self._block_nbytes_estimate() <= 2 << 20
            or len(rows) * 16 >= data["n_segs"]
        ):
            # Fancy indexing copies, so mutating the result never reaches
            # the (shared) cached block; transient: don't pollute the block
            # cache with frame-0 blocks the featurizer never consumes
            return self._iter_frame_block(n_iter, frame, transient=True)[rows]
        n_atoms, coord_ndim = self.n_atoms_coord_ndim()
        # Read all per-file pieces first, then allocate at the dtype
        # promoted over them (floored at f32) -- the whole-block path
        # returns native-dtype arrays, and a silent np.full-default f64
        # upcast here would make the SAME call site flip dtype with cache
        # state (breaking e.g. the dedup featurizer's bitwise verify sample
        # on f32 datasets) and double the gather memory
        pieces = []
        for file_idx, _n in self._iter_index[n_iter]:
            in_file = np.flatnonzero(data["west_idx"][rows] == file_idx)
            if not len(in_file):
                continue
            local = data["seg_idx"][rows[in_file]]
            # h5py wants strictly increasing unique indices; rows may repeat
            # (split walkers share a parent)
            uniq, inverse = np.unique(local, return_inverse=True)
            dset = self._aux_dset(file_idx, n_iter)
            pieces.append((in_file, dset[uniq, frame], inverse))
        dtype = np.result_type(
            np.float32, *(b.dtype for _if, b, _inv in pieces)
        ) if pieces else np.float32
        out = np.full((len(rows), n_atoms, coord_ndim), np.nan, dtype=dtype)
        for in_file, block, inverse in pieces:
            out[in_file] = block[inverse]
        return out

    def check_continuity(self, sample_per_iter=8, full_iters=2, seed=0,
                         last_iter=None):
        """True iff segments' frame-0 coordinates are bit-identical to their
        parent's final frame (WE trajectory continuity).

        WESTPA propagators start each segment from the parent's final
        structure, so augmented coords normally satisfy this exactly; it can
        fail when the augmentation stores the child's first *saved* MD frame
        instead (one step past the restart point). All rows of the first
        ``full_iters`` usable iterations are checked, plus ``sample_per_iter``
        random rows of every other iteration. NaN patterns must match too.

        The check is *sampled* past the first iterations because an
        exhaustive check would read back exactly the frame-0 data the dedup
        exists to avoid reading. It therefore detects convention-level
        mismatches (a writer that never copies parent frames), not isolated
        row corruption -- callers needing per-row guarantees should disable
        dedup instead.

        The verdict is memoized per (file identity, parameters): repeated
        builds over unchanged files (restart marathons, validation splits)
        skip the re-verification. A rewritten file (new mtime/size) is
        re-checked.
        """
        try:
            # (realpath, inode, mtime_ns, size): an in-place same-size
            # rewrite inside one mtime tick can still alias (filesystem
            # timestamp granularity) -- callers mutating files they just
            # checked should reopen under a new Dataset or touch the file
            ident = tuple(
                (os.path.realpath(p),)
                + (lambda s: (s.st_ino, s.st_mtime_ns, s.st_size))(os.stat(p))
                for p in self.file_list
            )
            memo_key = (
                ident, self.pcoord_ndim, self.auxpath,
                sample_per_iter, full_iters, seed, last_iter,
            )
        except OSError:
            memo_key = None
        if memo_key is not None and memo_key in _continuity_memo:
            return _continuity_memo[memo_key]
        result = self._check_continuity_uncached(
            sample_per_iter, full_iters, seed, last_iter
        )
        if memo_key is not None:
            _continuity_memo[memo_key] = result
        return result

    def n_atoms_coord_ndim(self):
        """(n_atoms, coord_ndim) of the augmented coordinates (memoized:
        every subset read asks for it)."""
        if self._coord_shape is None:
            first = next(iter(self._iter_index))
            file_idx, _ = self._iter_index[first][0]
            shape = self._aux_dset(file_idx, first).shape
            self._coord_shape = (shape[2], shape[3])
        return self._coord_shape
